"""
The pieces of non-Gaussian DALTON that the instances of K9 and K11d added
last rest on, on the CPU:

- K11d's twin (``_filter_nn_batch_tan_plain``, K9's twin on Duals, Hes1's
  and SEIRAH's Jacobian on nested Duals under kramer) at every new
  instance against ``torch.func.jvp`` of K9's twin along each parameter,
  in float64, over RULES_TOL_STEPS steps that hold a step with data, under
  Gaussian data and Poisson counts (every model but SEIRAH, whose
  populations make the Poisson rate infinite), within
  tests/test_torch_grad.py's RULES_TOL = 1e-10 of the largest entry of
  each stream and direction;
- the masked eigendecomposition at q = 4 and 5 (``torch.linalg.eigh``,
  as the JAX package's ``jnp.linalg.eigh``) against the JAX package's
  ``_masked_eigh`` in float64, on seeded covariances of full and deficient
  rank: the same kept directions, and the log-determinants over them
  within 1e-10.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import coverage_value_cases as cv
from rodeo_tpu.ops import pallas_daltonng as jd

from rodeo_tpu_torch.models import obs as obs_models
from rodeo_tpu_torch.ops import fused_daltonng as fdn
from rodeo_tpu_torch.ops import fused_kalman as fk

RULES_TOL = 1e-10
# the cases observe steps 10, 20, 30 and 40 (the mask of step n + 1 at row
# n), so 12 steps hold one step with data
RULES_TOL_STEPS = 12
NEW_NN = sorted(
    fk._INSTANCES["filter_nn_batch_tan"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))
CASES = [(functor, mode, q, obs) for functor, mode, q in NEW_NN
         for obs in ("gauss", "poisson")
         if obs == "gauss" or functor != "Seirah"]
_MODEL = {"Hes1": "hes1", "Seirah": "seirah", "Chkrebtii": "chkrebtii",
          "FitzHughNagumo": "fitzhugh"}


def _case_of(functor, mode, q):
    model = _MODEL[functor]
    if model == "chkrebtii":
        return f"chkrebtii_q{q}"
    if model == "fitzhugh":
        return f"fitzhugh_q{q}_{mode}"
    return f"{model}_{mode}"


@pytest.mark.parametrize("functor,mode,q,obs_name", CASES,
                         ids=["-".join(map(str, k)) for k in CASES])
def test_daltonng_tangent_twin_matches_torch_jvp(functor, mode, q, obs_name):
    """K11d's twin at each new instance, in float64 over RULES_TOL_STEPS
    steps of the case's operands (daltonng_fused_batch_grad's), under the
    case's Gaussian data or Poisson counts at its observation times: its
    values bitwise K9's twin's, and each direction's tangent of each
    stream against torch.func.jvp of K9's twin along that parameter,
    within RULES_TOL of its largest entry (the absolute error where the
    tangent is zero: Chkrebtii's ODE has no parameter)."""
    c = cv.case(_case_of(functor, mode, q))
    args, _, obs = cv.port_args(c)
    data = obs["obs_data"]
    if obs_name == "poisson":
        rng = np.random.default_rng(q)
        data = torch.tensor(rng.poisson(2.0, size=tuple(data.shape)),
                            dtype=torch.float32)
    obs_model = obs_models.gauss(cv.OBS_VAR) if obs_name == "gauss" \
        else obs_models.poisson(0.1, 0.05)
    ops, grid, _, _ = fdn._daltonng_prepare(*args, data, obs["obs_times"])
    n = RULES_TOL_STEPS
    f64 = {k: (v.double() if isinstance(v, torch.Tensor) else v)
           for k, v in ops.items()}
    f64["tgrid"] = f64["tgrid"][:n]
    cut = {k: v[:n].double() for k, v in grid.items()}
    assert (cut["mask"] != 0).any()
    fused = fk.resolve_model(c["model"])
    theta = f64.pop("theta_lanes")
    n_theta = theta.shape[0]
    aug = fdn._filter_nn_batch_tan_plain(fused, obs_model, (0,), n, **f64,
                                         theta_lanes=theta, **cut, mode=mode)

    def value(th):
        return fdn._filter_nn_batch_plain(fused, obs_model, (0,), n, **f64,
                                          theta_lanes=th, **cut, mode=mode)

    values = value(theta)
    n_tri = q * (q + 1) // 2
    for a, v, k in zip(aug, values, (q, n_tri, q, n_tri)):
        assert a.shape[1] == (1 + n_theta) * k
        assert torch.equal(a[:, :k], v)
    for j in range(n_theta):
        e = torch.zeros_like(theta)
        e[j] = 1.0
        _, tans = torch.func.jvp(value, (theta,), (e,))
        for s, (a, t, k) in enumerate(zip(aug, tans, (q, n_tri, q, n_tri))):
            part = a[:, (1 + j) * k:(2 + j) * k]
            assert torch.isfinite(part).all(), (s, j)
            assert cv.tan_err(part, t) <= RULES_TOL, (s, j)


def _packed_psd(q, seed):
    """Seeded float64 q x q covariances packed as (T, n_tri, 1, B), of rank
    q, q - 1 and 1 over scales 1e-3 to 1e4, and their dense form."""
    rng = np.random.default_rng(seed)
    mats = []
    for rank in (q, q - 1, 1):
        for scale in (1e-3, 1.0, 1e4):
            a = rng.standard_normal((8, q, rank)) * scale
            mats.append(a @ np.swapaxes(a, -1, -2))
    dense = np.concatenate(mats)                         # (72, q, q)
    pairs, _ = fk._tri_idx(q)
    packed = np.stack([dense[:, i, j] for i, j in pairs], -1)
    return np.ascontiguousarray(
        packed.reshape(9, 8, len(pairs)).transpose(0, 2, 1)[:, :, None, :])


@pytest.mark.parametrize("q", [4, 5])
def test_masked_eigh_at_q45_keeps_what_jax_keeps(q):
    """The masked eigendecomposition at q = 4 and 5 against the JAX
    package's (jnp.linalg.eigh, the same relative screen, no determinant
    refinement) in float64, on covariances of full rank, rank q - 1 (a
    smoothing covariance's structural null direction) and rank 1: the same
    kept directions, and the log-determinant over them within 1e-10."""
    C = _packed_psd(q, q)
    w_j, _, keep_j = jd._masked_eigh(jnp.asarray(C), q)
    w_t, v_t, keep_t = fdn._masked_eigh(torch.tensor(C))
    keep_j, w_j = np.asarray(keep_j), np.asarray(w_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert sorted(set(keep_j.sum(-1).ravel())) == [1, q - 1, q]
    ld_t = np.where(keep_j, np.log(np.where(keep_j, w_t.numpy(), 1.0)), 0.0)
    ld_j = np.where(keep_j, np.log(np.where(keep_j, w_j, 1.0)), 0.0)
    np.testing.assert_allclose(ld_t.sum(-1), ld_j.sum(-1), rtol=0,
                               atol=1e-10)
    # the eigenvectors reconstruct each matrix
    dense = fk.unpack_cov(torch.tensor(C).movedim(1, -1))
    rec = (v_t * w_t[..., None, :]) @ v_t.transpose(-1, -2)
    assert torch.allclose(rec, dense, rtol=0,
                          atol=1e-10 * dense.abs().max().item())


def test_masked_eigh_leaves_a_nonfinite_matrix_alone():
    """A matrix that is not finite (a lane that float32 lost) comes back NaN
    at q = 4 and 5 without failing the batch, as jnp.linalg.eigh returns
    it, and every other matrix as it would alone."""
    C = _packed_psd(4, 0)
    bad = C.copy()
    bad[0, :, 0, 0] = np.nan
    w, v, keep = fdn._masked_eigh(torch.tensor(bad))
    w0, v0, keep0 = fdn._masked_eigh(torch.tensor(C))
    assert torch.isnan(w[0, 0, 0]).all() and torch.isnan(v[0, 0, 0]).all()
    assert not keep[0, 0, 0].any()
    for a, b in ((w, w0), (v, v0), (keep, keep0)):
        assert torch.equal(a[0, 0, 1:], b[0, 0, 1:])
        assert torch.equal(a[1:], b[1:])
