"""
The twins of K7b, K7a and K8 at the instances they took last, on the CPU,
against the Pallas kernels they replace, in interpret mode: fenrir's
backward filters (``_fenrir_backward_plain`` with its skip, through
``fenrir_backward_batch``, and ``_fenrir_backward_single_plain``, through
``fenrir_backward_single``) on seeded chains at q = 4 and 5 with data at
some steps; DALTON's filter (``_dalton_filter_plain``, through
``dalton_filter_batch``) with and without data on the cases of
``tests/coverage_value_cases.py``: Chkrebtii's ODE under kramer at q = 4
and 5, Hes1 and SEIRAH under kramer (the Pallas kernel's Jacobian by
``jvp_jac_flat``, one lane) and rodeo, and FitzHugh-Nagumo at q = 4 and 5
under kramer and rodeo.  The log-densities are held to KERNEL_LD_RTOL =
1e-5 relative (tests/test_torch_likelihood.py), or, at q = 5 and on
FitzHugh-Nagumo at q = 4, to the JAX package's own float32 noise there.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import coverage_value_cases as cv
from rodeo_tpu.ops import pallas_dalton as pd
from rodeo_tpu.ops import pallas_fenrir as pf

from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk

KERNEL_LD_RTOL = 1e-5


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                        memory_space=pltpu.VMEM)


def _f32(a):
    return np.array(a, np.float32, order="C")


def _psd(rng, lead, q, scale=1.0):
    """Packed upper triangles of seeded PSD (q, q) matrices."""
    M = scale * rng.standard_normal(lead + (q, q))
    full = M @ np.swapaxes(M, -1, -2)
    pairs, _ = fk._tri_idx(q)
    return np.stack([full[..., i, j] for i, j in pairs], axis=-1)


def _grid(rng, n_steps, q, nb):
    """An observation grid of n_steps with data at every third step."""
    mask = (np.arange(n_steps) % 3 == 1).astype(np.float64)
    return dict(
        d=rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
        y=rng.standard_normal((n_steps, nb)) * mask[:, None],
        om=np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)), 1.0),
        mask=mask)


@pytest.mark.parametrize("q", [4, 5])
def test_fenrir_backward_twin_matches_pallas_at_q45(q):
    """K7b's twin against ``_fenrir_backward_kernel_batch`` on a seeded
    chain of 60 steps over 2 blocks x 4 lanes."""
    n_steps, nb, B = 60, 2, 4
    n_tri = q * (q + 1) // 2
    rng = np.random.default_rng(50 + q)
    ch = dict(
        A=np.eye(q).reshape(1, q * q, 1, 1) * 0.8
        + 0.1 * rng.standard_normal((n_steps, q * q, nb, B)),
        b=rng.standard_normal((n_steps, q, nb, B)),
        C=np.moveaxis(_psd(rng, (n_steps, nb, B), q, 0.3), -1, 1),
        **_grid(rng, n_steps, q, nb),
        m_seed=rng.standard_normal((q, nb, B)),
        p_seed=np.moveaxis(_psd(rng, (nb, B), q), -1, 0),
        ld0=rng.standard_normal(B))
    ch = {k: _f32(v) for k, v in ch.items()}
    kern = functools.partial(pf._fenrir_backward_kernel_batch, n_steps, q,
                             nb, n_tri, B, 1)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_steps, q * q, nb, B)), _vmem((n_steps, q, nb, B)),
                  _vmem((n_steps, n_tri, nb, B)), _vmem((n_steps, q, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1)), _vmem((q, nb, B)),
                  _vmem((n_tri, nb, B)), _vmem((1, B))],
        out_specs=_vmem((1, B)),
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32),
                        pltpu.VMEM((n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(ch["A"], ch["b"], ch["C"], ch["d"][..., None],
      ch["y"][:, None, :, None], ch["om"][:, None, :, None],
      ch["mask"][:, None], ch["m_seed"], ch["p_seed"], ch["ld0"][None])[0]
    port = ff.fenrir_backward_batch(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    assert port.shape == (B,)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               rtol=KERNEL_LD_RTOL)


@pytest.mark.parametrize("q", [4, 5])
def test_fenrir_backward_single_twin_matches_pallas_at_q45(q):
    """K7a's twin against ``_backward_kernel_global_mask`` on a seeded chain
    of 60 steps over 2 blocks, in the single layout."""
    n_steps, nb = 60, 2
    n_tri = q * (q + 1) // 2
    rng = np.random.default_rng(60 + q)
    grid = _grid(rng, n_steps, q, nb)
    ch = dict(
        A=np.eye(q).reshape(1, 1, q * q) * 0.8
        + 0.1 * rng.standard_normal((n_steps, nb, q * q)),
        b=rng.standard_normal((n_steps, nb, q)),
        C=_psd(rng, (n_steps, nb), q, 0.3), **grid,
        m_seed=rng.standard_normal((nb, q)), p_seed=_psd(rng, (nb,), q),
        ld0=rng.standard_normal(()))
    ch = {k: _f32(v) for k, v in ch.items()}
    kern = functools.partial(pf._backward_kernel_global_mask, n_steps, q, nb,
                             n_tri)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_steps, nb, q * q)), _vmem((n_steps, nb, q)),
                  _vmem((n_steps, nb, n_tri)), _vmem((n_steps, nb, q)),
                  _vmem((n_steps, nb, 1)), _vmem((n_steps, nb, 1)),
                  _vmem((n_steps, 1)), _vmem((nb, q)), _vmem((nb, n_tri)),
                  _vmem((1, 1))],
        out_specs=_vmem((1, 1)),
        scratch_shapes=[pltpu.VMEM((nb, q), jnp.float32),
                        pltpu.VMEM((nb, n_tri), jnp.float32),
                        pltpu.SMEM((1, 1), jnp.float32)],
        interpret=True,
    )(ch["A"], ch["b"], ch["C"], ch["d"].transpose(0, 2, 1),
      ch["y"][..., None], ch["om"][..., None], ch["mask"][:, None],
      ch["m_seed"], ch["p_seed"], ch["ld0"].reshape(1, 1))[0, 0]
    port = ff.fenrir_backward_single(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    np.testing.assert_allclose(float(port), float(ref), rtol=KERNEL_LD_RTOL)


def _dalton_pallas(c, ops, obs, ld0, with_obs, lanes):
    """``_dalton_filter_kernel`` on the K8 operands of ``lanes``."""
    q, nb, _ = ops["x0_lanes"].shape
    B = len(lanes)
    n_tri = q * (q + 1) // 2
    n_steps = ops["tgrid"].shape[0]
    pairs, _ = fk._tri_idx(q)
    kern = functools.partial(
        pd._dalton_filter_kernel, c["jflat"], c["jjac"], with_obs, n_steps,
        q, nb, n_tri, B, ops["q_const"], 1)
    n_theta = ops["theta_lanes"].shape[0]
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((nb, n_tri)), _vmem((nb, q)), _vmem((q, nb, B)),
                  _vmem((n_theta, B)), _vmem((n_steps, 1)), _vmem((1, q)),
                  _vmem((n_steps, q, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1)),
                  _vmem((1, B))],
        out_specs=_vmem((1, B)),
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32),
                        pltpu.VMEM((n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(fk._pack_tri(ops["prior_var"], pairs).numpy(),
      ops["ode_weight"].numpy(), ops["x0_lanes"][..., lanes].numpy(),
      ops["theta_lanes"][:, lanes].numpy(), ops["tgrid"].numpy()[:, None],
      ops["t_vec"].numpy()[None], obs["d"].numpy()[..., None],
      obs["y"].numpy()[:, None, :, None], obs["om"].numpy()[:, None, :, None],
      obs["mask"].numpy()[:, None], ld0[lanes].numpy()[None]))[0]


# K8's cases: the value cases, and FitzHugh-Nagumo at q = 4 and 5 (its
# weight and initial state padded with zeros past the third derivative)
# under kramer and rodeo
_K8_CASES = sorted(cv.CASES) + sorted(
    n for n in cv.GRAD_CASES if cv.GRAD_CASES[n][0] == "fitzhugh")


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("name", _K8_CASES)
def test_dalton_filter_twin_matches_pallas(name, with_obs):
    """K8's twin against ``_dalton_filter_kernel`` on the case's operands
    (its lanes and observation grid), with and without data, each launch's
    log-density on its own: over the case's lanes, or one lane where the
    Pallas kernel's Jacobian is ``jvp_jac_flat``'s.  At q = 5, and on
    FitzHugh-Nagumo at q = 4 (sums of ~6e7, 1.1e-5 apart under kramer),
    the filter's sum is held within 3 x the Pallas kernel's own move under
    a one-ulp step of x0 where that exceeds KERNEL_LD_RTOL."""
    c = cv.case(name)
    args, _, obs = cv.port_args(c)
    ops, grid, ld0 = fd._dalton_prepare(*args, *obs.values())
    if not with_obs:
        ld0 = torch.zeros_like(ld0)
    before = dict(fd.LAUNCHES)
    port = fd.dalton_filter_batch(c["model"], cv.N_STEPS, **ops, **grid,
                                  ld0=ld0, mode=c["mode"], with_obs=with_obs)
    assert fd.LAUNCHES == before            # the CPU takes the twin
    assert port.shape == (cv.N_LANE,) and torch.isfinite(port).all()
    lanes = [0] if c["per_lane"] else list(range(cv.N_LANE))
    ref = _dalton_pallas(c, ops, grid, ld0, with_obs, lanes)
    rtol = KERNEL_LD_RTOL
    if c["q"] == 5 or c["model"] == "fitzhugh":
        moved = dict(ops, x0_lanes=torch.from_numpy(np.nextafter(
            ops["x0_lanes"].numpy(), np.float32(np.inf))))
        noise = _dalton_pallas(c, moved, grid, ld0, with_obs, lanes)
        rtol = max(rtol, 3 * np.max(np.abs(noise - ref) / np.abs(ref)))
    np.testing.assert_allclose(port.numpy()[lanes], ref, rtol=rtol)
