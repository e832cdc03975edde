"""
The twins of the single-solve filter K3 and of the smoother rows K2r
against the JAX package at the edges that the kernels' designs have to
mask, with the JAX package's Pallas kernels in interpret mode.

K2r streams its operands through a ring of shared-memory stages of a few
steps each (``csrc/stream_ring.cuh``), in CTAs of 32 columns: its last stage
holds fewer steps than the others when the step count is no multiple of the
stage's, and its last CTA fewer columns than 32 when the (block, lane)
columns are no multiple of 32.  So ``_smoother_batch_rows_plain`` is held
to ``_smoother_kernel_batch_rows`` at 1, 2, 5 and 9 interior steps over 3
blocks of 37 lanes (111 columns).  K3 runs one thread per block, the
threads meeting once a step; ``_filter_single_plain`` is held to
``_filter_kernel`` at 1 and 2 steps, Lorenz63 EK1 and FitzHugh-Nagumo EK0.
The card then runs the kernels at the same shapes against these twins
(``tests/test_torch_cuda.py``).  Both sides work in float32 and round
differently (XLA contracts and reorders), so arrays are held to SCALED_TOL
= 1e-4 of their largest entry, as in ``tests/test_torch_single.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import pallas_kalman as pk

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_kalman as fk

SCALED_TOL = 1e-4
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n_len", [1, 2, 5, 9])
def test_smoother_rows_twin_matches_pallas_at_ragged_shapes(n_len):
    """Seeded gains, 3 blocks x 37 lanes; n_len interior rows."""
    rng = np.random.default_rng(20 + n_len)
    q, nb, B = 3, 3, 37
    pairs, _ = fk._tri_idx(q)
    G = 0.3 * rng.standard_normal((n_len, q * q, nb, B))
    M = rng.standard_normal((n_len, nb, B, q, q))
    Lfull = M @ np.swapaxes(M, -1, -2)
    Mp = rng.standard_normal((nb, B, q, q))
    Pfull = Mp @ np.swapaxes(Mp, -1, -2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    args = [f32(a) for a in (
        rng.standard_normal((n_len, q, nb, B)), G,
        np.stack([Lfull[..., i, j] for i, j in pairs], axis=1),
        rng.standard_normal((q, nb, B)),
        np.stack([Pfull[..., i, j] for i, j in pairs]),
        rng.standard_normal((q, nb, B)))]
    m_scales = f32([0.5, 0.25, 0.125])
    p_scales = f32([m_scales[i] * m_scales[j] for i, j in pairs])
    mean_j, cov_j = pk.smoother_recursion_batch_rows(
        *map(jnp.asarray, args), 1, m_scales, p_scales, interpret=True)
    mean_t, cov_t = fk._smoother_batch_rows_plain(
        *map(torch.from_numpy, args), torch.from_numpy(m_scales),
        torch.from_numpy(p_scales))
    assert mean_t.shape == mean_j.shape == (n_len + 2, nb, q, B)
    assert cov_t.shape == cov_j.shape == (n_len + 2, nb, len(pairs), B)
    assert _scaled_err(mean_t, mean_j) <= SCALED_TOL
    assert _scaled_err(cov_t, cov_j) <= SCALED_TOL


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.02),
                                              ("fitzhugh", "rodeo", 0.1)])
def test_filter_single_twin_matches_pallas_at_few_steps(model, mode, t_max,
                                                        n_steps):
    """One solve at the model's theta perturbed by 1 %, 1 and 2 steps."""
    jmod = JMODELS[model]
    jcfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    rng = np.random.default_rng(30 + n_steps)
    theta = np.asarray(jcfg["theta"])
    theta = (theta * (1 + 0.01 * rng.standard_normal(3))).astype(np.float32)
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    ops, _ = fk._single_operands(torch.from_numpy(theta),
                                 tcfg["ode_weight"], tcfg["ode_init"], 0.0,
                                 t_max, n_steps, tcfg["prior_pars"])
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    run = jax.jit(lambda Qs, R, W, x0, th, tg, tv: pk.fused_filter(
        getattr(jmod, f"{model}_flat"), jac, n_steps, Qs, R, W, x0,
        th[:, None], tg, tv, raw_q_const=ops["q_const"], mode=mode,
        interpret=True))
    Qs = np.broadcast_to(np.asarray(ops["q_const"], np.float32),
                         (jmod.N_VARS, 3, 3))
    ref = run(Qs, *(np.asarray(ops[k]) for k in (
        "prior_var", "ode_weight", "x0", "theta", "tgrid", "t_vec")))
    port = fk._filter_single_plain(fk.resolve_model(model), n_steps, **ops,
                                   mode=mode)
    for name, a, b in zip(["mf", "pf", "mp", "pp"], port, ref):
        assert a.shape == b.shape == (n_steps, jmod.N_VARS, a.shape[-1]), name
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= SCALED_TOL, name
