"""
Parity of the fused solve's port (rodeo_tpu_torch.ops.fused_kalman) with
the JAX package's Pallas path, which runs here in interpret mode.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels, so these tests pin the twins' algebra to the Pallas kernels; the
on-card comparison of kernel and twin is tests/test_torch_cuda.py (and
chip_smoke.py).  Both sides work in float32 and round differently (XLA
contracts and reorders some operations), measured at ~1e-5 of the largest
entry of each output over these runs: the tolerance is 1e-4 of it.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import precond as jprecond

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_kalman as fk

SCALED_TOL = 1e-4
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _filter_inputs(model, n_steps, t_max, n_lane, seed):
    """Scaled kernel inputs from a seed, as numpy, in the kernels' layout."""
    jmod = JMODELS[model]
    rng = np.random.default_rng(seed)
    cfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float64)
    nb, q = jmod.N_VARS, 3
    dt = t_max / n_steps
    tv = np.asarray(jprecond.taylor_scale(dt, q, dtype=jnp.float32))
    _, Rs = jprecond.scale_prior(cfg["prior_pars"], jnp.asarray(tv))
    x0 = np.asarray(cfg["ode_init"]) / tv                    # (nb, q)
    x0 = x0.T[:, :, None] * (1 + 0.01 * rng.standard_normal((q, nb, n_lane)))
    theta = np.asarray(cfg["theta"])[:, None] * (
        1 + 0.01 * rng.standard_normal((3, n_lane)))
    return dict(
        q_const=pk._static_scaled_qconst(cfg["prior_pars"][0], dt, q),
        Rs=np.asarray(Rs), W=np.asarray(cfg["ode_weight"][:, 0, :] * tv),
        tv=tv, x0=x0.astype(np.float32), theta=theta.astype(np.float32),
        tgrid=t_max * (np.arange(n_steps) + 1) / n_steps)


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("model,mode", [("lorenz", "kramer"),
                                        ("fitzhugh", "rodeo")])
def test_filter_twin_matches_pallas(model, mode):
    n_steps, nb = 120, JMODELS[model].N_VARS
    inp = _filter_inputs(model, n_steps, 1.2, 4, seed=0)
    jmod = JMODELS[model]
    ref = pk.fused_filter_batch(
        getattr(jmod, f"{model}_flat"),
        getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None,
        n_steps,
        # a prior_weight holding exactly q_const makes the kernel take the
        # same transition coefficients as the port
        jnp.broadcast_to(jnp.asarray(inp["q_const"]), (nb, 3, 3)),
        jnp.asarray(inp["Rs"]), jnp.asarray(inp["W"]),
        jnp.asarray(inp["x0"]), jnp.asarray(inp["theta"]),
        jnp.asarray(inp["tgrid"]), jnp.asarray(inp["tv"]), mode=mode,
        emit="gains", fold=1)
    port = fk.fused_filter_batch(
        model, n_steps, inp["q_const"], _f32(inp["Rs"]), _f32(inp["W"]),
        _f32(inp["tv"]), _f32(inp["x0"]), _f32(inp["theta"]),
        _f32(inp["tgrid"]), mode=mode)
    for name, a, b in zip(["G", "g", "L", "m_last", "p_last"], port, ref):
        assert a.shape == b.shape, name
        assert _scaled_err(a, b) <= SCALED_TOL, name


def test_smoother_twin_matches_pallas():
    rng = np.random.default_rng(1)
    T, q, nb, B = 60, 3, 3, 4
    n_tri = 6
    G = 0.3 * rng.standard_normal((T, q * q, nb, B))
    g = rng.standard_normal((T, q, nb, B))
    A = rng.standard_normal((T, nb, B, q, q))
    Lfull = A @ np.swapaxes(A, -1, -2)
    pairs, _ = fk._tri_idx(q)
    L = np.stack([Lfull[..., i, j] for i, j in pairs], axis=1)
    mN = rng.standard_normal((q, nb, B))
    pN = np.abs(rng.standard_normal((n_tri, nb, B)))
    args = [np.ascontiguousarray(a, dtype=np.float32)
            for a in (g, G, L, mN, pN)]
    ms_j, ps_j = pk.smoother_recursion_batch(*map(jnp.asarray, args))
    ms_t, ps_t = fk.smoother_recursion_batch(*map(torch.from_numpy, args))
    assert _scaled_err(ms_t, ms_j) <= SCALED_TOL
    assert _scaled_err(ps_t, ps_j) <= SCALED_TOL


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 2.0),
                                              ("fitzhugh", "rodeo", 10.0)])
def test_solve_mv_fused_batch_matches_jax(model, mode, t_max):
    """The whole slice on 4 lanes at N=200.  The JAX entry runs under jit,
    where it takes the transition coefficients from the raw prior, as the
    port always does."""
    n_steps, B = 200, 4
    jmod = JMODELS[model]
    cfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(cfg.pop("theta"))
    rng = np.random.default_rng(2)
    thetas = (theta[None] * (1 + 0.01 * rng.standard_normal((B, 3)))
              ).astype(np.float32)
    inits = np.broadcast_to(np.asarray(cfg["ode_init"]),
                            (B,) + cfg["ode_init"].shape).astype(np.float32)
    fn = jax.jit(lambda ts, x0: pk.solve_mv_fused_batch(
        thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0, t_min=0.0,
        t_max=t_max, n_steps=n_steps, prior_pars=cfg["prior_pars"],
        ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat"), interrogation=mode))
    mean_j, var_j = fn(jnp.asarray(thetas), jnp.asarray(inits))
    fk.LAUNCHES.update(filter_batch=0, smoother_batch=0)
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32)
    mean_t, var_t = fk.solve_mv_fused_batch(
        torch.from_numpy(thetas), tcfg["ode_weight"],
        torch.from_numpy(inits.copy()), 0.0, t_max, n_steps,
        tcfg["prior_pars"], model=model, interrogation=mode)
    # the CPU path runs the plain twins and launches no kernel
    assert fk.LAUNCHES == {"filter_batch": 0, "smoother_batch": 0}
    assert mean_t.shape == mean_j.shape and var_t.shape == var_j.shape
    assert torch.isfinite(mean_t).all() and torch.isfinite(var_t).all()
    for d in range(3):
        assert _scaled_err(mean_t[..., d, :], mean_j[..., d, :]) \
            <= SCALED_TOL, d
    assert _scaled_err(var_t, var_j) <= SCALED_TOL
    # a lane of the packed covariance expands to the dense matrix
    np.testing.assert_array_equal(
        fk.unpack_cov(var_t[5, 0, :, 0]).numpy(),
        np.asarray(pk.unpack_cov(jnp.asarray(var_t[5, 0, :, 0].numpy()))))


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
def test_sym_inv_matches_jax(q):
    rng = np.random.default_rng(q)
    A = rng.standard_normal((q, q, 7))
    P = np.einsum("ijb,kjb->ikb", A, A) + np.eye(q)[..., None]
    pairs, _ = fk._tri_idx(q)
    cols = [P[i, j].astype(np.float32) for i, j in pairs]
    ref = pk._sym_inv(q, [jnp.asarray(c) for c in cols])
    port = fk._sym_inv(q, [torch.from_numpy(c) for c in cols])
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


def test_static_scaled_qconst_is_the_jax_numbers():
    for n_steps, t_max in ((200, 2.0), (10000, 20.0), (800, 10.0), (7, 3.0)):
        cfg = jlorenz.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
        dt = t_max / n_steps
        ref = pk._static_scaled_qconst(cfg["prior_pars"][0], dt, 3)
        port = fk._static_scaled_qconst(
            torch.tensor(np.asarray(cfg["prior_pars"][0])), dt, 3)
        assert port == ref


@pytest.fixture
def small_lorenz():
    cfg = tlorenz.setup(n_steps=8, t_max=0.1)
    B = 2
    return dict(thetas=cfg["theta"].expand(B, 3).contiguous(),
                ode_weight=cfg["ode_weight"],
                ode_inits=cfg["ode_init"].expand(B, 3, 3).contiguous(),
                t_min=0.0, t_max=0.1, n_steps=8,
                prior_pars=cfg["prior_pars"], model="lorenz")


@pytest.mark.parametrize("override", [
    {"interrogation": "schober"}, {"interrogation": "chkrebtii"},
    {"kalman_type": "sqrt"}, {"model": "hes1"}, {"model": fk}])
def test_fused_solve_raises_for_unported(small_lorenz, override):
    with pytest.raises(NotImplementedError):
        fk.solve_mv_fused_batch(**{**small_lorenz, **override})


def test_fused_wrappers_check_their_operands():
    inp = _filter_inputs("lorenz", 8, 0.1, 2, seed=3)
    args = [inp["q_const"], _f32(inp["Rs"]), _f32(inp["W"]),
            _f32(inp["tv"]), _f32(inp["x0"]), _f32(inp["theta"]),
            _f32(inp["tgrid"])]
    fk.fused_filter_batch("lorenz", 8, *args)
    bad_dtype = list(args)
    bad_dtype[4] = bad_dtype[4].double()
    with pytest.raises(TypeError):
        fk.fused_filter_batch("lorenz", 8, *bad_dtype)
    with pytest.raises(ValueError):            # tgrid shorter than n_steps
        fk.fused_filter_batch("lorenz", 9, *args)
    bad_layout = list(args)
    bad_layout[5] = bad_layout[5].T.contiguous().T   # non-contiguous theta
    with pytest.raises(ValueError):
        fk.fused_filter_batch("lorenz", 8, *bad_layout)
