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
from rodeo_tpu.ops import linalg as jlin
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import precond as jprecond

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import linalg as lin

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
    """The JAX package's bare recursion (its K2) against the rows between
    the boundary rows of the port's K2r twin, at unit scales."""
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
    mean_t, cov_t = fk.smoother_recursion_batch_rows(
        *map(torch.from_numpy, args), torch.zeros((q, nb, B)),
        torch.ones(q), torch.ones(n_tri))
    ms_t = mean_t[1:-1].permute(0, 2, 1, 3)
    ps_t = cov_t[1:-1].permute(0, 2, 1, 3)
    assert ms_t.shape == ms_j.shape and ps_t.shape == ps_j.shape
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
    fk.LAUNCHES.update(dict.fromkeys(fk.LAUNCHES, 0))
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    mean_t, var_t = fk.solve_mv_fused_batch(
        torch.from_numpy(thetas), tcfg["ode_weight"],
        torch.from_numpy(inits.copy()), 0.0, t_max, n_steps,
        tcfg["prior_pars"], model=model, interrogation=mode, device="cpu")
    # the CPU path runs the plain twins and launches no kernel
    assert fk.LAUNCHES == dict.fromkeys(fk.LAUNCHES, 0)
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
    cfg = tlorenz.setup(n_steps=8, t_max=0.1, device="cpu")
    B = 2
    return dict(thetas=cfg["theta"].expand(B, 3).contiguous(),
                ode_weight=cfg["ode_weight"],
                ode_inits=cfg["ode_init"].expand(B, 3, 3).contiguous(),
                t_min=0.0, t_max=0.1, n_steps=8,
                prior_pars=cfg["prior_pars"], model="lorenz", device="cpu")


def _q6(cfg):
    """The solve's arguments at q = 6, which no kernel holds."""
    prior = tuple(torch.eye(6, dtype=p.dtype).expand(3, 6, 6).contiguous()
                  for p in cfg["prior_pars"])
    W = torch.zeros((3, 1, 6), dtype=cfg["ode_weight"].dtype)
    W[:, :, 1] = 1.0
    inits = torch.zeros((cfg["ode_inits"].shape[0], 3, 6),
                        dtype=cfg["ode_inits"].dtype)
    return dict(ode_weight=W, ode_inits=inits, prior_pars=prior)


@pytest.mark.parametrize("override", [
    {"interrogation": "bogus"}, {"model": "heat"}, "q6", {"model": fk}])
def test_fused_solve_raises_for_unported(small_lorenz, override):
    """An interrogation no filter takes, a model without a CUDA functor, a
    q no kernel holds, a module that is no model."""
    if override == "q6":
        override = _q6(small_lorenz)
    with pytest.raises(NotImplementedError):
        fk.solve_mv_fused_batch(**{**small_lorenz, **override})


# --- the square-root form -------------------------------------------------------
#
# A square-root caller passes the prior's variance (and a Gaussian
# observation variance) as a factor; the fused entries square it once at
# entry and run the standard form's kernels, so a likelihood, gradient or
# draw is bitwise the standard form's on the squared factor, and a solve
# returns lower Cholesky factors of its covariances.  The float32 Gram of a
# factor reproduces the covariance it factors within SQRT_GRAM_TOL of the
# largest entry (1.4e-7 measured).
SQRT_GRAM_TOL = 1e-5


def _factor(v):
    """A float32 lower factor of each (q, q) covariance, from float64."""
    return torch.from_numpy(np.linalg.cholesky(
        np.asarray(v, np.float64)).astype(np.float32))


def _spd_packed(rng, shape, q, rank=None):
    """Packed symmetric positive (semi-)definite matrices M M' of
    ``shape``, float64, M of ``rank`` columns (q by default), scales spread
    over 1e-6 .. 1e3 as the solve's covariances are."""
    pairs, _ = fk._tri_idx(q)
    M = rng.standard_normal(shape + (q, rank or q))
    M = M * np.logspace(-3, 1.5, q)[:, None]
    full = M @ np.swapaxes(M, -1, -2)
    return np.stack([full[..., i, j] for i, j in pairs], axis=-1), full


@pytest.mark.parametrize("rank", [3, 2, 1])
def test_cholesky_helpers_are_the_jax_packages(rank):
    """The port's chol_packed, unpack_chol and chol_small against the JAX
    package's, float64, on seeded covariances of full rank and rank-
    deficient ones (the floored pivots and the zeros below them), in the
    trailing and the lanes-last (axis=-2) packed layouts, and an all-zero
    covariance."""
    rng = np.random.default_rng(20 + rank)
    packed, full = _spd_packed(rng, (7, 2), 3, rank)
    t_packed = torch.from_numpy(packed)
    port = fk.chol_packed(t_packed, 3)
    ref = pk.chol_packed(jnp.asarray(packed), 3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12 * np.abs(packed).max())
    dense = fk.unpack_chol(port)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(pk.unpack_chol(jnp.asarray(port.numpy()))))
    assert torch.equal(dense.triu(1), torch.zeros_like(dense))
    lanes = fk.chol_packed(t_packed.movedim(0, -1), 3, axis=-2)
    np.testing.assert_allclose(lanes.movedim(-1, 0).numpy(), port.numpy(),
                               rtol=1e-14, atol=1e-14 * np.abs(packed).max())
    small = lin.chol_small(torch.from_numpy(full))
    small_ref = jlin.chol_small(jnp.asarray(full))
    np.testing.assert_allclose(small.numpy(), np.asarray(small_ref),
                               rtol=1e-12, atol=1e-12 * np.abs(full).max())
    if rank == 3:
        gram = small @ small.mT
        np.testing.assert_allclose(gram.numpy(), full, rtol=1e-10,
                                   atol=1e-10 * np.abs(full).max())
    zero = fk.chol_packed(torch.zeros(6, dtype=torch.float64), 3)
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=1e-12)


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 1.0),
                                              ("fitzhugh", "rodeo", 5.0)])
def test_sqrt_batch_solve_matches_the_jax_package(model, mode, t_max):
    """solve_mv_fused_batch(kalman_type="sqrt") on the CPU: the same means
    as the standard form on the squared factor, bitwise, packed lower
    factors whose Grams are that form's covariances within SQRT_GRAM_TOL;
    and, against the JAX package's square-root batched solve on the same
    float32 factor (its Pallas kernels in interpret mode), means and Grams
    within SCALED_TOL."""
    n_steps, B = 128, 3
    jmod, tmod = JMODELS[model], TMODELS[model]
    cfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(cfg.pop("theta"))
    thetas = np.stack([theta * (1.0 + 0.01 * i) for i in range(B)]
                      ).astype(np.float32)
    inits = np.broadcast_to(np.asarray(cfg["ode_init"]),
                            (B,) + cfg["ode_init"].shape).astype(np.float32)
    w, v = (np.array(a, np.float32) for a in cfg["prior_pars"])
    factor = _factor(v)
    mean_j, fac_j = pk.solve_mv_fused_batch(
        thetas=jnp.asarray(thetas), ode_weight=cfg["ode_weight"],
        ode_inits=jnp.asarray(inits), t_min=0.0, t_max=t_max,
        n_steps=n_steps, prior_pars=(jnp.asarray(w),
                                     jnp.asarray(factor.numpy())),
        ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat"), interrogation=mode,
        kalman_type="square-root", interpret=True)
    tcfg = tmod.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float32,
                      device="cpu")
    args = (torch.from_numpy(thetas), tcfg["ode_weight"],
            torch.from_numpy(inits.copy()), 0.0, t_max, n_steps)
    w_t = torch.from_numpy(w)
    mean_q, fac_q = fk.solve_mv_fused_batch(
        *args, (w_t, factor), model=model, interrogation=mode,
        kalman_type="sqrt", device="cpu")
    mean_s, var_s = fk.solve_mv_fused_batch(
        *args, fk.normalize_prior_pars("sqrt", (w_t, factor)), model=model,
        interrogation=mode, device="cpu")
    assert torch.equal(mean_q, mean_s)
    assert fac_q.shape == var_s.shape == fac_j.shape
    for b in range(B):
        L = fk.unpack_chol(fac_q[..., b])
        gram = L @ L.mT
        cov = fk.unpack_cov(var_s[..., b])
        assert (gram - cov).abs().max() <= SQRT_GRAM_TOL * cov.abs().max(), b
        L_j = pk.unpack_chol(fac_j[..., b])
        gram_j = np.asarray(L_j @ jnp.swapaxes(L_j, -1, -2))
        assert _scaled_err(gram, gram_j) <= SCALED_TOL, b
    for d in range(3):
        assert _scaled_err(mean_q[..., d, :], mean_j[..., d, :]) \
            <= SCALED_TOL, d


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


def _sqrt_entry_calls():
    """Each batched likelihood, gradient and draw entry on Lorenz63 EK1 (40
    steps to t = 0.4, 2 lanes, x, y and z observed at 5 grid times), as
    ``call(prior_pars, obs_var, **kw)`` with the variances given in the
    form ``kw`` names."""
    from rodeo_tpu_torch.models import obs as tobs
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    from rodeo_tpu_torch.ops import fused_fenrir as ff
    from rodeo_tpu_torch.ops import fused_sim as fs
    n_steps, t_max, B, n_obs = 40, 0.4, 2, 5
    cfg = tlorenz.setup(n_steps=n_steps, t_max=t_max, device="cpu")
    rng = np.random.default_rng(30)
    lanes = dict(thetas=cfg["theta"] * torch.tensor([[1.0], [1.01]]),
                 ode_weight=cfg["ode_weight"],
                 ode_inits=cfg["ode_init"].expand(B, 3, 3).contiguous(),
                 t_min=0.0, t_max=t_max, n_steps=n_steps, model="lorenz")
    obs_data = torch.tensor(rng.normal(size=(n_obs, 3, 1)),
                            dtype=torch.float32)
    obs_times = torch.tensor([0.0, 0.1, 0.2, 0.3, 0.35])
    weight = torch.zeros(n_obs, 3, 1, 3)
    weight[..., 0] = 1.0
    gauss = dict(obs_data=obs_data, obs_times=obs_times, obs_weight=weight)
    basic = dict(obs_data=obs_data, obs_times=obs_times,
                 obs_loglik=lambda o, x: torch.sum(-0.5 * (o[..., 0]
                                                           - x[..., 0]) ** 2))
    eps = dict(eps=torch.tensor(rng.standard_normal((n_steps - 1, 3, 3, B)),
                                dtype=torch.float32),
               eps_term=torch.tensor(rng.standard_normal((3, 3, B)),
                                     dtype=torch.float32))
    ng = dict(obs_data=obs_data, obs_times=obs_times,
              obs_model=tobs.gauss(0.005), obs_dims=(0,))
    on_cpu = dict(lanes, device="cpu")
    return cfg["prior_pars"], {
        "basic": lambda p, v, **kw: fk.basic_fused_batch(
            **on_cpu, prior_pars=p, **basic, **kw),
        "basic_grad": lambda p, v, **kw: fk.basic_fused_batch_grad(
            **on_cpu, prior_pars=p, **basic, **kw),
        "solve_grad": lambda p, v, **kw: fk.solve_mv_fused_batch_grad(
            **on_cpu, prior_pars=p, **kw),
        "fenrir": lambda p, v, **kw: ff.fenrir_fused_batch(
            **on_cpu, prior_pars=p, **gauss, obs_var=v, **kw),
        "fenrir_grad": lambda p, v, **kw: ff.fenrir_fused_batch_grad(
            **on_cpu, prior_pars=p, **gauss, obs_var=v, **kw),
        "dalton": lambda p, v, **kw: fd.dalton_fused_batch(
            **on_cpu, prior_pars=p, **gauss, obs_var=v, **kw),
        "dalton_grad": lambda p, v, **kw: fd.dalton_fused_batch_grad(
            **on_cpu, prior_pars=p, **gauss, obs_var=v, **kw),
        "sim": lambda p, v, **kw: fs.solve_sim_fused_batch(
            **on_cpu, prior_pars=p, **eps, **kw),
        "daltonng": lambda p, v, **kw: fdn.daltonng_fused_batch(
            **on_cpu, prior_pars=p, **ng, **kw),
        "daltonng_grad": lambda p, v, **kw: fdn.daltonng_fused_batch_grad(
            **on_cpu, prior_pars=p, **ng, **kw),
    }


@pytest.mark.parametrize("entry", ["basic", "basic_grad", "solve_grad",
                                   "fenrir", "fenrir_grad", "dalton",
                                   "dalton_grad", "sim", "daltonng",
                                   "daltonng_grad"])
def test_sqrt_form_is_the_standard_form_on_squared_variances(entry):
    """Every batched likelihood, gradient and draw entry in the square-root
    form (the prior's variance, and fenrir's and DALTON's observation
    variance, given as factors) returns the standard form's values on the
    squared factors bitwise: the factors are squared once at entry, and the
    same operations run (the draws from the same normals).  Non-Gaussian
    DALTON's observation model keeps its own variance in both forms."""
    (w, v), calls = _sqrt_entry_calls()
    factor = _factor(v)
    om_factor = torch.full((5, 3, 1, 1), 0.1)
    sq = calls[entry]((w, factor), om_factor, kalman_type="sqrt")
    std = calls[entry](fk.normalize_prior_pars("sqrt", (w, factor)),
                       fk.normalize_meas_var("sqrt", om_factor))
    sq, std = (o if isinstance(o, tuple) else (o,) for o in (sq, std))
    assert len(sq) == len(std)
    for a, b in zip(sq, std):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)

