"""
Parity of the port's single-solve fused path (rodeo_tpu_torch.ops:
``inv_small``, the filter K3, the smoothers over K4, ``solve_mv_fused``,
``fenrir_fused`` with K7a) and of the rows-emitting batch smoother K2r with
the JAX package, whose Pallas kernels run here in interpret mode.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels, so these tests pin the twins' algebra to the Pallas kernels; the
on-card comparison of kernel and twin is tests/test_torch_cuda.py (and
chip_smoke.py).  The JAX entry points run under ``jax.jit``, where they
take the transition coefficients from the raw prior, as the port does.
Both sides work in float32 and round differently (XLA contracts, reorders
and fuses; the port's dense products are PyTorch's): measured over these
runs, arrays differ by at most 2.4e-5 of their largest entry (the Lorenz63
solve at N = 200), so they are held to SCALED_TOL = 1e-4 of it, as in the
batch path's tests, and a log-likelihood to LOGLIK_RTOL = 1e-4 relative.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rodeo_tpu.ops.linalg as jlinalg
from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.models import chkrebtii as tchkrebtii
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops.linalg import inv_small

SCALED_TOL = 1e-4
LOGLIK_RTOL = 1e-4
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _reset_launches():
    for counts in (fk.LAUNCHES, ff.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def _no_launches():
    return not any(fk.LAUNCHES.values()) and not any(ff.LAUNCHES.values())


def _problem(model, n_steps, t_max, seed):
    """One solve from a seed: theta perturbed by 1%, as float32 numpy, and
    the JAX and port configurations."""
    jcfg = JMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=jnp.float32)
    theta = np.asarray(jcfg.pop("theta"))
    rng = np.random.default_rng(seed)
    theta = (theta * (1 + 0.01 * rng.standard_normal(3))).astype(np.float32)
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, theta


# --- inv_small ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_inv_small_matches_jax(n, dtype):
    """The closed forms in the same operations as the JAX package's; XLA
    and PyTorch may contract or order a product's terms differently, so
    entries agree to a few ulps of the largest: 1e-5 of it in float32,
    1e-12 in float64."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((7, n, n))
    a = (M @ np.swapaxes(M, -1, -2) + np.eye(n)) * 10.0 ** rng.integers(
        -3, 4, (7, 1, 1))
    a = a.astype(dtype)
    ref = np.asarray(jlinalg.inv_small(jnp.asarray(a)))
    port = inv_small(torch.from_numpy(a)).numpy()
    assert port.dtype == dtype
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for b in range(7):
        assert _scaled_err(port[b], ref[b]) <= tol, b
    np.testing.assert_allclose(port @ a, np.broadcast_to(np.eye(n), a.shape),
                               atol=1e-3 if dtype == np.float32 else 1e-9)


# --- K3: the single-solve filter ------------------------------------------------------


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 1.2),
                                              ("fitzhugh", "rodeo", 6.0)])
def test_filter_single_twin_matches_pallas(model, mode, t_max):
    n_steps = 60
    jcfg, tcfg, theta = _problem(model, n_steps, t_max, seed=0)
    ops, _ = fk._single_operands(torch.from_numpy(theta),
                                 tcfg["ode_weight"], tcfg["ode_init"], 0.0,
                                 t_max, n_steps, tcfg["prior_pars"])
    jmod = JMODELS[model]
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    run = jax.jit(lambda Qs, R, W, x0, th, tg, tv: pk.fused_filter(
        getattr(jmod, f"{model}_flat"), jac, n_steps, Qs, R, W, x0, th[:, None],
        tg, tv, raw_q_const=ops["q_const"], mode=mode))
    Qs = np.broadcast_to(np.asarray(ops["q_const"], np.float32),
                         (jmod.N_VARS, 3, 3))
    ref = run(Qs, *(np.asarray(ops[k]) for k in (
        "prior_var", "ode_weight", "x0", "theta", "tgrid", "t_vec")))
    _reset_launches()
    port = fk.fused_filter(model, n_steps, **ops, mode=mode)
    assert _no_launches()
    for name, a, b in zip(["mf", "pf", "mp", "pp"], port, ref):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= SCALED_TOL, name


# --- K4: the smoothers ---------------------------------------------------------------


def _filter_states(n_len, nb, seed):
    """Seeded filter states that a filter could give: filtered covariances
    M M' + 0.1 I, predictions through the scaled Pascal transition with a
    PSD noise, means drawn freely.  Returns numpy float32 (q_const, Qs, Rs,
    mf, pf, mp, pp, mfN, pfN)."""
    rng = np.random.default_rng(seed)
    q = 3
    pairs, _ = fk._tri_idx(q)
    Q = np.array([[1.0, 2.0, 1.0], [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]])
    q_const = [[float(v) for v in row] for row in Q]
    Mr = rng.standard_normal((nb, q, q))
    R = 0.5 * Mr @ np.swapaxes(Mr, -1, -2) + 0.1 * np.eye(q)
    M = 0.5 * rng.standard_normal((n_len + 1, nb, q, q))
    Pf = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(q)
    Pp = Q @ Pf[:-1] @ Q.T + R
    mf = rng.standard_normal((n_len + 1, nb, q))
    mp = mf[:-1] @ Q.T + 0.1 * rng.standard_normal((n_len, nb, q))

    def pack(P):
        return np.stack([P[..., i, j] for i, j in pairs], axis=-1)

    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return (q_const, f32(np.broadcast_to(Q, (nb, q, q))), f32(R),
            f32(mf[:-1]), f32(pack(Pf[:-1])), f32(mp), f32(pack(Pp)),
            f32(mf[-1]), f32(pack(Pf[-1])))


def test_fused_smoother_matches_pallas():
    q_const, Qs, Rs, *states = _filter_states(120, 3, seed=1)
    ms_j, ps_j = pk.fused_smoother(120, Qs, Rs, *map(jnp.asarray, states))
    _reset_launches()
    ms_t, ps_t = fk.fused_smoother(torch.from_numpy(Qs),
                                   torch.from_numpy(Rs),
                                   *map(torch.from_numpy, states))
    assert _no_launches()
    assert ms_t.shape == ms_j.shape and ps_t.shape == ps_j.shape
    assert _scaled_err(ms_t, ms_j) <= SCALED_TOL
    assert _scaled_err(ps_t, ps_j) <= SCALED_TOL


@pytest.mark.parametrize("k,n_len", [
    (4, 50),      # 13 groups, 2 identity rows in front
    (4, 250),     # 63 groups, rounded up to 64: 6 in front
    (16, 300),    # 19 groups, rounded up to 24: 84 in front
])
def test_fused_smoother_composed_matches_pallas(k, n_len):
    """The grouping, the padding and so the rows at which the composed
    smoother rounds are the JAX package's."""
    q_const, Qs, Rs, *states = _filter_states(n_len, 3, seed=2)
    n_groups, pad = fk._composed_groups(n_len, k)
    assert n_groups * k == n_len + pad and (n_groups < 16
                                            or n_groups % 8 == 0)
    run = jax.jit(lambda Q, *a: pk.fused_smoother_composed(
        n_len, Q, jnp.asarray(Rs), *a, raw_q_const=q_const, k_compose=k))
    ms_j, ps_j = run(Qs, *states)
    _reset_launches()
    ms_t, ps_t = fk.fused_smoother_composed(
        q_const, torch.from_numpy(Rs), *map(torch.from_numpy, states),
        k_compose=k)
    assert _no_launches()
    assert ms_t.shape == ms_j.shape and ps_t.shape == ps_j.shape
    assert _scaled_err(ms_t, ms_j) <= SCALED_TOL
    assert _scaled_err(ps_t, ps_j) <= SCALED_TOL
    # composition is exact in exact arithmetic: the plain smoother agrees
    ms_p, ps_p = fk.fused_smoother(torch.from_numpy(Qs),
                                   torch.from_numpy(Rs),
                                   *map(torch.from_numpy, states))
    assert _scaled_err(ms_t, ms_p) <= SCALED_TOL
    assert _scaled_err(ps_t, ps_p) <= SCALED_TOL


# --- solve_mv_fused and fenrir_fused end to end ----------------------------------------


@pytest.mark.parametrize("model,mode,n_steps,t_max", [
    ("lorenz", "kramer", 200, 2.0),       # the plain smoother
    ("fitzhugh", "rodeo", 200, 10.0),
    ("lorenz", "kramer", 520, 1.04),      # the composed smoother
])
def test_solve_mv_fused_matches_jax(model, mode, n_steps, t_max):
    """Each smoother on both sides: the plain recursion below 512 steps,
    and from there the 16-step composition, which is the JAX package's
    default and an option of the port's."""
    jcfg, tcfg, theta = _problem(model, n_steps, t_max, seed=3)
    jmod = JMODELS[model]
    k_compose = 16 if n_steps >= 512 else 1
    fn = jax.jit(lambda th: pk.solve_mv_fused(
        key=None, theta=th, ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat"), interrogation=mode,
        k_compose=k_compose, **jcfg))
    mean_j, var_j = fn(jnp.asarray(theta))
    _reset_launches()
    mean_t, var_t = fk.solve_mv_fused(
        torch.from_numpy(theta), tcfg["ode_weight"], tcfg["ode_init"], 0.0,
        t_max, n_steps, tcfg["prior_pars"], model=model, interrogation=mode,
        k_compose=k_compose, device="cpu")
    assert _no_launches()
    assert mean_t.shape == mean_j.shape and var_t.shape == var_j.shape
    assert torch.isfinite(mean_t).all() and torch.isfinite(var_t).all()
    for d in range(3):
        assert _scaled_err(mean_t[..., d], mean_j[..., d]) <= SCALED_TOL, d
        assert _scaled_err(var_t[..., d, :], var_j[..., d, :]) \
            <= SCALED_TOL, d


def test_solve_mv_fused_defaults_to_the_plain_smoother():
    """The port's default is the plain recursion at any length (the JAX
    package composes from 512 steps on); k_compose > 1 composes."""
    n_steps, t_max = 520, 1.04
    _, tcfg, theta = _problem("lorenz", n_steps, t_max, seed=3)
    args = (torch.from_numpy(theta), tcfg["ode_weight"], tcfg["ode_init"],
            0.0, t_max, n_steps, tcfg["prior_pars"])
    default = fk.solve_mv_fused(*args, model="lorenz", device="cpu")
    plain = fk.solve_mv_fused(*args, model="lorenz", k_compose=1,
                              device="cpu")
    composed = fk.solve_mv_fused(*args, model="lorenz", k_compose=16,
                                 device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(default, plain))
    assert not torch.equal(default[0], composed[0])
    assert _scaled_err(composed[0], default[0]) <= SCALED_TOL


def _fenrir_obs(model, t_max, n_obs, seed):
    nb = JMODELS[model].N_VARS
    rng = np.random.default_rng(seed)
    weight = np.zeros((n_obs, nb, 1, 3), np.float32)
    weight[..., 0] = 1.0
    return dict(
        obs_data=(rng.standard_normal((n_obs, nb, 1)) * 5).astype(np.float32),
        obs_times=np.linspace(0.0, t_max, n_obs),
        obs_weight=weight,
        obs_var=np.full((n_obs, nb, 1, 1), 0.005, np.float32))


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", [
    ("lorenz", "kramer", 200, 2.0, 21), ("fitzhugh", "rodeo", 100, 10.0, 11)])
def test_fenrir_fused_matches_jax(model, mode, n_steps, t_max, n_obs):
    """Against the JAX package's fenrir_fused, and against the port's own
    1-lane fenrir_fused_batch, which takes another filter (K1), builds the
    chain in column arithmetic and its transition from the raw prior: the
    two paths round differently, within LOGLIK_RTOL."""
    jcfg, tcfg, theta = _problem(model, n_steps, t_max, seed=4)
    jmod = JMODELS[model]
    obs = _fenrir_obs(model, t_max, n_obs, seed=5)
    fn = jax.jit(lambda th: pf.fenrir_fused(
        key=None, interrogate=None, theta=th,
        ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat"), interrogation=mode,
        **{k: jnp.asarray(v) for k, v in obs.items()}, **jcfg))
    ref = float(fn(jnp.asarray(theta)))
    args = dict(ode_weight=tcfg["ode_weight"], t_min=0.0, t_max=t_max,
                n_steps=n_steps, prior_pars=tcfg["prior_pars"], model=model,
                interrogation=mode, device="cpu",
                **{k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()})
    _reset_launches()
    ll = ff.fenrir_fused(torch.from_numpy(theta),
                         ode_init=tcfg["ode_init"], **args)
    assert _no_launches()
    assert ll.shape == () and torch.isfinite(ll)
    assert abs(float(ll) - ref) <= LOGLIK_RTOL * abs(ref)
    lane = ff.fenrir_fused_batch(torch.from_numpy(theta)[None],
                                 ode_inits=tcfg["ode_init"][None], **args)
    assert abs(float(ll) - float(lane[0])) <= LOGLIK_RTOL * abs(ref)


def test_fenrir_backward_single_twin_matches_pallas():
    """K7a's twin against the Pallas kernel on the chain, grid and seed
    that fenrir_fused builds (Lorenz63 EK1): one kernel's log-density sum,
    the blocks added in another order (the TPU kernel adds the blocks of
    each step first), within 1e-5 relative."""
    n_steps, t_max = 80, 0.8
    _, tcfg, theta = _problem("lorenz", n_steps, t_max, seed=6)
    obs = _fenrir_obs("lorenz", t_max, 9, seed=7)
    ops, Qs = fk._single_operands(torch.from_numpy(theta),
                                  tcfg["ode_weight"], tcfg["ode_init"], 0.0,
                                  t_max, n_steps, tcfg["prior_pars"])
    ops["q_const"] = ff._const_coefs(Qs)
    A, b, C, d, y, om, mask, m_seed, p_seed, ld0 = ff._fenrir_single_operands(
        fk.resolve_model("lorenz"), n_steps, 0.0, t_max, ops, Qs,
        *(torch.from_numpy(np.asarray(v)) for v in obs.values()), "kramer")
    nb, q, n_tri = 3, 3, 6
    kern = functools.partial(pf._backward_kernel_global_mask, n_steps, q, nb,
                             n_tri)

    def vmem(shape):
        return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                            memory_space=pltpu.VMEM)

    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        grid=(1,),
        in_specs=[vmem((n_steps, nb, q * q)), vmem((n_steps, nb, q)),
                  vmem((n_steps, nb, n_tri)), vmem((n_steps, nb, q)),
                  vmem((n_steps, nb, 1)), vmem((n_steps, nb, 1)),
                  vmem((n_steps, 1)), vmem((nb, q)), vmem((nb, n_tri)),
                  vmem((1, 1))],
        out_specs=vmem((1, 1)),
        scratch_shapes=[pltpu.VMEM((nb, q), jnp.float32),
                        pltpu.VMEM((nb, n_tri), jnp.float32),
                        pltpu.SMEM((1, 1), jnp.float32)],
        interpret=True,
    )(A.numpy(), b.numpy(), C.numpy(), d.numpy().transpose(0, 2, 1),
      y.numpy()[..., None], om.numpy()[..., None], mask.numpy()[:, None],
      m_seed.numpy(), p_seed.numpy(), ld0.numpy().reshape(1, 1))[0, 0]
    assert mask.sum() > 0
    port = ff.fenrir_backward_single(A, b, C, d, y, om, mask, m_seed, p_seed,
                                     ld0)
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-5)


@pytest.mark.parametrize("override", [
    {"interrogation": "bogus"}, {"model": "heat"}, "q"])
@pytest.mark.parametrize("entry", ["solve_mv_fused", "fenrir_fused"])
def test_single_entries_raise_for_unported(entry, override):
    """An interrogation no filter takes, a model without a CUDA functor,
    and a q that the entry's kernels do not hold: Chkrebtii's ODE at q = 6
    (K3 and K7a hold it at q = 4 and 5)."""
    cfg = tlorenz.setup(n_steps=8, t_max=0.1, device="cpu")
    args = dict(theta=cfg["theta"], ode_weight=cfg["ode_weight"],
                ode_init=cfg["ode_init"], t_min=0.0, t_max=0.1, n_steps=8,
                prior_pars=cfg["prior_pars"], model="lorenz", device="cpu")
    if entry == "fenrir_fused":
        args.update({k: torch.from_numpy(np.asarray(v)) for k, v in
                     _fenrir_obs("lorenz", 0.1, 3, seed=0).items()})
    if override == "q":
        q = 6
        ccfg = tchkrebtii.setup(n_steps=8, t_max=0.1, device="cpu",
                                n_deriv=q)
        override = dict(theta=torch.zeros(1), ode_weight=ccfg["ode_weight"],
                        ode_init=ccfg["ode_init"],
                        prior_pars=ccfg["prior_pars"], model="chkrebtii")
        if entry == "fenrir_fused":
            override.update(obs_weight=torch.zeros((3, 1, 1, q)),
                            obs_data=torch.zeros((3, 1, 1)),
                            obs_var=torch.ones((3, 1, 1, 1)))
    with pytest.raises(NotImplementedError):
        getattr(rt, entry)(**{**args, **override})


# --- the square-root form of the single entries -------------------------------------
#
# The prior's variance (and fenrir's observation variance) given as a factor
# is squared once at entry; solve_mv_fused returns lower Cholesky factors of
# its covariances, which square back to the standard form's within
# SQRT_GRAM_TOL of the largest entry (1.4e-7 measured in float32).
SQRT_GRAM_TOL = 1e-5


def _factor(v):
    """A float32 lower factor of each (q, q) covariance, from float64."""
    return np.linalg.cholesky(np.asarray(v, np.float64)).astype(np.float32)


@pytest.mark.parametrize("model,mode,n_steps,t_max", [
    ("lorenz", "kramer", 200, 2.0), ("fitzhugh", "rodeo", 200, 10.0)])
def test_solve_mv_fused_sqrt_matches_the_jax_package(model, mode, n_steps,
                                                     t_max):
    """solve_mv_fused(kalman_type="sqrt") on the CPU: the standard form's
    means on the squared factor, bitwise, and lower factors whose Grams are
    its covariances within SQRT_GRAM_TOL; against the JAX package's
    square-root solve on the same float32 factor (Pallas in interpret
    mode), means and Grams within SCALED_TOL."""
    jcfg, tcfg, theta = _problem(model, n_steps, t_max, seed=3)
    jmod = JMODELS[model]
    w, v = (np.array(a, np.float32) for a in jcfg.pop("prior_pars"))
    factor = _factor(v)
    fn = jax.jit(lambda th: pk.solve_mv_fused(
        key=None, theta=th, ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat"), interrogation=mode,
        kalman_type="square-root",
        prior_pars=(jnp.asarray(w), jnp.asarray(factor)), **jcfg))
    mean_j, fac_j = fn(jnp.asarray(theta))
    args = (torch.from_numpy(theta), tcfg["ode_weight"], tcfg["ode_init"],
            0.0, t_max, n_steps)
    pars_q = (torch.from_numpy(w), torch.from_numpy(factor))
    _reset_launches()
    mean_q, fac_q = fk.solve_mv_fused(*args, pars_q, model=model,
                                      interrogation=mode, kalman_type="sqrt",
                                      device="cpu")
    mean_s, var_s = fk.solve_mv_fused(
        *args, fk.normalize_prior_pars("sqrt", pars_q), model=model,
        interrogation=mode, device="cpu")
    assert _no_launches()
    assert torch.equal(mean_q, mean_s)
    assert fac_q.shape == var_s.shape == fac_j.shape
    assert torch.equal(fac_q.triu(1), torch.zeros_like(fac_q))
    gram = fac_q @ fac_q.mT
    assert (gram - var_s).abs().max() <= SQRT_GRAM_TOL * var_s.abs().max()
    gram_j = np.asarray(fac_j @ jnp.swapaxes(fac_j, -1, -2))
    for d in range(3):
        assert _scaled_err(mean_q[..., d], mean_j[..., d]) <= SCALED_TOL, d
        assert _scaled_err(gram[..., d, :], gram_j[..., d, :]) \
            <= SCALED_TOL, d


def test_fenrir_fused_sqrt_is_the_standard_form():
    """fenrir_fused with the prior's and the observations' variances given
    as factors is the standard form's value on the squared factors,
    bitwise."""
    _, tcfg, theta = _problem("lorenz", 200, 2.0, seed=4)
    obs = {k: torch.from_numpy(np.asarray(v)) for k, v in
           _fenrir_obs("lorenz", 2.0, 21, seed=5).items()}
    w, v = tcfg["prior_pars"]
    pars_q = (w, torch.from_numpy(_factor(v)))
    om_q = obs.pop("obs_var").sqrt()
    args = dict(ode_weight=tcfg["ode_weight"], ode_init=tcfg["ode_init"],
                t_min=0.0, t_max=2.0, n_steps=200, model="lorenz",
                device="cpu", **obs)
    ll_q = ff.fenrir_fused(torch.from_numpy(theta), prior_pars=pars_q,
                           obs_var=om_q, kalman_type="sqrt", **args)
    ll_s = ff.fenrir_fused(torch.from_numpy(theta),
                           prior_pars=fk.normalize_prior_pars("sqrt", pars_q),
                           obs_var=fk.normalize_meas_var("sqrt", om_q),
                           **args)
    assert torch.isfinite(ll_q) and torch.equal(ll_q, ll_s)


# --- K2r: the rows-emitting batch smoother -----------------------------------------------


def test_smoother_batch_rows_twin_matches_pallas():
    rng = np.random.default_rng(8)
    T, q, nb, B = 40, 3, 3, 4
    pairs, _ = fk._tri_idx(q)
    G = 0.3 * rng.standard_normal((T, q * q, nb, B))
    M = rng.standard_normal((T, nb, B, q, q))
    Lfull = M @ np.swapaxes(M, -1, -2)
    L = np.stack([Lfull[..., i, j] for i, j in pairs], axis=1)
    Mp = rng.standard_normal((nb, B, q, q))
    Pfull = Mp @ np.swapaxes(Mp, -1, -2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    args = [f32(a) for a in (
        rng.standard_normal((T, q, nb, B)), G, L,
        rng.standard_normal((q, nb, B)),
        np.stack([Pfull[..., i, j] for i, j in pairs]),
        rng.standard_normal((q, nb, B)))]
    m_scales = f32([0.5, 0.25, 0.125])
    p_scales = f32([m_scales[i] * m_scales[j] for i, j in pairs])
    mean_j, cov_j = pk.smoother_recursion_batch_rows(
        *map(jnp.asarray, args), 1, m_scales, p_scales)
    _reset_launches()
    mean_t, cov_t = fk.smoother_recursion_batch_rows(
        *map(torch.from_numpy, args), torch.from_numpy(m_scales),
        torch.from_numpy(p_scales))
    assert _no_launches()
    assert mean_t.shape == mean_j.shape == (T + 2, nb, q, B)
    assert cov_t.shape == cov_j.shape == (T + 2, nb, len(pairs), B)
    assert _scaled_err(mean_t, mean_j) <= SCALED_TOL
    assert _scaled_err(cov_t, cov_j) <= SCALED_TOL
    # the boundary rows are exact
    assert torch.equal(mean_t[0], torch.from_numpy(
        args[5] * m_scales[:, None, None]).permute(1, 0, 2))
    assert (cov_t[0] == 0).all()


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 2.0),
                                              ("fitzhugh", "rodeo", 10.0)])
def test_smoother_batch_rows_equals_the_solves_rows(model, mode, t_max):
    """solve_mv_fused_batch's rows, which K2r writes, are bitwise the bare
    recursion over K1's gains (the JAX package's K2) with the boundary rows
    and the scales put on in torch, as the JAX package assembles them: the
    synthetic boundary elements are exact, and the scale products the
    same float32 products."""
    n_steps, B = 60, 3
    cfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                               dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(9)
    thetas = cfg["theta"] * (1 + 0.01 * torch.tensor(
        rng.standard_normal((B, 3)), dtype=torch.float32))
    inits = cfg["ode_init"].expand(B, *cfg["ode_init"].shape).contiguous()
    mean, var = fk.solve_mv_fused_batch(
        thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
        cfg["prior_pars"], model=model, interrogation=mode, device="cpu")
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    G, g, L, mN, pN = fk.fused_filter_batch(model, n_steps, **ops,
                                            mode=mode)
    ms, ps = fk._smoother_batch_plain(g[1:], G[1:], L[1:], mN, pN)
    t_vec = ops["t_vec"]
    pairs, _ = fk._tri_idx(3)
    mean_rows = torch.cat([ops["x0_lanes"][None], ms, mN[None]]) \
        * t_vec[:, None, None]
    cov_rows = torch.cat([torch.zeros_like(ps[:1]), ps, pN[None]]) \
        * torch.stack([t_vec[i] * t_vec[j] for i, j in pairs])[:, None, None]
    assert torch.equal(mean, mean_rows.permute(0, 2, 1, 3))
    assert torch.equal(var, cov_rows.permute(0, 2, 1, 3))
