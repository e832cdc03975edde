"""
Parity of the port's Gaussian likelihoods (rodeo_tpu_torch.inference.basic,
fenrir and dalton), their data-conditioned posteriors (fenrir.solve_mv,
dalton.solve_mv, solve_sim and solve_mv_nn) and the preconditioned wrappers
of rodeo_tpu_torch.ops.precond with the JAX package at float64 on the CPU.

Two fixtures: Lorenz63 EK1 (the 5e7 prior) at 200 steps to t = 2 with 7
observations of x, y and z (variance 0.005, data rng(0) x 5), through the
preconditioned wrappers, whose values and torch.autograd gradients are held
to the JAX package's and jax.grad's; and FitzHugh-Nagumo EK0 at 100 steps
to t = 10 with 11 observations of V and R (variance 0.04), through the
plain functions and the wrappers, the latter also in the dense layout
(indep_init, n_deriv).  Values within 1e-8 x |truth|, gradients within
1e-6 relative L2, smoothed moments within 1e-8 of each's largest entry.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodeo_tpu import interrogate as jinterrogate
from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.prior import indep_init as jindep_init

from rodeo_tpu_torch import inference as tinference
from rodeo_tpu_torch import interrogate as tinterrogate
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import precond as tprecond
from rodeo_tpu_torch.prior import indep_init as tindep_init

VALUE_RTOL = 1e-8
GRAD_RTOL = 1e-6
MOMENT_TOL = 1e-8

jfenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")
jdalton_mod = importlib.import_module("rodeo_tpu.inference.dalton")
jbasic_mod = importlib.import_module("rodeo_tpu.inference.basic")
tfenrir_mod = importlib.import_module("rodeo_tpu_torch.inference.fenrir")
tdalton_mod = importlib.import_module("rodeo_tpu_torch.inference.dalton")


def _grid_times(idx, t_max, n_steps):
    """Observation times on grid points, as the solver grid builds them."""
    return np.asarray(idx, np.float64) * (t_max * (1.0 / n_steps))


def _fixture(pkg, model, n_steps=None):
    """The solver configuration and Gaussian observation model of a fixture,
    for one package; FitzHugh-Nagumo at n_steps (a multiple of 10) where
    given."""
    if model == "lorenz":
        n_steps, t_max, n_obs, var, scale = 200, 2.0, 7, 0.005, 5.0
        idx = np.round(np.linspace(0, n_steps, n_obs)).astype(int)
        data = np.random.default_rng(0).normal(size=(n_obs, 3, 1)) * scale
        interrogate = "interrogate_kramer"
    else:
        n_steps, t_max, n_obs, var = n_steps or 100, 10.0, 11, 0.04
        idx = np.linspace(0, n_steps, n_obs).astype(int)
        data = np.random.default_rng(1).normal(size=(n_obs, 2, 1))
        interrogate = "interrogate_rodeo"
    nb = data.shape[1]
    weight = np.zeros((n_obs, nb, 1, 3))
    weight[..., 0] = 1.0
    obs = dict(obs_data=data, obs_times=_grid_times(idx, t_max, n_steps),
               obs_weight=weight, obs_var=np.full((n_obs, nb, 1, 1), var))
    if pkg == "jax":
        mod = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}[model]
        cfg = dict(mod.setup(n_steps=n_steps, t_max=t_max,
                             dtype=jnp.float64))
        obs = {k: jnp.asarray(v) for k, v in obs.items()}
        cfg["interrogate"] = getattr(jinterrogate, interrogate)
    else:
        mod = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}[model]
        cfg = dict(mod.setup(n_steps=n_steps, t_max=t_max,
                             dtype=torch.float64, device="cpu"))
        obs = {k: torch.tensor(v) for k, v in obs.items()}
        cfg["interrogate"] = getattr(tinterrogate, interrogate)
    return cfg, obs


def _basic_loglik(pkg):
    lib = jnp if pkg == "jax" else torch
    return lambda obs_data, ode_data, **p: lib.sum(
        -0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _gauss_loglik_i(pkg, var):
    lib = jnp if pkg == "jax" else torch
    return lambda o, s, i, **p: lib.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2
                                        / var)


def _likelihood(pkg, entry, name):
    """The function of a package's entry point (plain or preconditioned)
    for the likelihood name, taking theta and the fixture."""
    if pkg == "jax":
        plain = {"basic": jbasic_mod.basic, "fenrir": jfenrir_mod.fenrir,
                 "dalton": jdalton_mod.dalton}
        pc = jprecond
    else:
        plain = {"basic": tinference.basic, "fenrir": tinference.fenrir,
                 "dalton": tinference.dalton}
        pc = tprecond
    fn = plain[name] if entry == "plain" else getattr(pc, name)

    def value(theta, cfg, obs, **kwargs):
        if name == "basic":
            out = fn(key=None, theta=theta, obs_data=obs["obs_data"],
                     obs_times=obs["obs_times"],
                     obs_loglik=_basic_loglik(pkg), **cfg, **kwargs)
            return out[0]
        return fn(key=None, theta=theta, **obs, **cfg, **kwargs)

    return value


def _jax_value(entry, name, model):
    cfg, obs = _fixture("jax", model)
    theta = cfg.pop("theta")
    fn = _likelihood("jax", entry, name)
    return float(jax.jit(lambda th: fn(th, cfg, obs))(theta))


@pytest.mark.parametrize("name", ["basic", "fenrir", "dalton"])
@pytest.mark.parametrize("entry", ["plain", "precond"])
def test_likelihood_values_match_jax_on_fitzhugh(entry, name):
    cfg, obs = _fixture("torch", "fitzhugh")
    theta = cfg.pop("theta")
    val = float(_likelihood("torch", entry, name)(theta, cfg, obs))
    ref = _jax_value(entry, name, "fitzhugh")
    assert abs(val - ref) <= VALUE_RTOL * abs(ref)


@pytest.mark.parametrize("name", ["basic", "fenrir", "dalton"])
def test_precond_likelihoods_and_gradients_match_jax_on_lorenz(name):
    """The preconditioned wrappers on Lorenz63 EK1 (the plain recursion
    overflows on its prior): the value within 1e-8 x |truth| and
    torch.autograd's gradient in theta within 1e-6 relative L2 of
    jax.grad's, through the Python loops, the eigen-masked log-density's
    analytic backward and the closed-form solves."""
    cfg_j, obs_j = _fixture("jax", "lorenz")
    th_j = cfg_j.pop("theta")
    fn_j = _likelihood("jax", "precond", name)
    val_j, grad_j = jax.jit(jax.value_and_grad(
        lambda th: fn_j(th, cfg_j, obs_j)))(th_j)
    cfg_t, obs_t = _fixture("torch", "lorenz")
    th_t = cfg_t.pop("theta").clone().requires_grad_(True)
    val_t = _likelihood("torch", "precond", name)(th_t, cfg_t, obs_t)
    (grad_t,) = torch.autograd.grad(val_t, th_t)
    assert abs(val_t.item() - float(val_j)) <= VALUE_RTOL * abs(float(val_j))
    grad_j = np.asarray(grad_j)
    assert np.linalg.norm(grad_t.numpy() - grad_j) <= \
        GRAD_RTOL * np.linalg.norm(grad_j)


def _dense(pkg, cfg, obs):
    """The fixture in the dense layout: one block of n_vars x n_deriv
    states (indep_init), the weight and the observations on it."""
    nb, _, q = cfg["ode_weight"].shape
    fun = cfg["ode_fun"]
    weight = np.zeros((1, nb, nb * q))
    for b in range(nb):
        weight[0, b, b * q + 1] = 1.0
    n_obs = obs["obs_data"].shape[0]
    obs_weight = np.zeros((n_obs, 1, nb, nb * q))
    for b in range(nb):
        obs_weight[:, 0, b, b * q] = 1.0
    var = float(obs["obs_var"][0, 0, 0, 0])

    def ode_dense(X, t, **params):
        return fun(X.reshape(nb, q), t, **params)[:, 0][None]

    as_lib = jnp.asarray if pkg == "jax" else torch.tensor
    dense_cfg = dict(cfg, ode_fun=ode_dense, ode_weight=as_lib(weight),
                     ode_init=cfg["ode_init"].reshape(1, -1),
                     prior_pars=(jindep_init if pkg == "jax"
                                 else tindep_init)(cfg["prior_pars"]))
    dense_obs = dict(
        obs_data=obs["obs_data"].reshape(n_obs, 1, nb),
        obs_times=obs["obs_times"], obs_weight=as_lib(obs_weight),
        obs_var=as_lib(var * np.broadcast_to(np.eye(nb),
                                             (n_obs, 1, nb, nb)).copy()))
    return dense_cfg, dense_obs, q


@pytest.mark.parametrize("name", ["basic", "fenrir", "dalton"])
def test_precond_likelihoods_match_jax_in_the_dense_layout(name):
    """FitzHugh-Nagumo in the dense layout through the wrappers with
    n_deriv: the tiled Taylor scaling, and solves above five states (the
    Cholesky branch of solve_psd)."""
    vals = {}
    for pkg in ("jax", "torch"):
        cfg, obs = _fixture(pkg, "fitzhugh")
        theta = cfg.pop("theta")
        cfg, obs, q = _dense(pkg, cfg, obs)
        pc = jprecond if pkg == "jax" else tprecond
        lib = jnp if pkg == "jax" else torch

        def value(th):
            if name == "basic":
                return pc.basic(key=None, theta=th, obs_data=obs["obs_data"],
                                obs_times=obs["obs_times"], n_deriv=q,
                                obs_loglik=lambda o, d, **p: lib.sum(
                                    -0.5 * (o[:, 0] - d[:, 0, ::3]) ** 2),
                                **cfg)[0]
            return getattr(pc, name)(key=None, theta=th, n_deriv=q, **obs,
                                     **cfg)
        vals[pkg] = float(jax.jit(value)(theta) if pkg == "jax"
                          else value(theta))
    assert np.isfinite(vals["torch"])
    assert abs(vals["torch"] - vals["jax"]) <= VALUE_RTOL * abs(vals["jax"])


def test_dense_layout_needs_n_deriv_to_divide_the_state():
    cfg, obs = _fixture("torch", "fitzhugh")
    theta = cfg.pop("theta")
    cfg, obs, _ = _dense("torch", cfg, obs)
    with pytest.raises(ValueError):
        tprecond.fenrir(key=None, theta=theta, n_deriv=4, **obs, **cfg)


def _moments(pkg, entry, name, n_steps=None):
    """The smoothed moments of a posterior entry point on FitzHugh-Nagumo:
    fenrir's and DALTON's with the Gaussian data, DALTON's non-Gaussian
    solve_mv_nn with the same data as a Gaussian log-likelihood."""
    cfg, obs = _fixture(pkg, "fitzhugh", n_steps)
    if pkg == "jax":
        mods = {"fenrir": jfenrir_mod, "dalton": jdalton_mod}
        pc = jprecond
    else:
        mods = {"fenrir": tfenrir_mod, "dalton": tdalton_mod}
        pc = tprecond
    if name == "dalton_nn":
        kw = dict(obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                  obs_loglik_i=_gauss_loglik_i(pkg, 0.04))
        fn = (mods["dalton"].solve_mv_nn if entry == "plain"
              else pc.dalton_solve_mv_nn)
    else:
        kw = obs
        fn = (mods[name].solve_mv if entry == "plain"
              else getattr(pc, f"{name}_solve_mv"))
    def run():
        return fn(key=None, **kw, **cfg)
    mean, var = jax.jit(run)() if pkg == "jax" else run()
    return np.asarray(mean), np.asarray(var)


@pytest.mark.parametrize("name", ["fenrir", "dalton", "dalton_nn"])
@pytest.mark.parametrize("entry", ["plain", "precond"])
def test_posterior_moments_match_jax(entry, name):
    """fenrir.solve_mv, dalton.solve_mv and dalton.solve_mv_nn, and the
    wrappers fenrir_solve_mv, dalton_solve_mv and dalton_solve_mv_nn."""
    mean_t, var_t = _moments("torch", entry, name)
    mean_j, var_j = _moments("jax", entry, name)
    assert mean_t.shape == mean_j.shape and var_t.shape == var_j.shape
    for a, b in ((mean_t, mean_j), (var_t, var_j)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=MOMENT_TOL * np.abs(b).max())


N_DRAWS = 400
N_SIM = 40


@pytest.mark.parametrize("entry", ["plain", "precond"])
def test_dalton_solve_sim_draws_follow_the_jax_posterior(entry):
    """400 draws of DALTON's data-conditioned posterior on FitzHugh-Nagumo
    (EK0, 40 steps, the 11 observations every 4th step) against the JAX
    package's dalton.solve_mv: on the entries whose posterior variance
    exceeds 1e-8, the lane mean within 6 standard errors and the lane
    variance within 0.8-1.25 of the posterior's.  Each draw starts exactly
    at x0."""
    mean, var = _moments("jax", entry, "dalton", N_SIM)
    var = np.diagonal(var, axis1=-2, axis2=-1)
    cfg, obs = _fixture("torch", "fitzhugh", N_SIM)
    fn = tdalton_mod.solve_sim if entry == "plain" else \
        tprecond.dalton_solve_sim
    gen = torch.Generator().manual_seed(23)
    draws = torch.stack([fn(key=gen, **obs, **cfg)
                         for _ in range(N_DRAWS)]).numpy()
    assert np.isfinite(draws).all()
    assert np.array_equal(draws[:, 0], np.broadcast_to(
        cfg["ode_init"].numpy(), draws[:, 0].shape))
    live = var > 1e-8
    z = (draws.mean(0) - mean) / np.sqrt(var / N_DRAWS, where=live,
                                         out=np.ones_like(var))
    ratio = np.divide(draws.var(0, ddof=1), var, where=live,
                      out=np.ones_like(var))
    assert np.abs(z[live]).max() < 6.0
    assert 0.8 <= ratio[live].min() and ratio[live].max() <= 1.25


def test_dalton_solve_sim_takes_normals():
    """A tensor of normals draws what the generator that made them draws."""
    cfg, obs = _fixture("torch", "fitzhugh")
    z = torch.randn((100, 2, 3), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    a = tdalton_mod.solve_sim(key=z, **obs, **cfg)
    b = tdalton_mod.solve_sim(key=torch.Generator().manual_seed(4), **obs,
                              **cfg)
    assert torch.equal(a, b)


def _small():
    cfg, obs = _fixture("torch", "fitzhugh")
    cfg["n_steps"] = 4
    cfg["t_max"] = 0.4
    obs = dict(obs_data=obs["obs_data"][:2], obs_times=torch.tensor(
        [0.0, 0.4], dtype=torch.float64), obs_weight=obs["obs_weight"][:2],
               obs_var=obs["obs_var"][:2])
    return cfg, obs


@pytest.mark.parametrize("call", [
    "fenrir-sqrt", "dalton-sqrt", "basic-sqrt", "fenrir_solve_mv-sqrt",
    "dalton_solve_mv-sqrt", "fenrir-parallel", "basic-parallel",
    "fenrir_solve_mv-parallel", "fenrir_solve_mv_precond-parallel",
    "solve_mv_iterated"])
def test_options_that_wait_raise(call):
    """kalman_type="square-root", temporal="parallel" and
    solve_mv_iterated wait for kalmantv/square_root.py and ops/ptime.py."""
    cfg, obs = _small()
    name, _, option = call.partition("-")
    kw = ({"kalman_type": "square-root"} if option == "sqrt"
          else {"temporal": "parallel"} if option == "parallel" else {})
    fns = {"fenrir": tinference.fenrir, "dalton": tinference.dalton,
           "basic": tinference.basic,
           "fenrir_solve_mv": tfenrir_mod.solve_mv,
           "dalton_solve_mv": tdalton_mod.solve_mv,
           "fenrir_solve_mv_precond": tprecond.fenrir_solve_mv,
           "solve_mv_iterated": tprecond.solve_mv_iterated}
    if name == "basic":
        obs = dict(obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                   obs_loglik=_basic_loglik("torch"))
    if name == "solve_mv_iterated":
        obs = {}
    with pytest.raises(NotImplementedError):
        fns[name](key=None, **obs, **cfg, **kw)
