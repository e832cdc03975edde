"""
Fixtures and checks shared by the replay tests of the port's lockstep
runners over the fused entry points (tests/test_torch_chains_fused.py,
test_torch_chains_hmc.py, test_torch_chains_magi.py, test_torch_nuts.py).

Both packages work in float32, and the twins round otherwise than the
Pallas kernels (~1e-5 of a log-likelihood, tests/test_torch_grad.py), so
each chain's accept decisions must be the JAX package's, except at a step
whose log acceptance ratio lies within 1e-4 of its log-uniform (named, and
that lane compared up to it; the lanes are independent chains); for DALTON
within DALTON_MARGIN = 2.0, since its float32 value, a difference of two
filters' sums, resolves only ~0.1 here: over 256 thetas within 2 % of the
fenrir fixture's start the two packages' values (-177.6 to -171.9) differ
by up to 0.9375, and a log ratio holds two of them; their gradients by up
to 6.5, which moves a MALA proposal at step 0.005 by up to 0.5 x 0.005^2 x
6.5 = 8.1e-5 a step, so DALTON's positions agree within DALTON_POS_TOL =
5e-4 over its 4 steps.  Positions agree within POS_RTOL = 1e-5 relative,
log-densities within LL_RTOL = 1e-4 of the largest (DALTON_RTOL = 1e-3: a
difference of two filters' sums, as for its entry point).
"""
import math

import numpy as np
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.models import fitzhugh as jfitz
from rodeo_tpu.parallel import chains as jc
from rodeo_tpu_torch.models import fitzhugh as tfitz
from rodeo_tpu_torch.parallel import chains as tc

import mcmc_replay

POS_RTOL = 1e-5
LL_RTOL = 1e-4
DALTON_RTOL = 1e-3
DALTON_MARGIN = 2.0
DALTON_POS_TOL = 5e-4


def fitz_cfgs(n_steps, t_max):
    jcfg = jfitz.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(jcfg.pop("theta"))
    tcfg = tfitz.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float32,
                       device="cpu")
    tcfg.pop("theta")
    return jcfg, tcfg, theta


def scaled_close(port, ref, tol):
    """max |port - ref| <= tol x max |ref|."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max()


def check_lockstep(port, ref, init, margin_at, ll_rtol=LL_RTOL,
                   margin=mcmc_replay.MARGIN, pos_tol=POS_RTOL):
    """Decisions, positions, final log-densities and acceptance rates of
    the port's lockstep run against the JAX package's."""
    t_pos, t_ll, t_acc = port
    j_pos, j_ll, j_acc = ref
    t_np = jax.tree.map(lambda x: x.numpy(), t_pos)
    dec_t = mcmc_replay.moved(t_np, init)
    dec_j = mcmc_replay.moved(j_pos, init)
    counts = mcmc_replay.steps_to_compare(dec_t, dec_j, margin_at, margin)
    full = mcmc_replay.assert_positions_close(t_np, j_pos, counts, pos_tol)
    assert torch.isfinite(t_ll).all() and full.sum() >= len(full) // 2
    scaled_close(t_ll.numpy()[full], np.asarray(j_ll)[full], ll_rtol)
    np.testing.assert_allclose(t_acc.numpy()[full], np.asarray(j_acc)[full],
                               rtol=1e-6)
    assert dec_t.any()
    return dec_t


def fenrir_problem(n_lane):
    """tests/test_parallel_fused.py's fenrir MALA fixture: FitzHugh-Nagumo,
    50 steps to t = 2, 5 observations of rng(9) normals x 0.5, variance
    0.04, the chains started at theta x 1.2."""
    jcfg, tcfg, theta = fitz_cfgs(50, 2.0)
    n_obs = 5
    obs = dict(
        obs_data=(np.random.default_rng(9).normal(size=(n_obs, 2, 1))
                  * 0.5).astype(np.float32),
        obs_times=np.asarray(jnp.linspace(0.0, 2.0, n_obs)
                             .astype(jnp.float32)),
        obs_weight=np.zeros((n_obs, 2, 1, 3), np.float32),
        obs_var=np.full((n_obs, 2, 1, 1), 0.04, np.float32))
    obs["obs_weight"][..., 0] = 1.0
    init = np.broadcast_to(theta * 1.2, (n_lane, 3)).astype(np.float32)
    common = dict(t_min=0.0, t_max=2.0, n_steps=50)
    jkw = dict(ode_weight=jcfg["ode_weight"], ode_init=jcfg["ode_init"],
               prior_pars=jcfg["prior_pars"], ode_flat=jfitz.fitzhugh_flat,
               jac_flat=jfitz.fitzhugh_jac_flat, **common,
               **{k: jnp.asarray(v) for k, v in obs.items()})
    tkw = dict(ode_weight=tcfg["ode_weight"], ode_init=tcfg["ode_init"],
               prior_pars=tcfg["prior_pars"], model="fitzhugh",
               device="cpu", **common, **obs)
    return init, jkw, tkw


def magi_problem(seed, scale=1.0):
    """tests/test_parallel_fused.py's MAGI fixture: FitzHugh-Nagumo's
    prior at 32 steps to t = 2, 4 lanes of a rough path."""
    jcfg, tcfg, _ = fitz_cfgs(32, 2.0)
    rng = np.random.default_rng(seed)
    base = (rng.normal(size=(33, 2, 2)) * scale).astype(np.float32)
    subsets = np.stack([base + (0.05 * i * rng.normal(size=base.shape)
                                ).astype(np.float32) for i in range(4)])
    return jcfg, tcfg, subsets.astype(np.float32)


def jexpand(u, **p):
    return jnp.concatenate([u, jnp.zeros(u.shape[:-1] + (1,), u.dtype)],
                           axis=-1)


def texpand(u, **p):
    return torch.cat([u, torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype)],
                     dim=-1)


def jexpand_th(u, theta, **p):
    return jnp.concatenate([u[..., :1], theta * u[..., 1:2],
                            jnp.zeros_like(u[..., :1])], axis=-1)


def texpand_th(u, theta, **p):
    return torch.cat([u[..., :1], theta * u[..., 1:2],
                      torch.zeros_like(u[..., :1])], dim=-1)


def replay_fused(kind, likelihood, n_samp, step):
    """The port's MALA ("mala") or HMC ("hmc", 3 leapfrog steps) over the
    fenrir or DALTON likelihood of fenrir_problem, 8 lanes x ``n_samp``
    steps, against the JAX package's run from the same key."""
    n_lane = 8
    init, jkw, tkw = fenrir_problem(n_lane)
    key = jax.random.PRNGKey(1)
    extra = {"n_leapfrog": 3} if kind == "hmc" else {}
    j_fn = {"mala": jc.run_chains_mala_fused,
            "hmc": jc.run_chains_hmc_fused}[kind]
    t_fn = {"mala": tc.run_chains_mala_fused,
            "hmc": tc.run_chains_hmc_fused}[kind]
    ref = j_fn(jnp.asarray(init), key, n_samples=n_samp, step_size=step,
               likelihood=likelihood, **extra, **jkw)
    part = "xi" if kind == "mala" else "mom"
    noise = mcmc_replay.mala_or_hmc(key, n_samp, init, n_lane, part)
    port = t_fn(torch.from_numpy(init), None, n_samples=n_samp,
                step_size=step, likelihood=likelihood, noise=noise, **extra,
                **tkw)
    lpg = tc._fused_theta_logpost_grad(
        likelihood, n_lane, tkw["ode_weight"], tkw["ode_init"], 0.0, 2.0,
        50, tkw["prior_pars"], tkw["obs_data"], tkw["obs_times"],
        tkw["obs_weight"], tkw["obs_var"], "fitzhugh", None, "cpu")
    eps = tc._step_size(torch.from_numpy(init), step, torch.device("cpu"))

    def margin_at(s, lane):
        pos = port[0][s - 1] if s else torch.from_numpy(init)
        ll, g = lpg(pos)
        draw = torch.from_numpy(noise[part][s])
        ratio = (tc._mala_proposal(lpg, eps, pos, ll, g, draw) if kind ==
                 "mala" else tc._hmc_proposal(lpg, eps, 3, pos, ll, g,
                                              draw))[3]
        return abs(math.log(noise["u"][s][lane]) - float(ratio[lane]))

    if likelihood == "dalton":
        check_lockstep(port, ref, init, margin_at, DALTON_RTOL,
                       DALTON_MARGIN, DALTON_POS_TOL)
    else:
        check_lockstep(port, ref, init, margin_at)


