"""
DALTON's gradient at the instances that K11c took last, on the CPU: Hes1
and SEIRAH at q = 3 under kramer and rodeo and Chkrebtii's ODE at q = 4
and 5 (tests/coverage_value_cases.py's value cases, 40 steps x 4 lanes)
through ``dalton_fused_batch_grad`` (K11c's twin) against the JAX package's
``dalton_fused_batch_grad``, whose Pallas kernels run in interpret mode
(its Jacobian of Hes1 and SEIRAH by ``coverage_value_cases.jac_lanes``):
the values within DALTON_RTOL = 1e-3 relative (DALTON_Q5_TOL at q = 5) and
each parameter's gradient within GRAD_RTOL = 1e-3 of its largest entry,
the values bitwise ``dalton_fused_batch``'s and Chkrebtii's gradient
exactly zero (coverage_value_cases.check_dalton_case); and the lockstep
MALA runner over ``dalton_fused_batch_grad`` on Hes1 under kramer,
replaying the JAX package's noise.  tests/test_torch_coverage_dalton_fitz.py
holds FitzHugh-Nagumo at q = 4 and 5, tests/test_torch_coverage_dalton_
twins.py K11c's twin against torch.func.jvp.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import coverage_value_cases as cv
import fused_chains as fc
import mcmc_replay
from rodeo_tpu.models import hes1 as jhes1
from rodeo_tpu.parallel import chains as jc

from rodeo_tpu_torch.models import hes1 as thes1
from rodeo_tpu_torch.parallel import chains as tc

NAMES = sorted(n for n in cv.GRAD_CASES if cv.GRAD_CASES[n][0] != "fitzhugh")


@pytest.mark.parametrize("name", NAMES)
def test_dalton_gradient_matches_jax(name):
    """coverage_value_cases.check_dalton_case on Hes1 and SEIRAH, kramer
    and rodeo, and Chkrebtii's ODE at q = 4 and 5."""
    cv.check_dalton_case(name)


def test_mala_over_dalton_on_hes1_replays_jax():
    """The lockstep MALA runner over dalton_fused_batch_grad on Hes1 (K11c
    on the CPU's twin; EK1, its Jacobian on nested Duals), 8 lanes x 5
    steps from theta x (1 + 0.01 normals) at a step of 1e-4, against the
    JAX package's run_chains_mala_fused(likelihood="dalton") from the same
    key (its Jacobian jvp_jac_flat's, one jax.jvp per block on lane-wide
    seeds): the same accept decisions, positions and log-densities
    (tests/fused_chains.py's check_lockstep, its fenrir tolerances: Hes1's
    DALTON resolves to ~2e-6 relative in float32 here)."""
    c = cv.case("hes1_kramer")
    n_lane, n_samp, step = 8, 5, 1e-4
    theta = np.asarray(thes1.THETA, np.float32)
    init = (theta * (1 + 0.01 * np.random.default_rng(11).standard_normal(
        (n_lane, theta.shape[0])))).astype(np.float32)
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    common = dict(t_min=0.0, t_max=c["t_max"], n_steps=cv.N_STEPS)
    jkw = dict(ode_weight=jcfg["ode_weight"], ode_init=jcfg["ode_init"],
               prior_pars=jcfg["prior_pars"], ode_flat=jhes1.hes1_flat,
               jac_flat=cv.jac_lanes(jhes1.hes1_flat, 3, 3), **common,
               **{k: jnp.asarray(v) for k, v in c["obs"].items()})
    tkw = dict(ode_weight=tcfg["ode_weight"], ode_init=tcfg["ode_init"],
               prior_pars=tcfg["prior_pars"], model="hes1", device="cpu",
               **common, **c["obs"])
    key = jax.random.PRNGKey(3)
    ref = jc.run_chains_mala_fused(jnp.asarray(init), key,
                                   n_samples=n_samp, step_size=step,
                                   likelihood="dalton", **jkw)
    noise = mcmc_replay.mala_or_hmc(key, n_samp, init, n_lane, "xi")
    port = tc.run_chains_mala_fused(torch.from_numpy(init), None,
                                    n_samples=n_samp, step_size=step,
                                    likelihood="dalton", noise=noise, **tkw)
    lpg = tc._fused_theta_logpost_grad(
        "dalton", n_lane, tkw["ode_weight"], tkw["ode_init"], 0.0,
        c["t_max"], cv.N_STEPS, tkw["prior_pars"], tkw["obs_data"],
        tkw["obs_times"], tkw["obs_weight"], tkw["obs_var"], "hes1", None,
        "cpu")
    eps = tc._step_size(torch.from_numpy(init), step, torch.device("cpu"))

    def margin_at(s, lane):
        pos = port[0][s - 1] if s else torch.from_numpy(init)
        ll, g = lpg(pos)
        draw = torch.from_numpy(noise["xi"][s])
        ratio = tc._mala_proposal(lpg, eps, pos, ll, g, draw)[3]
        return abs(np.log(noise["u"][s][lane]) - float(ratio[lane]))

    fc.check_lockstep(port, ref, init, margin_at)
