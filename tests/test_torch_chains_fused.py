"""
The port's lockstep random walk over posterior draws (make_chain_runner:
the twins of K1 and K6) and MALA over fenrir (K11a, K11b) and DALTON
(K11c) (rodeo_tpu_torch.parallel.chains) against the JAX package's runners
on the CPU, whose Pallas kernels run in interpret mode.  Each port run
replays the JAX run's own draws (tests/mcmc_replay.py rebuilds its key
tree); the tolerances are tests/fused_chains.py's.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.models import fitzhugh as jfitz
from rodeo_tpu.parallel import chains as jc
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_sim as fs
from rodeo_tpu_torch.parallel import chains as tc

import fused_chains as fc
import mcmc_replay

def _replay_chain_runner(interrogation):
    """FitzHugh-Nagumo, 20 steps to t = 2, 16 lanes x 4 random-walk steps,
    the log-likelihood of each drawn path against a fixed mean path, the
    estimates under ``interrogation``."""
    n_steps, t_max, n_lane, n_samp, scale = 20, 2.0, 16, 4, 0.02
    jcfg, tcfg, theta = fc.fitz_cfgs(n_steps, t_max)
    mu_ref, _ = fk.solve_mv_fused_batch(
        torch.from_numpy(theta)[None], tcfg["ode_weight"],
        tcfg["ode_init"][None], 0.0, t_max, n_steps, tcfg["prior_pars"],
        model="fitzhugh", device="cpu")
    mu_np = mu_ref[..., 0, 0].numpy()                     # (N+1, n_block)

    def jloglik(positions, paths):
        resid = paths[:, :, 0, :] - mu_np[:, :, None]
        return -0.5 * jnp.sum(resid * resid, axis=(0, 1)) / 0.01

    def tloglik(positions, paths):
        resid = paths[:, :, 0, :] - torch.from_numpy(mu_np)[:, :, None]
        return -0.5 * torch.sum(resid * resid, dim=(0, 1)) / 0.01

    init = np.broadcast_to(theta, (n_lane, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    j_run = jc.make_chain_runner(
        jloglik, n_lane=n_lane, n_samples=n_samp, rw_scale=scale,
        ode_weight=jcfg["ode_weight"], ode_init=jcfg["ode_init"],
        t_min=0.0, t_max=t_max, n_steps=n_steps,
        prior_pars=jcfg["prior_pars"], ode_flat=jfitz.fitzhugh_flat,
        jac_flat=jfitz.fitzhugh_jac_flat, interrogation=interrogation)
    ref = j_run(jnp.asarray(init), key)
    noise = mcmc_replay.chain_runner(key, n_samp, n_lane, 3, n_steps, 3, 2,
                                     interrogation=interrogation)
    kw = dict(loglik_fn=tloglik, n_lane=n_lane, rw_scale=scale,
              ode_weight=tcfg["ode_weight"], ode_init=tcfg["ode_init"],
              t_min=0.0, t_max=t_max, n_steps=n_steps,
              prior_pars=tcfg["prior_pars"], model="fitzhugh",
              interrogation=interrogation, device="cpu")
    fk.LAUNCHES["filter_batch"] = fs.LAUNCHES["sampler_batch"] = 0
    port = tc.make_chain_runner(n_samples=n_samp, **kw)(
        torch.from_numpy(init), noise=noise)
    # the CPU takes the twins: no kernel is launched
    assert fk.LAUNCHES["filter_batch"] == fs.LAUNCHES["sampler_batch"] == 0
    per_step = ("prop", "eps", "eps_term", "u", "eps_int")

    def margin_at(s, lane):
        pos_s, ll_s, _ = tc.make_chain_runner(n_samples=s, **kw)(
            torch.from_numpy(init), noise={
                k: (v[:s] if k in per_step else v)
                for k, v in noise.items()})
        prev = pos_s[-1] if s else torch.from_numpy(init)
        prop = prev + scale * torch.from_numpy(noise["prop"][s])
        paths = fs.solve_sim_fused_batch(
            prop, tcfg["ode_weight"], tcfg["ode_init"].expand(n_lane, 2, 3),
            0.0, t_max, n_steps, tcfg["prior_pars"], "fitzhugh",
            interrogation=interrogation, eps=noise["eps"][s],
            eps_term=noise["eps_term"][s],
            eps_int=noise["eps_int"][s] if "eps_int" in noise else None,
            device="cpu")
        ratio = tloglik(prop, paths) - ll_s
        return abs(math.log(noise["u"][s][lane]) - float(ratio[lane]))

    dec = fc.check_lockstep(port, ref, init, margin_at)
    assert not dec.all()


def test_chain_runner_replays_jax():
    """FitzHugh-Nagumo under EK1 (kramer)."""
    _replay_chain_runner("kramer")


def test_chain_runner_chkrebtii_replays_jax():
    """Under chkrebtii: each estimate's interrogation normals from the
    ``key_int`` the JAX package splits off its key, the same accept
    decisions as the JAX package's."""
    _replay_chain_runner("chkrebtii")


@pytest.mark.parametrize("likelihood,n_samp,step", [
    ("fenrir", 5, 0.005), ("dalton", 4, 0.005)])
def test_mala_replays_jax(likelihood, n_samp, step):
    """8 lanes at step 0.005."""
    fc.replay_fused("mala", likelihood, n_samp, step)


def test_unported_options_raise():
    _, tcfg, theta = fc.fitz_cfgs(20, 2.0)
    with pytest.raises(NotImplementedError, match="unknown likelihood"):
        tc.run_chains_mala_fused(
            torch.zeros((2, 3)), None, 1, 0.1, tcfg["ode_weight"],
            tcfg["ode_init"], 0.0, 2.0, 20, tcfg["prior_pars"], None, None,
            None, None, "fitzhugh", likelihood="basic", device="cpu")
