"""
The port's lockstep runners over MAGI's path posterior
(rodeo_tpu_torch.parallel.chains: run_chains_mala_magi with and without a
joint theta, and run_chains_magi_gibbs, the Gibbs sampler of the path and
sigma^2; the twins of K10a and K10b) against the JAX package's on the CPU,
whose Pallas kernels run in interpret mode, fed the JAX runs' own draws
(tests/mcmc_replay.py); the tolerances are tests/fused_chains.py's, the
sigma^2 draws within 1e-4 relative.  Gibbs returns no inner step's state,
so its runs are compared sweep by sweep, without the exception for ties.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.parallel import chains as jc
from rodeo_tpu_torch.ops import fused_magi as fm
from rodeo_tpu_torch.parallel import chains as tc

import fused_chains as fc
import mcmc_replay

@pytest.mark.parametrize("joint", [False, True], ids=["path", "path+theta"])
def test_magi_mala_replays_jax(joint):
    """Path-space MALA over MAGI's fused adjoint, with the observation
    log-likelihood of tests/test_parallel_fused.py as the rest of the
    posterior, and jointly with a per-lane theta.  From this rough path
    (log-densities ~ -1e12) every step accepts and climbs: the chain is
    the gradients' (K10b's twin against the Pallas adjoint)."""
    jcfg, tcfg, subsets = fc.magi_problem(2)
    n_samp, step, dt = 6, 3e-6, 2.0 / 32
    yobs = subsets[0, ::8, :, 0]

    def jextra(position):
        def obs_ll(u):
            r = u[:, ::8, :, 0] - yobs
            return -0.5 * jnp.sum(r * r, axis=(1, 2)) / 0.04
        u = position[0] if joint else position
        ll, vjp = jax.vjp(obs_ll, u)
        g = vjp(jnp.ones_like(ll))[0]
        return ll, ((g, jnp.zeros_like(position[1])) if joint else g)

    def textra(position):
        u = position[0] if joint else position
        r = u[:, ::8, :, 0] - torch.from_numpy(yobs)
        ll = -0.5 * torch.sum(r * r, dim=(1, 2)) / 0.04
        g = torch.zeros_like(u)
        g[:, ::8, :, 0] = -r / 0.04
        return ll, ((g, torch.zeros_like(position[1])) if joint else g)

    thetas = np.linspace(0.9, 1.1, 4).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jc.run_chains_mala_magi(
        jnp.asarray(subsets), key, n_samples=n_samp, step_size=step,
        ode_expand=fc.jexpand_th if joint else fc.jexpand, n_active=2,
        prior_pars=jcfg["prior_pars"], dt=dt,
        theta_lanes=jnp.asarray(thetas) if joint else None,
        extra_grad_fn=jextra)
    init = (subsets, thetas) if joint else subsets
    noise = mcmc_replay.mala_or_hmc(key, n_samp, init, 4, "xi")
    fm.LAUNCHES["magi_batch"] = fm.LAUNCHES["magi_adjoint_batch"] = 0
    port = tc.run_chains_mala_magi(
        torch.from_numpy(subsets), None, n_samp, step,
        ode_expand=fc.texpand_th if joint else fc.texpand, n_active=2,
        prior_pars=tcfg["prior_pars"], dt=dt,
        theta_lanes=torch.from_numpy(thetas) if joint else None,
        extra_grad_fn=textra, noise=noise, device="cpu")
    assert fm.LAUNCHES == {"magi_batch": 0, "magi_adjoint_batch": 0}
    lpg = tc._magi_logpost_grad(joint, fc.texpand_th if joint else fc.texpand,
                                2, tcfg["prior_pars"], dt, None, textra,
                                "cpu", {})
    eps = torch.tensor(step, dtype=torch.float32)
    t_init = jax.tree.map(torch.from_numpy, init)

    def margin_at(s, lane):
        pos = jax.tree.map(lambda p: p[s - 1], port[0]) if s else t_init
        ll, g = lpg(pos)
        draw = jax.tree.map(lambda x: torch.from_numpy(x[s]), noise["xi"])
        ratio = tc._mala_proposal(lpg, eps, pos, ll, g, draw)[3]
        return abs(math.log(noise["u"][s][lane]) - float(ratio[lane]))

    fc.check_lockstep(port, ref, init, margin_at)
    if joint:
        assert port[0][1].shape == (n_samp, 4)


def test_magi_gibbs_replays_jax():
    """4 lanes x 4 sweeps of 2 MALA steps and a conjugate sigma^2 draw,
    on tests/test_parallel_fused.py's Gibbs fixture; the gamma variates
    are the JAX package's."""
    jcfg, tcfg, _ = fc.fitz_cfgs(32, 2.0)
    rng = np.random.default_rng(4)
    base = (rng.normal(size=(33, 2, 2)) * 0.1).astype(np.float32)
    subsets = np.stack([base + np.float32(0.02 * i) for i in range(4)])
    n_sweeps, n_inner, dt, step = 4, 2, 2.0 / 32, 1e-3
    key = jax.random.PRNGKey(0)
    j_pos, j_sig2, j_ll, j_acc = jc.run_chains_magi_gibbs(
        jnp.asarray(subsets), key, n_sweeps=n_sweeps, step_size=step,
        ode_expand=fc.jexpand, n_active=2, prior_pars=jcfg["prior_pars"],
        dt=dt, sig2_init=1.0, n_inner=n_inner)
    d_dim = 32 * 2 * 2
    noise = mcmc_replay.gibbs(key, n_sweeps, n_inner, subsets.shape, 4,
                              2.0 + 0.5 * d_dim)
    fm.LAUNCHES["magi_batch"] = fm.LAUNCHES["magi_adjoint_batch"] = 0
    t_pos, t_sig2, t_ll, t_acc = tc.run_chains_magi_gibbs(
        torch.from_numpy(subsets), None, n_sweeps, step, ode_expand=fc.texpand,
        n_active=2, prior_pars=tcfg["prior_pars"], dt=dt, sig2_init=1.0,
        n_inner=n_inner, noise=noise, device="cpu")
    assert fm.LAUNCHES == {"magi_batch": 0, "magi_adjoint_batch": 0}
    assert t_pos.shape == (n_sweeps, 4, 33, 2, 2)
    assert t_sig2.shape == (n_sweeps, 4) and (t_sig2 > 0).all()
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos),
                               rtol=fc.POS_RTOL, atol=fc.POS_RTOL)
    np.testing.assert_allclose(t_sig2.numpy(), np.asarray(j_sig2),
                               rtol=1e-4)
    fc.scaled_close(t_ll, j_ll, fc.LL_RTOL)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), rtol=1e-6)
    assert 0 < float(t_acc.mean()) < 1
    # with a generator: the same shapes, finite
    out = tc.run_chains_magi_gibbs(
        torch.from_numpy(subsets), torch.Generator().manual_seed(0), 2,
        step, ode_expand=fc.texpand, n_active=2,
        prior_pars=tcfg["prior_pars"], dt=dt, sig2_init=1.0, n_inner=1,
        device="cpu")
    assert out[1].shape == (2, 4) and torch.isfinite(out[2]).all()


