"""
The port's lockstep NUTS (rodeo_tpu_torch.parallel.nuts) against the JAX
package's on the CPU, fed the JAX runs' own draws: the momenta, each
doubling's direction and merge uniform and each leaf's uniform, rebuilt
from the JAX key tree (tests/mcmc_replay.py).  On the correlated Gaussian
of tests/test_nuts.py (16 lanes x 10 proposals, max_depth 4), on a dict
position, and with divergent trajectories; over the fenrir likelihood
(the twins of K11a and K11b) and MAGI's path posterior (K10a, K10b) at
max_depth 2, whose JAX runners run their Pallas kernels in interpret mode.

Both packages work in float32.  A NUTS proposal takes many uniforms
against probabilities that both packages round their own way, and the
runner keeps no record of them, so a replay is compared whole: positions
within RTOL = 1e-5 relative (fused: tests/fused_chains.py's POS_RTOL),
final log-densities and acceptance statistics within 1e-4 of the largest
(the statistic is a mean of exponentials of energy errors).  Then a longer
port-only run, drawing from a generator, samples the Gaussian's moments
and skips the doublings after every lane has terminated.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.parallel import nuts as jn
from rodeo_tpu_torch.parallel import ess
from rodeo_tpu_torch.parallel import chains as tc
from rodeo_tpu_torch.parallel import nuts as tn

import fused_chains as fc
import mcmc_replay

RTOL = 1e-5
STAT_TOL = 1e-4
MEAN = np.array([1.0, -2.0, 0.5], np.float32)
L_CHOL = np.array([[1.0, 0.0, 0.0], [0.8, 0.6, 0.0], [-0.3, 0.5, 0.4]])
COV = L_CHOL @ L_CHOL.T
COV_INV = np.linalg.inv(COV).astype(np.float32)


def _jgauss(mean, cov_inv):
    mean, cov_inv = jnp.asarray(mean), jnp.asarray(cov_inv)

    def fn(pos):
        d = pos - mean
        return (-0.5 * jnp.einsum("li,ij,lj->l", d, cov_inv, d),
                -jnp.einsum("ij,lj->li", cov_inv, d))
    return fn


def _tgauss(mean, cov_inv):
    mean, cov_inv = torch.from_numpy(mean), torch.from_numpy(cov_inv)

    def fn(pos):
        d = pos - mean
        return (-0.5 * torch.sum((d @ cov_inv) * d, dim=-1),
                -(d @ cov_inv.T))
    return fn


def _scaled(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _replay(j_fn, t_fn, init, n_lane, n_samples, step, max_depth,
            seed, dim, rtol=RTOL):
    key = jax.random.PRNGKey(seed)
    j_pos, j_ll, j_acc = jn.make_nuts_runner(
        j_fn, n_lane, n_samples, step, max_depth=max_depth)(
        jax.tree.map(jnp.asarray, init), key)
    noise = mcmc_replay.nuts(key, n_samples, n_lane, dim, max_depth)
    t_pos, t_ll, t_acc = tn.make_nuts_runner(
        t_fn, n_lane, n_samples, step, max_depth=max_depth)(
        jax.tree.map(torch.from_numpy, init), noise=noise)
    for a, b in zip(jax.tree.leaves(t_pos, is_leaf=torch.is_tensor),
                    jax.tree.leaves(j_pos)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=rtol)
    assert _scaled(t_ll, j_ll) <= STAT_TOL
    assert np.abs(t_acc.numpy() - np.asarray(j_acc)).max() <= STAT_TOL
    return t_pos, t_ll, t_acc


def test_nuts_replays_jax_on_a_correlated_gaussian():
    init = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    pos, _, acc = _replay(_jgauss(MEAN, COV_INV), _tgauss(MEAN, COV_INV),
                          init, 16, 10, 0.15, 4, seed=0, dim=3)
    assert float(acc.mean()) > 0.7
    assert mcmc_replay.moved(pos.numpy(), init).mean() > 0.9


def test_nuts_replays_jax_on_a_dict_position():
    def jfn(pos):
        a, b = pos["a"], pos["b"]
        return (-0.5 * (jnp.sum(a * a, axis=-1)
                        + jnp.sum(b * b, axis=(-1, -2))),
                {"a": -a, "b": -b})

    def tfn(pos):
        a, b = pos["a"], pos["b"]
        return (-0.5 * (torch.sum(a * a, dim=-1)
                        + torch.sum(b * b, dim=(-1, -2))),
                {"a": -a, "b": -b})

    rng = np.random.default_rng(4)
    init = {"a": rng.normal(size=(16, 2)).astype(np.float32),
            "b": rng.normal(size=(16, 1, 2)).astype(np.float32)}
    pos, _, _ = _replay(jfn, tfn, init, 16, 10, 0.6, 3, seed=3, dim=4)
    assert pos["a"].shape == (10, 16, 2) and pos["b"].shape == (10, 16, 1, 2)


def test_nuts_replays_jax_through_divergences():
    """A step far past stability: every trajectory diverges at its first
    leaf, the chains stay put, finite, with ~zero acceptance."""
    cov_inv = (100.0 * np.eye(2)).astype(np.float32)
    zero = np.zeros(2, np.float32)
    init = np.full((8, 2), 0.1, np.float32)
    pos, ll, acc = _replay(_jgauss(zero, cov_inv), _tgauss(zero, cov_inv),
                           init, 8, 20, 50.0, 4, seed=4, dim=2)
    assert torch.isfinite(ll).all() and (acc < 0.1).all()


def test_nuts_fused_fenrir_replays_jax():
    """run_chains_nuts_fused over tests/fused_chains.py's fenrir fixture:
    8 lanes x 3 proposals at max_depth 2, step 0.002."""
    n_lane, n_samp, step = 8, 3, 0.002
    init, jkw, tkw = fc.fenrir_problem(n_lane)
    key = jax.random.PRNGKey(1)
    j_pos, j_ll, j_acc = jn.run_chains_nuts_fused(
        jnp.asarray(init), key, n_samples=n_samp, step_size=step,
        max_depth=2, **jkw)
    noise = mcmc_replay.nuts(key, n_samp, n_lane, 3, 2)
    t_pos, t_ll, t_acc = tn.run_chains_nuts_fused(
        torch.from_numpy(init), None, n_samp, step, max_depth=2,
        noise=noise, **tkw)
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos),
                               rtol=fc.POS_RTOL, atol=fc.POS_RTOL)
    assert _scaled(t_ll, j_ll) <= fc.LL_RTOL
    assert np.abs(t_acc.numpy() - np.asarray(j_acc)).max() <= STAT_TOL
    assert mcmc_replay.moved(t_pos.numpy(), init).any()


@pytest.mark.parametrize("joint", [False, True], ids=["path", "path+theta"])
def test_nuts_magi_replays_jax(joint):
    """run_chains_nuts_magi on tests/fused_chains.py's MAGI fixture, 4
    lanes x 2 proposals at max_depth 2, with and without a joint theta."""
    jcfg, tcfg, subsets = fc.magi_problem(3)
    thetas = np.ones((4,), np.float32)
    key = jax.random.PRNGKey(6)
    j_out = jn.run_chains_nuts_magi(
        jnp.asarray(subsets), key, n_samples=2, step_size=1e-6,
        max_depth=2, ode_expand=fc.jexpand_th if joint else fc.jexpand,
        n_active=2, prior_pars=jcfg["prior_pars"], dt=2.0 / 32,
        theta_lanes=jnp.asarray(thetas) if joint else None)
    dim = subsets[0].size + (1 if joint else 0)
    noise = mcmc_replay.nuts(key, 2, 4, dim, 2)
    t_out = tn.run_chains_nuts_magi(
        torch.from_numpy(subsets), None, 2, 1e-6, max_depth=2,
        ode_expand=fc.texpand_th if joint else fc.texpand, n_active=2,
        prior_pars=tcfg["prior_pars"], dt=2.0 / 32,
        theta_lanes=torch.from_numpy(thetas) if joint else None,
        noise=noise, device="cpu")
    for a, b in zip(jax.tree.leaves(t_out[0], is_leaf=torch.is_tensor),
                    jax.tree.leaves(j_out[0])):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=fc.POS_RTOL, atol=fc.POS_RTOL)
    assert _scaled(t_out[1], j_out[1]) <= fc.LL_RTOL
    assert np.abs(t_out[2].numpy() - np.asarray(j_out[2])).max() \
        <= STAT_TOL


def test_nuts_samples_the_gaussian():
    """Drawing from a generator, 64 lanes x 300 proposals at max_depth 5:
    the means within 6 standard errors (the port's ESS), the covariance
    within 0.1 (tests/test_nuts.py's bound); the doublings after every
    lane has terminated are skipped, so fewer gradient calls are made than
    the fixed budget of 31 a proposal."""
    calls = [0]
    base = _tgauss(MEAN, COV_INV)

    def fn(pos):
        calls[0] += 1
        return base(pos)

    run = tn.make_nuts_runner(fn, 64, 300, 0.15, max_depth=5)
    pos, ll, acc = run(torch.zeros((64, 3)), torch.Generator().manual_seed(0))
    assert torch.isfinite(pos).all() and (acc > 0.7).all()
    assert calls[0] < 1 + 300 * 31
    draws = pos[100:].numpy()
    n_eff = ess(draws)
    se = np.sqrt(np.diag(COV) / n_eff)
    assert np.all(np.abs(draws.reshape(-1, 3).mean(0) - MEAN) <= 6 * se)
    np.testing.assert_allclose(np.cov(draws.reshape(-1, 3).T), COV,
                               atol=0.1)
    # the step size is a run-time argument, checked against the dimension
    eps, _, a = tc.adapt_step_size(
        tn.make_nuts_runner(base, 32, 16, 0.5, max_depth=4),
        torch.zeros((32, 3)), torch.Generator().manual_seed(1), 0.5,
        target_accept=0.8, n_windows=6)
    assert 0.5 < a <= 1.0 and float(eps) > 0
    assert math.isfinite(float(eps))


def test_step_size_of_the_flattened_dimension():
    """A per-dimension step of the flattened position is accepted, as in
    the JAX package, and a wrong one refused with its message."""
    fn = _tgauss(np.zeros(2, np.float32), np.eye(2, dtype=np.float32))
    run = tn.make_nuts_runner(fn, 4, 3, torch.tensor([0.2, 0.3]),
                              max_depth=2)
    assert run(torch.zeros((4, 2)), torch.Generator())[0].shape == (3, 4, 2)
    jfn = _jgauss(np.zeros(2, np.float32), np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError) as e_j:
        jn.make_nuts_runner(jfn, 4, 3, 0.3, max_depth=2)(
            jnp.zeros((4, 2)), jax.random.PRNGKey(0),
            step_size_override=jnp.ones(3))
    with pytest.raises(ValueError) as e_t:
        run(torch.zeros((4, 2)), None, step_size_override=torch.ones(3))
    assert str(e_t.value) == str(e_j.value)
