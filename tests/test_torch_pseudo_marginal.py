"""
The port's pseudo-marginal MCMC (rodeo_tpu_torch.inference.pseudo_marginal
and rodeo_tpu_torch.parallel.run_chains) against the JAX package's, fed the
JAX functions' own draws: each key is split here as the JAX function splits
it (tests/mcmc_replay.py), and the port takes the normals and uniforms in
place of its generator.  Everything runs in float64 on the CPU, where the
two packages do the same operations: states and acceptance probabilities
agree within TOL = 1e-12 relative, so a decision could differ only where
its uniform lies within ~1e-12 of the acceptance probability: every
decision must be the JAX package's.  Then a state saved by either package
loads in the other, leaf for leaf, and the port's chains, drawing from a
generator, sample a Gaussian target's moments.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.inference import pseudo_marginal as jpm
from rodeo_tpu.parallel import run_chains as jax_run_chains
from rodeo_tpu_torch.inference import pseudo_marginal as tpm
from rodeo_tpu_torch.parallel import run_chains, sharded_loglik

import mcmc_replay

TOL = 1e-12
TARGET_MU, TARGET_SIG = 1.0, 0.5
PROP_MU, PROP_SIG = 0.0, 2.0


def _jlogpdf(x, mu, sig):
    return -0.5 * ((x - mu) / sig) ** 2 - jnp.log(sig) \
        - 0.5 * jnp.log(2.0 * jnp.pi)


def _tlogpdf(x, mu, sig):
    return -0.5 * ((x - mu) / sig) ** 2 - math.log(sig) \
        - 0.5 * math.log(2.0 * math.pi)


def _jtarget(p, key):
    """A noisy target: the exact log-density plus 0.3 standard normals
    drawn from the key, carried as the auxiliary data."""
    eps = 0.3 * jax.random.normal(key, (), jnp.float64)
    return jnp.sum(_jlogpdf(p, TARGET_MU, TARGET_SIG)) + eps, eps


def _ttarget(p, z):
    """The port's twin of _jtarget; ``z`` is the standard normal."""
    eps = 0.3 * torch.as_tensor(z, dtype=torch.float64)
    return torch.sum(_tlogpdf(p, TARGET_MU, TARGET_SIG)) + eps, eps


def _ld_noise(key):
    return np.array(jax.random.normal(key, (), jnp.float64))


def _close(port, ref, tol=TOL):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    assert np.abs(port - ref).max(initial=0.0) <= tol * scale


def _tree_close(port, ref):
    p_leaves = jax.tree.leaves(jax.tree.map(np.asarray, ref))
    t_leaves = [x.numpy() if isinstance(x, torch.Tensor) else x
                for x in jax.tree.leaves(port, is_leaf=lambda x: isinstance(
                    x, torch.Tensor))]
    assert len(p_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, p_leaves):
        _close(a, b)


@pytest.mark.parametrize("sigma", ["scalar", "vector", "matrix"])
def test_gaussian_noise_equals_jax(sigma):
    rng = np.random.default_rng(1)
    pos = (rng.normal(size=(2,)), {"b": rng.normal(size=(1, 2)),
                                   "a": rng.normal(size=())})
    s = {"scalar": 0.7, "vector": rng.uniform(0.1, 1.0, 5),
         "matrix": np.tril(rng.normal(size=(5, 5)))}[sigma]
    key = jax.random.PRNGKey(3)
    ref = jpm.generate_gaussian_noise(key, jax.tree.map(jnp.asarray, pos),
                                      jnp.asarray(s))
    z = np.array(jax.random.normal(key, (5,), jnp.float64))
    port = tpm.generate_gaussian_noise(
        torch.from_numpy(z), jax.tree.map(torch.from_numpy, pos,
                                          is_leaf=lambda x: isinstance(
                                              x, np.ndarray)),
        torch.as_tensor(s, dtype=torch.float64))
    assert isinstance(port, tuple) and sorted(port[1]) == ["a", "b"]
    _tree_close(port, ref)
    # a generator draws the same shapes
    drawn = tpm.normal(s)(
        torch.Generator().manual_seed(0), jax.tree.map(
            torch.from_numpy, pos, is_leaf=lambda x: isinstance(
                x, np.ndarray)))
    assert drawn[1]["b"].shape == (1, 2) and drawn[0].shape == (2,)


def test_static_binomial_sampling_equals_jax():
    key = jax.random.PRNGKey(5)
    log_p = np.array([-3.0, -0.2, 0.5, -1.0, np.nan, -0.01])
    prev = (np.zeros(6), np.arange(6.0))
    new = (np.ones(6), -np.arange(6.0))
    ref_state, (ref_acc, ref_p, _) = jpm.static_binomial_sampling(
        key, jnp.asarray(log_p), jax.tree.map(jnp.asarray, prev),
        jax.tree.map(jnp.asarray, new))
    u = np.array(jax.random.uniform(key, (6,), jnp.float64))
    state, (acc, p, _) = tpm.static_binomial_sampling(
        torch.from_numpy(u), torch.from_numpy(log_p),
        tuple(map(torch.from_numpy, prev)), tuple(map(torch.from_numpy, new)))
    assert acc.tolist() == np.asarray(ref_acc).tolist()
    _close(np.nan_to_num(p.numpy()), np.nan_to_num(np.asarray(ref_p)))
    assert np.isnan(p[4].item()) and np.isnan(ref_p[4])
    _tree_close(state, ref_state)


def _replay_steps(jalg, talg, x0, n_steps, seed):
    """Run one chain of each package from the same start, the port fed the
    JAX step's draws; check each step's state and information, and the
    pseudo-marginal semantics: an accepted state's auxiliary data is the
    fresh draw of its step, a rejected one keeps the previous state."""
    key0 = jax.random.PRNGKey(seed)
    jstate = jalg.init(jnp.asarray(x0), key0)
    tstate = talg.init(torch.from_numpy(x0), _ld_noise(key0))
    _tree_close(tstate, jstate)
    n_acc = 0
    key = jax.random.PRNGKey(seed + 1)
    for _ in range(n_steps):
        key, sk = jax.random.split(key)
        noise = mcmc_replay.rmh_step(sk, x0.shape, jnp.float64, _ld_noise)
        jnew, jinfo = jalg.step(sk, jstate)
        tnew, tinfo = talg.step(noise, tstate)
        assert bool(tinfo.is_accepted) == bool(jinfo.is_accepted)
        _close(tinfo.acceptance_rate, jinfo.acceptance_rate)
        _tree_close(tnew, jnew)
        if bool(tinfo.is_accepted):
            n_acc += 1
            assert torch.equal(tnew.auxdata, 0.3 * torch.as_tensor(
                noise["logdensity"]))
        else:
            for a, b in zip(tnew, tstate):
                assert b is None or torch.equal(a, b)
        jstate, tstate = jnew, tnew
    assert 0 < n_acc < n_steps


def test_normal_random_walk_steps_equal_jax():
    _replay_steps(jpm.normal_random_walk(_jtarget, jnp.array([0.8, 0.3])),
                  tpm.normal_random_walk(_ttarget, torch.tensor([0.8, 0.3],
                                                               dtype=torch.float64)),
                  np.array([1.0, 0.5]), 40, seed=3)


def test_additive_step_with_a_custom_step_equals_jax():
    half = 1.5
    jalg = jpm.additive_step_random_walk(
        _jtarget, lambda k, pos: half * (2.0 * jax.random.normal(
            k, jnp.shape(pos), jnp.float64) - 1.0))
    talg = tpm.additive_step_random_walk(
        _ttarget, lambda z, pos: half * (2.0 * torch.as_tensor(z) - 1.0))
    _replay_steps(jalg, talg, np.array([2.0]), 30, seed=7)


def _jprop_logdensity(state_from, state_to):
    return jnp.sum(_jlogpdf(state_to.position, PROP_MU, PROP_SIG))


def _tprop_logdensity(state_from, state_to):
    return torch.sum(_tlogpdf(state_to.position, PROP_MU, PROP_SIG))


def test_irmh_equals_jax_and_the_closed_form():
    """The independent proposal's acceptance ratio, with its asymmetric
    correction, against the JAX package's and the textbook formula."""
    jalg = jpm.irmh_as_top_level_api(
        _jtarget, lambda k: PROP_MU + PROP_SIG * jax.random.normal(
            k, (1,), jnp.float64), _jprop_logdensity)
    talg = tpm.irmh_as_top_level_api(
        _ttarget, lambda z: PROP_MU + PROP_SIG * torch.as_tensor(z),
        _tprop_logdensity)
    _replay_steps(jalg, talg, np.array([2.0]), 30, seed=11)
    state = talg.init(torch.tensor([2.0], dtype=torch.float64), 0.0)
    z = torch.tensor([0.4], dtype=torch.float64)
    _, info = talg.step({"proposal": z, "accept": 0.5, "logdensity": 0.0},
                        state)
    x_prop, x_cur = PROP_MU + PROP_SIG * z, state.position
    log_alpha = (_tlogpdf(x_prop, TARGET_MU, TARGET_SIG)
                 + _tlogpdf(x_cur, PROP_MU, PROP_SIG)
                 - _tlogpdf(x_cur, TARGET_MU, TARGET_SIG)
                 - _tlogpdf(x_prop, PROP_MU, PROP_SIG))
    assert abs(float(info.acceptance_rate)
               - min(1.0, math.exp(float(log_alpha)))) < 1e-12


def test_rmh_with_an_asymmetric_proposal_equals_jax():
    drift = 0.3
    jalg = jpm.rmh_as_top_level_api(
        _jtarget,
        lambda k, pos: pos + drift + 0.7 * jax.random.normal(
            k, jnp.shape(pos), jnp.float64),
        lambda s_from, s_to: jnp.sum(_jlogpdf(
            s_to.position, s_from.position + drift, 0.7)))
    talg = tpm.rmh_as_top_level_api(
        _ttarget, lambda z, pos: pos + drift + 0.7 * torch.as_tensor(z),
        lambda s_from, s_to: torch.sum(_tlogpdf(
            s_to.position, s_from.position + drift, 0.7)))
    _replay_steps(jalg, talg, np.array([0.0]), 30, seed=13)
    e_j = jpm.compute_asymmetric_acceptance_ratio(
        jpm.build_rmh_transition_energy(_jprop_logdensity))(
        jpm.RWAState(jnp.array([0.3]), jnp.array(-1.0)),
        jpm.RWAState(jnp.array([1.1]), jnp.array(-0.4)))
    e_t = tpm.compute_asymmetric_acceptance_ratio(
        tpm.build_rmh_transition_energy(_tprop_logdensity))(
        tpm.RWAState(torch.tensor([0.3], dtype=torch.float64),
                     torch.tensor(-1.0, dtype=torch.float64)),
        tpm.RWAState(torch.tensor([1.1], dtype=torch.float64),
                     torch.tensor(-0.4, dtype=torch.float64)))
    _close(e_t, e_j)


def _like(pos_kind):
    """A chain state of 8 chains, as numpy: a plain or pytree position."""
    rng = np.random.default_rng(17)
    pos = rng.normal(size=(8, 3))
    if pos_kind == "pytree":
        pos = {"theta": pos, "scale": rng.uniform(size=(8,))}
    return jpm.RWAState(pos, rng.normal(size=(8,)).astype(np.float32),
                        (rng.normal(size=(8, 4)), np.arange(8)))


@pytest.mark.parametrize("pos_kind", ["plain", "pytree"])
def test_a_saved_state_moves_between_the_packages(tmp_path, pos_kind):
    state = _like(pos_kind)
    jpm.save_state(tmp_path / "jax.npz", jax.tree.map(jnp.asarray, state))
    tlike = tpm.RWAState(*jax.tree.map(
        torch.from_numpy, tuple(state), is_leaf=lambda x: isinstance(
            x, np.ndarray)))
    loaded = tpm.load_state(tmp_path / "jax.npz", like=tlike, device="cpu")
    assert isinstance(loaded, tpm.RWAState)
    for a, b in zip(jax.tree.leaves(loaded, is_leaf=torch.is_tensor),
                    jax.tree.leaves(state)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tpm.save_state(tmp_path / "port.npz", tlike)
    back = jpm.load_state(tmp_path / "port.npz",
                          like=jax.tree.map(jnp.asarray, state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the default layout: one leaf per field
    flat = tpm.RWAState(torch.zeros(8, 3), torch.ones(8), torch.arange(8))
    tpm.save_state(tmp_path / "flat.npz", flat)
    for a, b in zip(jpm.load_state(tmp_path / "flat.npz"), flat):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(tpm.load_state(tmp_path / "flat.npz", device="cpu"),
                    flat):
        assert torch.equal(a, b)


def _accepts(positions, init):
    """Each step's accept decision of each chain: the position moved."""
    prev = np.concatenate([init[None], positions[:-1]])
    return np.any(positions != prev, axis=-1)


def test_run_chains_replays_jax():
    """Eight chains of the noisy target for 12 steps, the port's loop over
    the chains fed the draws of the JAX package's vmapped run."""
    n_chains, n_samples = 8, 12
    init = np.linspace(-1.0, 2.0, 2 * n_chains).reshape(n_chains, 2)
    sigma = np.array([0.8, 0.3])
    key = jax.random.PRNGKey(21)
    j_pos, j_state, j_acc = jax_run_chains(
        jpm.normal_random_walk(_jtarget, jnp.asarray(sigma)),
        jnp.asarray(init), key, n_samples)
    chain_keys, steps = mcmc_replay.run_chains(
        key, n_samples, n_chains,
        lambda k: mcmc_replay.rmh_step(k, (2,), jnp.float64, _ld_noise))
    noise = {"init": np.stack([_ld_noise(k) for k in chain_keys]),
             "step": steps}
    t_pos, t_state, t_acc = run_chains(
        tpm.normal_random_walk(_ttarget, torch.from_numpy(sigma)),
        torch.from_numpy(init), None, n_samples, noise=noise)
    j_pos = np.asarray(j_pos)
    dec_j, dec_t = _accepts(j_pos, init), _accepts(t_pos.numpy(), init)
    np.testing.assert_array_equal(dec_t, dec_j)
    _close(t_pos.numpy(), j_pos)
    _tree_close(t_state, j_state)
    # each package's float32 mean of the decisions, rounded its own way
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), rtol=1e-6)
    assert 0 < dec_t.mean() < 1


def test_run_chains_samples_a_gaussian_target():
    """The port drawing from a generator: 16 chains x 600 steps of the
    exact Gaussian target; the second half's mean within 6 standard
    errors (from the port's ESS) and its standard deviation within 10 %."""
    from rodeo_tpu_torch.parallel import ess

    def target(p, rng):
        return torch.sum(_tlogpdf(p, TARGET_MU, TARGET_SIG)), None

    gen = torch.Generator().manual_seed(2)
    pos, state, acc = run_chains(
        tpm.normal_random_walk(target, torch.tensor([1.2])),
        torch.zeros((16, 1), dtype=torch.float64), gen, 600)
    assert pos.shape == (600, 16, 1) and state.auxdata is None
    draws = pos[300:, :, 0].numpy()
    n_eff = ess(draws)
    assert 0.2 < float(acc.mean()) < 0.8
    assert abs(draws.mean() - TARGET_MU) <= 6 * TARGET_SIG / math.sqrt(n_eff)
    assert abs(draws.std() / TARGET_SIG - 1.0) < 0.1


def test_one_device_only():
    alg = tpm.normal_random_walk(_ttarget, 0.5)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        run_chains(alg, torch.zeros((2, 1)), None, 3, mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        sharded_loglik(lambda t: t.sum(), torch.zeros((2, 1)), mesh=object())
    thetas = torch.arange(6.0, dtype=torch.float64).reshape(3, 2)
    out = sharded_loglik(lambda t, z: t.sum() + z, thetas,
                         keys=torch.tensor([1.0, 2.0, 3.0]))
    assert out.tolist() == [2.0, 7.0, 12.0]
