"""
The port's lockstep MALA and HMC runners, step-size adaptation, MAGI's
sigma^2 quadratic form and the runners' argument checks
(rodeo_tpu_torch.parallel.chains) against the JAX package's, on analytic
targets on the CPU.

The runners replay the JAX runners' own draws: the key tree of each JAX
run is rebuilt here with jax.random (tests/mcmc_replay.py) and passed to
the port as ``noise``.  Both packages work in float32 and may round
differently in the last bit, so each chain's accept decisions must be the
JAX package's, except at a step whose log acceptance ratio lies within
1e-4 of its log-uniform (the test names it and compares that lane up to
it), and positions and log-densities agree within RTOL = 1e-5 relative.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.parallel import chains as jc
from rodeo_tpu_torch.parallel import chains as tc
from rodeo_tpu_torch.parallel import nuts as tn

import mcmc_replay

RTOL = 1e-5
MU = np.array([1.0, -2.0], np.float32)
VAR = np.array([0.5, 2.0], np.float32)
B_MU, B_VAR = np.float32(0.5), np.float32(1.5)
N_LANE, N_SAMPLES = 64, 20


def _jlpg(pos):
    return -0.5 * jnp.sum((pos - MU) ** 2 / VAR, axis=-1), -(pos - MU) / VAR


def _tlpg(pos):
    mu, var = torch.from_numpy(MU), torch.from_numpy(VAR)
    return -0.5 * torch.sum((pos - mu) ** 2 / var, dim=-1), -(pos - mu) / var


def _jlpg_tuple(pos):
    a, b = pos
    ll, ga = _jlpg(a)
    return ll - 0.5 * (b - B_MU) ** 2 / B_VAR, (ga, -(b - B_MU) / B_VAR)


def _tlpg_tuple(pos):
    a, b = pos
    ll, ga = _tlpg(a)
    return ll - 0.5 * (b - B_MU) ** 2 / B_VAR, (ga, -(b - B_MU) / B_VAR)


def _init(tuple_pos):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(N_LANE, 2)).astype(np.float32)
    if not tuple_pos:
        return a
    return a, rng.normal(size=(N_LANE,)).astype(np.float32)


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _margin(kind, lpg, eps, n_leapfrog, positions, init, noise):
    """margin_at(s, lane) of mcmc_replay.steps_to_compare for the port's
    chain: its log acceptance ratio at step s from its state before it."""
    def margin_at(s, lane):
        pos = init if s == 0 else jax.tree.map(lambda p: p[s - 1],
                                               positions)
        ll, g = lpg(pos)
        draw = jax.tree.map(lambda x: x[s], noise["xi" if kind == "mala"
                                                   else "mom"])
        if kind == "mala":
            ratio = tc._mala_proposal(lpg, eps, pos, ll, g, draw)[3]
        else:
            ratio = tc._hmc_proposal(lpg, eps, n_leapfrog, pos, ll, g,
                                     draw)[3]
        return abs(math.log(noise["u"][s][lane]) - float(ratio[lane]))
    return margin_at


def _check_replay(kind, port_out, jax_out, init, noise, lpg, eps,
                  n_leapfrog=None):
    """The port's run against the JAX package's: decisions, positions,
    log-densities and acceptance rates."""
    t_pos, t_ll, t_acc = port_out
    j_pos, j_ll, j_acc = jax_out
    t_pos_np = jax.tree.map(lambda x: x.numpy(), t_pos)
    dec_t = mcmc_replay.moved(t_pos_np, init)
    dec_j = mcmc_replay.moved(j_pos, init)
    counts = mcmc_replay.steps_to_compare(dec_t, dec_j, _margin(
        kind, lpg, eps, n_leapfrog, t_pos, _torch(init), _torch(noise)))
    full = mcmc_replay.assert_positions_close(t_pos_np, j_pos, counts, RTOL)
    np.testing.assert_allclose(t_ll.numpy()[full], np.asarray(j_ll)[full],
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(t_acc.numpy()[full], np.asarray(j_acc)[full],
                               rtol=1e-6)
    assert 0 < dec_t.mean() < 1


@pytest.mark.parametrize("tuple_pos", [False, True],
                         ids=["array", "tuple"])
@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_runner_replays_jax(kind, tuple_pos):
    """64 lanes x 20 steps on the analytic Gaussian of
    tests/test_parallel_fused.py (MALA at step 0.8; HMC at sqrt(var) / 2
    per dimension, 8 leapfrog steps), and on a tuple position."""
    jlpg, tlpg = (_jlpg_tuple, _tlpg_tuple) if tuple_pos else (_jlpg,
                                                                _tlpg)
    step = 0.8 if kind == "mala" else (0.6 if tuple_pos
                                       else np.sqrt(VAR) * 0.5)
    init = _init(tuple_pos)
    key = jax.random.PRNGKey(11 if kind == "mala" else 12)
    if kind == "mala":
        j_run = jc.make_mala_runner(jlpg, N_LANE, N_SAMPLES, step)
        t_run = tc.make_mala_runner(tlpg, N_LANE, N_SAMPLES, step)
    else:
        j_run = jc.make_hmc_runner(jlpg, N_LANE, N_SAMPLES, step,
                                   n_leapfrog=8)
        t_run = tc.make_hmc_runner(tlpg, N_LANE, N_SAMPLES, step,
                                   n_leapfrog=8)
    jax_out = j_run(jax.tree.map(jnp.asarray, init), key)
    noise = mcmc_replay.mala_or_hmc(key, N_SAMPLES, init, N_LANE,
                                    "xi" if kind == "mala" else "mom")
    port_out = t_run(_torch(init), noise=noise)
    eps = tc._step_size(_torch(init), step, torch.device("cpu"))
    _check_replay(kind, port_out, jax_out, init, noise, tlpg, eps, 8)
    assert jax.tree.structure(jax.tree.map(
        lambda x: 0, port_out[0])) == jax.tree.structure(jax.tree.map(
            lambda x: 0, jax_out[0]))


def test_runner_with_a_generator():
    """Drawing from a generator: the same generator state gives the same
    chain, a NaN log-density never accepts, and the step size is a
    run-time argument."""
    def lpg(pos):
        ll, g = _tlpg(pos)
        return torch.where(pos[:, 0] > 2.5, math.nan, ll), g

    run = tc.make_mala_runner(lpg, 8, 30, 0.8)
    init = torch.zeros((8, 2))
    a = run(init, torch.Generator().manual_seed(1))
    b = run(init, torch.Generator().manual_seed(1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a[0][..., 0] <= 2.5).all() and torch.isfinite(a[1]).all()
    small = run(init, torch.Generator().manual_seed(1),
                step_size_override=1e-3)
    assert float(small[2].mean()) > float(a[2].mean())


def _stub(pkg):
    """A runner whose mean acceptance is a fixed function of its step
    size, 1 / (1 + mean(eps)^2), and whose draws spread by eps times a
    fixed pattern per dimension; it records the step sizes it is run at."""
    xp = jnp if pkg == "jax" else torch
    rng = np.random.default_rng(9)
    pattern = rng.normal(size=(6, 16, 3)).astype(np.float32) \
        * np.array([1.0, 3.0, 0.2], np.float32)
    calls = []

    def runner(pos, key, step_size_override):
        eps = xp.asarray(step_size_override) if pkg == "jax" else \
            torch.as_tensor(step_size_override)
        calls.append(np.asarray(eps, np.float64).copy())
        pos_arr = xp.asarray(pos) if pkg == "jax" else pos
        positions = pos_arr[None] + eps * (xp.asarray(pattern) if pkg == "jax"
                                           else torch.from_numpy(pattern))
        m = xp.mean(eps)
        acc = 1.0 / (1.0 + m * m) * xp.ones((16,), dtype=xp.float32)
        return positions, None, acc

    return runner, calls


@pytest.mark.parametrize("fn", ["adapt_step_size", "adapt_warmup"])
def test_adaptation_follows_jax(fn):
    """The same sequence of step sizes as the JAX package's, to float32
    rounding, from a stub runner whose acceptance depends on the step
    alone."""
    init = np.zeros((16, 3), np.float32)
    j_run, j_calls = _stub("jax")
    t_run, t_calls = _stub("torch")
    kw = dict(init_step=0.3, target_accept=0.6)
    if fn == "adapt_step_size":
        kw["n_windows"] = 12
    j_eps, j_pos, j_acc = getattr(jc, fn)(j_run, jnp.asarray(init),
                                          jax.random.PRNGKey(0), **kw)
    t_eps, t_pos, t_acc = getattr(tc, fn)(t_run, torch.from_numpy(init),
                                          None, **kw)
    assert len(t_calls) == len(j_calls) > 12
    for a, b in zip(t_calls, j_calls):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t_eps), np.asarray(j_eps),
                               rtol=1e-5)
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), rtol=1e-5,
                               atol=1e-6)
    assert abs(t_acc - j_acc) < 1e-5
    if fn == "adapt_warmup":
        assert t_eps.shape == (3,) and float(t_eps[1]) > float(t_eps[0])


def test_sig2_quadform_equals_jax():
    rng = np.random.default_rng(2)
    ld_s = rng.normal(size=(6,)).astype(np.float32) * 100 - 500
    # 0.5 D log 2 = 44.4: the first and fifth lanes' Q clamps to 0
    ld_2s = ld_s + np.array([-80, -10, 0, 20, -50, 5], np.float32)
    s = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    q_j, d_j = jc.magi_sig2_quadform(jnp.asarray(ld_s), jnp.asarray(ld_2s),
                                     jnp.asarray(s), 32, 2, 2)
    q_t, d_t = tc.magi_sig2_quadform(*map(torch.from_numpy,
                                          (ld_s, ld_2s, s)), 32, 2, 2)
    assert d_t == d_j == 128.0
    assert (q_t >= 0).all() and (q_t == 0).any()
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-6,
                               atol=1e-4)


def _lp(pos):
    return -0.5 * (pos ** 2).sum(-1), -pos


@pytest.mark.parametrize("case", ["n_leapfrog", "n_inner", "max_depth",
                                  "step_shape", "warmup_pytree"])
def test_validation_errors_match_jax(case):
    """Both packages refuse the same arguments with the same message."""
    def port():
        if case == "n_leapfrog":
            tc.make_hmc_runner(_lp, 4, 10, 0.1, n_leapfrog=0)
        elif case == "n_inner":
            tc.run_chains_magi_gibbs(
                torch.zeros((2, 9, 1, 2)), None, 2, 1e-6,
                ode_expand=lambda u, **p: u, n_active=2,
                prior_pars=(torch.zeros((1, 2, 2)), torch.eye(2)[None]),
                dt=0.1, sig2_init=1.0, n_inner=0, device="cpu")
        elif case == "max_depth":
            tn.make_nuts_runner(_lp, 4, 10, 0.1, max_depth=0)
        elif case == "step_shape":
            tn.make_nuts_runner(_lp, 4, 2, torch.ones(3), max_depth=1)(
                torch.zeros((4, 2)), None)
        else:
            tc.adapt_warmup(None, (torch.zeros((4, 2)),), None, 0.1)

    def ref():
        jlp = lambda p: (-0.5 * (p ** 2).sum(-1), -p)  # noqa: E731
        if case == "n_leapfrog":
            jc.make_hmc_runner(jlp, 4, 10, 0.1, n_leapfrog=0)
        elif case == "n_inner":
            jc.run_chains_magi_gibbs(
                jnp.zeros((2, 9, 1, 2)), jax.random.PRNGKey(0), 2, 1e-6,
                ode_expand=lambda u, **p: u, n_active=2,
                prior_pars=(jnp.zeros((1, 2, 2)), jnp.eye(2)[None]),
                dt=0.1, sig2_init=1.0, n_inner=0)
        elif case == "max_depth":
            from rodeo_tpu.parallel import nuts as jn
            jn.make_nuts_runner(jlp, 4, 10, 0.1, max_depth=0)
        elif case == "step_shape":
            from rodeo_tpu.parallel import nuts as jn
            jn.make_nuts_runner(jlp, 4, 2, jnp.ones(3), max_depth=1)(
                jnp.zeros((4, 2)), jax.random.PRNGKey(0))
        else:
            jc.adapt_warmup(None, (jnp.zeros((4, 2)),),
                            jax.random.PRNGKey(0), 0.1)

    with pytest.raises(ValueError) as e_t:
        port()
    with pytest.raises(ValueError) as e_j:
        ref()
    assert str(e_t.value) == str(e_j.value)


def test_the_card_phase_tool_imports_no_jax_and_judges_agreement():
    """tools/torch_mcmc_reference.py, which chip_smoke.py's mcmc phase
    imports on the card, imports no JAX; its agreement rule passes means
    within AGREE_Z standard errors and fails a wider gap or a sampler whose
    chains never moved."""
    import ast
    import pathlib
    import sys
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "torch_mcmc_reference.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "rodeo_tpu")
                           for n in names)
    sys.path.insert(0, str(path.parent))
    import torch_mcmc_reference as ref
    rng = np.random.default_rng(0)
    draws = torch.from_numpy(rng.normal(size=(200, 8, 3)))
    summ = ref.summary(draws)
    assert np.all(np.asarray(summ["ess"]) > 800)
    shifted = dict(summ, mean=[m + 3 * se for m, se in zip(summ["mean"],
                                                            summ["se"])])
    assert ref.agreement({"a": summ, "b": shifted})["ok"]
    far = dict(summ, mean=[m + 8 * se for m, se in zip(summ["mean"],
                                                        summ["se"])])
    assert not ref.agreement({"a": summ, "b": far})["ok"]
    stuck = ref.summary(torch.ones((20, 8, 3)))
    assert not ref.agreement({"a": summ, "b": stuck})["ok"]
