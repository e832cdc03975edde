"""
Parity of the port's stationary-gain single solve
(``rodeo_tpu_torch.solve_mv_fused_stationary``: the exact prefix on K3, the
mean chain on K5a, or K5b and K5c, the smoother on K4) with the JAX
package's ``solve_mv_fused_stationary``, whose Pallas kernels run here in
interpret mode under ``jax.jit``, where they take the transition
coefficients from the raw prior, as the port does.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels; the on-card comparison of kernel and twin is
tests/test_torch_cuda.py (and chip_smoke.py).  Both packages work in
float32 and round differently (XLA contracts, reorders and fuses), so the
solves are held to SCALED_TOL = 1e-4 of the largest entry, as the other
single-solve tests are.  Measured over these runs: the means land within
7.8e-6 and the variances within 4.6e-5 (FitzHugh-Nagumo EK0) of the JAX
package's, with the JAX grouping of the composed smoother (k_compose=64)
and with the port's plain default alike.  The twins of K5a, K5b and K5c
agree with the Pallas kernels within KERNEL_TOL.

The port-only checks hold the stationary path to the port's exact
``solve_mv_fused`` at the JAX package's own tolerance for that comparison
(tests/test_pallas_kalman.py::test_stationary_matches_exact: means rtol =
atol = 5e-3, variances 2e-4 of the largest), at the schedule's boundaries.
Without a card the entry point raises rather than run on the CPU
(tests/test_torch_core.py::test_entry_points_default_to_the_card).
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import pallas_kalman as pk

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_kalman as fk

SCALED_TOL = 1e-4
# the JAX package's tolerance of the stationary path against the exact one
MEAN_TOL = 5e-3
VAR_TOL = 2e-4
# a twin against its Pallas kernel, scaled by the largest mean: XLA
# contracts the chain's multiply-adds, and Lorenz63 grows the difference;
# measured 2.1e-6 (K5a over 192 steps), 2.6e-7 (K5b) and 1.7e-7 (K5c)
KERNEL_TOL = 1e-5
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}
# model, interrogation, N, t_max: the two-phase schedule (K3 + K5b + K5c;
# at N = 200 two groups and a 72-step prefix) and K5a (N = 150, one group)
CASES = {
    "lorenz/kramer/200": ("lorenz", "kramer", 200, 2.0),
    "lorenz/kramer/150": ("lorenz", "kramer", 150, 1.5),
    "lorenz/rodeo/200": ("lorenz", "rodeo", 200, 2.0),
    "fitzhugh/rodeo/200": ("fitzhugh", "rodeo", 200, 10.0),
}
TWIN_NAMES = ("_mean_gain_plain", "_mean_boundary_plain",
              "_mean_recovery_plain")


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


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


def _port_args(tcfg, theta, t_max, n_steps):
    return (torch.from_numpy(theta), tcfg["ode_weight"], tcfg["ode_init"],
            0.0, t_max, n_steps, tcfg["prior_pars"])


@pytest.fixture
def twin_calls(monkeypatch):
    """Counts the calls of each mean-chain twin."""
    calls = dict.fromkeys(TWIN_NAMES, 0)
    for name in TWIN_NAMES:
        def counted(*args, _twin=getattr(fk, name), _name=name, **kw):
            calls[_name] += 1
            return _twin(*args, **kw)
        monkeypatch.setattr(fk, name, counted)
    return calls


@pytest.fixture(scope="module", params=list(CASES))
def jax_reference(request):
    """The JAX package's stationary solve of one case, computed once."""
    model, mode, n_steps, t_max = CASES[request.param]
    jcfg, tcfg, theta = _problem(model, n_steps, t_max, seed=3)
    jmod = JMODELS[model]
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    fn = jax.jit(lambda th: pk.solve_mv_fused_stationary(
        key=None, theta=th, ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=jac, interrogation=mode, **jcfg))
    mean_j, var_j = fn(jnp.asarray(theta))
    return (request.param, tcfg, theta, np.asarray(mean_j),
            np.asarray(var_j))


@pytest.mark.parametrize("k_compose", [64, None])
def test_stationary_matches_jax(jax_reference, twin_calls, k_compose):
    """Each case against the JAX package: with the JAX grouping of the
    composed smoother (k_compose=64) and with the port's plain default;
    the schedule runs the twins the JAX package runs its kernels."""
    case, tcfg, theta, mean_j, var_j = jax_reference
    model, mode, n_steps, t_max = CASES[case]
    fk.LAUNCHES.update(dict.fromkeys(fk.LAUNCHES, 0))
    mean_t, var_t = rt.solve_mv_fused_stationary(
        *_port_args(tcfg, theta, t_max, n_steps), model=model,
        interrogation=mode, k_compose=k_compose, device="cpu")
    assert not any(fk.LAUNCHES.values())
    two_phase = n_steps == 200
    assert twin_calls == {"_mean_gain_plain": int(not two_phase),
                          "_mean_boundary_plain": int(two_phase),
                          "_mean_recovery_plain": int(two_phase)}
    assert mean_t.shape == mean_j.shape and var_t.shape == var_j.shape
    assert mean_t.dtype == var_t.dtype == torch.float32
    assert torch.isfinite(mean_t).all() and torch.isfinite(var_t).all()
    for d in range(3):
        assert _scaled_err(mean_t[..., d], mean_j[..., d]) <= SCALED_TOL, d
        assert _scaled_err(var_t[..., d, :], var_j[..., d, :]) \
            <= SCALED_TOL, d


def _chain_inputs(model, mode, n_steps, t_max, seed):
    """The operands of the mean chain as the stationary path builds them:
    a 64-step exact prefix (the K3 twin) and its gains, the two-phase tail
    of n_steps - 64 steps."""
    _, tcfg, theta = _problem(model, n_steps, t_max, seed)
    ops, _ = fk._single_operands(*_port_args(tcfg, theta, t_max, n_steps))
    fused = fk.resolve_model(model)
    mfw, _, _, ppw = fk.fused_filter(
        fused, 64, **{**ops, "tgrid": ops["tgrid"][:64]}, mode=mode)
    gains = fk._stationary_gains(fused, ops, ppw, mode, 0.0)
    chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
    return chain, ops, mfw, gains


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 1.92),
                                              ("fitzhugh", "rodeo", 9.6)])
def test_boundary_and_recovery_equal_the_gain_chain(model, mode, t_max):
    """K5b + K5c over the tail are K5a's chain from the same start with the
    frozen gain at every step, bitwise: the recovery re-runs the
    boundary chain's operations from its stored states (here the twins; on
    the card the kernels, tests/test_torch_cuda.py)."""
    chain, ops, mfw, gains = _chain_inputs(model, mode, 192, t_max, seed=5)
    k_star = gains[-1]
    tail = ops["tgrid"][64:]
    bnd = fk.mean_boundary_chain(*chain, mfw[-1], ops["theta"], tail, k_star)
    rows = fk.mean_recovery_chain(*chain, bnd, ops["theta"], tail, k_star)
    ref = fk.mean_gain_chain(*chain, mfw[-1], ops["theta"], tail,
                             k_star.expand(128, *k_star.shape).contiguous())
    assert bnd.shape == (2, k_star.shape[0], 3) and rows.shape == ref.shape
    assert torch.equal(rows, ref)
    assert torch.equal(bnd[0], mfw[-1]) and torch.equal(bnd[1], ref[63])


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape),
                        memory_space=pltpu.VMEM)


def test_twins_match_the_pallas_kernels():
    """The three twins against the JAX package's Pallas kernels on the same
    inputs (Lorenz63 EK1, a 64-step prefix, two 64-step groups): K5a's
    over 192 steps with the prefix's gains and the frozen one, K5b's group
    entry states and K5c's rows, transposed from the TPU's lane layout."""
    chain, ops, mfw, gains = _chain_inputs("lorenz", "kramer", 192, 1.92,
                                           seed=6)
    fused, q_const, W, tv = chain
    n_block, q, k, n_group = 3, 3, 64, 2
    k_star = gains[-1]
    th = ops["theta"][:, None].numpy()
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    all_gains = torch.cat([gains, k_star.expand(128, n_block, q)])
    ref_a = pl.pallas_call(
        functools.partial(pk._mean_gain_kernel, jlorenz.lorenz_flat, 192, q,
                          n_block, q_const, False),
        out_shape=jax.ShapeDtypeStruct((192, n_block, q), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_block, q)), _vmem((192, n_block, q)),
                  _vmem((n_block, q)), _vmem(th.shape), _vmem((192, 1)),
                  _vmem((1, q))],
        out_specs=_vmem((192, n_block, q)),
        scratch_shapes=[pltpu.VMEM((n_block, q), jnp.float32)],
        interpret=True,
    )(f32(W), f32(all_gains), f32(ops["x0"]), th, f32(ops["tgrid"])[:, None],
      f32(tv)[None])
    port_a = fk.mean_gain_chain(*chain, ops["x0"], ops["theta"],
                                ops["tgrid"], all_gains)
    assert _scaled_err(port_a, ref_a) <= KERNEL_TOL
    tail = ops["tgrid"][64:]
    ref_b = pl.pallas_call(
        functools.partial(pk._mean_boundary_kernel, jlorenz.lorenz_flat, k,
                          q, n_block, q_const),
        out_shape=jax.ShapeDtypeStruct((n_group, n_block, q), jnp.float32),
        grid=(n_group,),
        in_specs=[_vmem((n_block, q)), _vmem((n_block, q)),
                  _vmem((n_block, q)), _vmem(th.shape),
                  _vmem((n_group * k, 1)), _vmem((1, q))],
        out_specs=pl.BlockSpec((1, n_block, q), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((n_block, q), jnp.float32)],
        interpret=True,
    )(f32(W), f32(k_star), f32(mfw[-1]), th, f32(tail)[:, None],
      f32(tv)[None])
    port_b = fk.mean_boundary_chain(*chain, mfw[-1], ops["theta"], tail,
                                    k_star)
    assert _scaled_err(port_b, ref_b) <= KERNEL_TOL
    ref_c = pl.pallas_call(
        functools.partial(pk._mean_recovery_kernel, jlorenz.lorenz_flat, k,
                          q, n_block, n_group, q_const),
        out_shape=jax.ShapeDtypeStruct((k, q, n_block, n_group),
                                       jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_block, q)), _vmem((n_block, q)),
                  _vmem((q, n_block, n_group)), _vmem(th.shape),
                  _vmem((k, 1, n_group)), _vmem((1, q))],
        out_specs=_vmem((k, q, n_block, n_group)),
        interpret=True,
    )(f32(W), f32(k_star), f32(port_b.permute(2, 1, 0)), th,
      f32(tail.reshape(n_group, k).T)[:, None, :], f32(tv)[None])
    ref_c = np.transpose(np.asarray(ref_c), (3, 0, 2, 1)).reshape(
        n_group * k, n_block, q)
    port_c = fk.mean_recovery_chain(*chain, port_b, ops["theta"], tail,
                                    k_star)
    assert _scaled_err(port_c, ref_c) <= KERNEL_TOL


@pytest.mark.parametrize("n_steps,two_phase,schedule", [
    (191, True, (64, 1)),     # one group: K5a over all steps
    (192, True, (64, 2)),     # two groups: K5b and K5c
    (50, True, (50, 0)),      # N <= n_warm: K5a with n_warm = N
    (300, False, (64, 0)),    # two_phase=False: K5a
])
def test_stationary_matches_the_exact_solve(twin_calls, n_steps, two_phase,
                                            schedule):
    """At the schedule's boundaries, Lorenz63 EK1 at the step 0.01 against
    the port's own solve_mv_fused, at the JAX package's tolerance for the
    stationary path against the exact one."""
    t_max = 0.01 * n_steps
    _, tcfg, theta = _problem("lorenz", n_steps, t_max, seed=7)
    assert fk._stationary_schedule(n_steps, 64, two_phase) == schedule
    args = _port_args(tcfg, theta, t_max, n_steps)
    mean_s, var_s = rt.solve_mv_fused_stationary(
        *args, model="lorenz", two_phase=two_phase, device="cpu")
    k5a = schedule[1] < 2
    assert twin_calls == {"_mean_gain_plain": int(k5a),
                          "_mean_boundary_plain": int(not k5a),
                          "_mean_recovery_plain": int(not k5a)}
    mean_e, var_e = rt.solve_mv_fused(*args, model="lorenz", device="cpu")
    assert mean_s.shape == mean_e.shape and var_s.shape == var_e.shape
    np.testing.assert_allclose(mean_s[:, :, 0].numpy(),
                               mean_e[:, :, 0].numpy(), rtol=MEAN_TOL,
                               atol=MEAN_TOL)
    scale = var_e.abs().max().item()
    np.testing.assert_allclose((var_s / scale).numpy(),
                               (var_e / scale).numpy(), atol=VAR_TOL)


def test_the_schedule_at_the_solve_length():
    """The JAX package's schedule at 10 000 steps: 155 groups of 64 after an
    80-step prefix."""
    assert fk._stationary_schedule(10000, 64, True) == (80, 155)
    assert fk._stationary_schedule(10000, 64, False) == (64, 0)


@pytest.mark.parametrize("kwargs", [{"interrogation": "schober"},
                                    {"interrogation": "chkrebtii"}])
def test_stationary_raises_where_the_jax_package_does(kwargs):
    """schober and chkrebtii have no time-constant measurement row (the JAX
    package's reason)."""
    _, tcfg, theta = _problem("lorenz", 8, 0.08, seed=8)
    with pytest.raises(NotImplementedError):
        rt.solve_mv_fused_stationary(*_port_args(tcfg, theta, 0.08, 8),
                                     model="lorenz", device="cpu", **kwargs)


def _jax_stationary(jcfg, model, mode, theta, **kw):
    """The JAX package's stationary solve of one configuration (Pallas in
    interpret mode under jax.jit)."""
    jmod = JMODELS[model]
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    fn = jax.jit(lambda th: pk.solve_mv_fused_stationary(
        key=None, theta=th, ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=jac, interrogation=mode, **{**jcfg, **kw}))
    return tuple(np.asarray(a) for a in fn(jnp.asarray(theta)))


# The square-root form's factors square back to the standard form's
# covariances within SQRT_GRAM_TOL of the largest entry (float32).
SQRT_GRAM_TOL = 1e-5


def test_stationary_sqrt_matches_the_jax_package(twin_calls):
    """solve_mv_fused_stationary(kalman_type="sqrt"), Lorenz63 EK1 at N =
    200 (two-phase): the standard form's means on the squared factor,
    bitwise, and the lower factors of its dense covariances (chol_small),
    whose Grams are those covariances within SQRT_GRAM_TOL; against the
    JAX package's square-root stationary solve on the same float32 factor,
    means and Grams within SCALED_TOL."""
    jcfg, tcfg, theta = _problem("lorenz", 200, 2.0, seed=3)
    w, v = (np.array(a, np.float32) for a in jcfg.pop("prior_pars"))
    factor = np.linalg.cholesky(v.astype(np.float64)).astype(np.float32)
    mean_j, fac_j = _jax_stationary(
        jcfg, "lorenz", "kramer", theta, kalman_type="square-root",
        prior_pars=(jnp.asarray(w), jnp.asarray(factor)))
    args = _port_args(tcfg, theta, 2.0, 200)[:-1]
    pars_q = (torch.from_numpy(w), torch.from_numpy(factor))
    mean_q, fac_q = rt.solve_mv_fused_stationary(
        *args, pars_q, model="lorenz", kalman_type="sqrt", device="cpu")
    mean_s, var_s = rt.solve_mv_fused_stationary(
        *args, fk.normalize_prior_pars("sqrt", pars_q), model="lorenz",
        device="cpu")
    assert twin_calls["_mean_boundary_plain"] == 2
    assert torch.equal(mean_q, mean_s)
    assert fac_q.shape == var_s.shape == fac_j.shape
    assert torch.equal(fac_q.triu(1), torch.zeros_like(fac_q))
    gram = fac_q @ fac_q.mT
    assert (gram - var_s).abs().max() <= SQRT_GRAM_TOL * var_s.abs().max()
    gram_j = fac_j @ np.swapaxes(fac_j, -1, -2)
    for d in range(3):
        assert _scaled_err(mean_q[..., d], mean_j[..., d]) <= SCALED_TOL, d
        assert _scaled_err(gram[..., d, :], gram_j[..., d, :]) \
            <= SCALED_TOL, d


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 2.56),
                                              ("fitzhugh", "rodeo", 12.8)])
def test_stationary_non_ibm_prior_matches_the_jax_package(twin_calls, model,
                                                          mode, t_max):
    """A block-constant prior that is not IBM (IBM's weight with its last
    diagonal entry x 0.9 in every block: a scaled transition that is not
    unit upper-triangular), 256 steps: a 64-step prefix and three 64-step
    tail groups through the twins of K5b and K5c, against the JAX package's
    stationary solve on the same prior, within SCALED_TOL."""
    jcfg, tcfg, theta = _problem(model, 256, t_max, seed=9)
    w_j, v_j = jcfg.pop("prior_pars")
    w_j = np.array(w_j, np.float32)
    w_j[:, 2, 2] *= np.float32(0.9)
    mean_j, var_j = _jax_stationary(jcfg, model, mode, theta,
                                    prior_pars=(jnp.asarray(w_j), v_j))
    w, v = tcfg["prior_pars"]
    assert np.array_equal(w.numpy()[:, 2, 2] * np.float32(0.9),
                          w_j[:, 2, 2])
    assert fk._stationary_schedule(256, 64, True) == (64, 3)
    mean_t, var_t = rt.solve_mv_fused_stationary(
        *_port_args(tcfg, theta, t_max, 256)[:-1], (torch.from_numpy(w_j), v),
        model=model, interrogation=mode, device="cpu")
    assert twin_calls == {"_mean_gain_plain": 0, "_mean_boundary_plain": 1,
                          "_mean_recovery_plain": 1}
    assert torch.isfinite(mean_t).all() and torch.isfinite(var_t).all()
    for d in range(3):
        assert _scaled_err(mean_t[..., d], mean_j[..., d]) <= SCALED_TOL, d
        assert _scaled_err(var_t[..., d, :], var_j[..., d, :]) \
            <= SCALED_TOL, d

