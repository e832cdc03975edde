"""
Parity of the port's MAGI (rodeo_tpu_torch.inference.magi_logdens,
rodeo_tpu_torch.ops.precond.magi_logdens and rodeo_tpu_torch.ops.fused_magi)
with the JAX package, whose Pallas kernels run here in interpret mode.

The path is the cached float64 Lorenz63 solve of bench.py
(``.bench_ref_v8.npz["solve_mu_4k"]``, dt = 0.005) plus seeded roughness,
and the prior's process noise is scaled by 1e-5, as in the JAX package's
tests: the Lorenz63 prior (sigma 5e7) is so diffuse that the log-density is
nearly flat in the path otherwise.

On the CPU the fused entry points take the plain PyTorch twins of kernels
K10a (magi_batch) and K10b (magi_adjoint_batch).  Measured over these runs:

- the float64 torch-ops against the JAX package's: <= 3.6e-15 relative in
  value and <= 1.8e-14 of the largest gradient entry; tolerances 1e-10 and
  1e-8;
- the float32 twins against the JAX package's fused path: <= 6.1e-6
  relative in value and <= 7.2e-6 in the gradient rule
  max|g - g_ref| / (max|g_ref| + 1); against the float64 torch-op <= 5.0e-6
  and <= 1.2e-5; the JAX test's tolerance, 2e-4, for all (the twin adds
  each block's sum over the steps, the JAX kernel the blocks at every step,
  so the two round differently);
- the twins at 4000 steps against the float64 torch-op: <= 5.2e-6 relative
  in value and <= 1.7e-5 in the gradient rule; tolerance 2e-4, the limit
  that chip_smoke.py holds the card to.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from pathlib import Path

from rodeo_tpu.inference import magi_logdens as j_magi_logdens
from rodeo_tpu.models import lorenz as jlorenz
from rodeo_tpu.ops import pallas_magi as jm
from rodeo_tpu.ops import precond as jprecond

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.inference import magi_logdens as t_magi_logdens
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_magi as fm
from rodeo_tpu_torch.ops import precond as tprecond

TRUTH = Path(__file__).resolve().parents[1] / ".bench_ref_v8.npz"
DT = 0.005
N_STEPS = 200
# the float64 torch-ops against the JAX package's
F64_VALUE_RTOL = 1e-10
F64_GRAD_TOL = 1e-8
# the float32 twins: the JAX package's rule (tests/test_pallas_magi.py)
F32_RTOL = 2e-4


@pytest.fixture(scope="module")
def truth_path():
    return np.load(TRUTH)["solve_mu_4k"]


def _prior(n_steps, var_scale=1e-5):
    """The Lorenz63 prior of the JAX package at step DT, float64 numpy, its
    process noise scaled by var_scale."""
    cfg = jlorenz.setup(n_steps=n_steps, t_max=n_steps * DT,
                        dtype=jnp.float64)
    wgt, var = cfg["prior_pars"]
    return np.asarray(wgt), np.asarray(var) * var_scale


def _rough(path, n_lane, scale, seed):
    """Lane i: the first two derivatives of path plus scale (i + 1) times
    seeded standard normals."""
    base = path[:, :, :2]
    rng = np.random.default_rng(seed)
    return np.stack([base + scale * (i + 1) * rng.normal(size=base.shape)
                     for i in range(n_lane)])


def j_expand(u, **p):
    return jnp.concatenate([u, jnp.zeros(u.shape[:-1] + (1,), u.dtype)], -1)


def t_expand(u, **p):
    return torch.cat([u, torch.zeros_like(u[..., :1])], -1)


def j_expand_th(u, theta, **p):
    # theta scales an active row, so its gradient flows through every step
    return jnp.concatenate(
        [u[..., :1], theta * u[..., 1:2], jnp.zeros_like(u[..., :1])], -1)


def t_expand_th(u, theta, **p):
    return torch.cat([u[..., :1], theta * u[..., 1:2],
                      torch.zeros_like(u[..., :1])], -1)


def _j_prior(prior):
    return tuple(jnp.asarray(p) for p in prior)


def _t_prior(prior, dtype=torch.float64):
    return tuple(torch.tensor(p, dtype=dtype) for p in prior)


def _f64_lanes(act, prior, subs, var_scales=None, expand=None):
    """Value and path gradient of the float64 torch-op
    ``ops.precond.magi_logdens`` for each lane of subs, its process noise
    scaled per lane by var_scales, under ``torch.func.vmap`` on one thread
    (the reference's operations are tiny)."""
    wgt, var = _t_prior(prior)
    scales = torch.ones(len(subs), dtype=torch.float64) if var_scales is None \
        else torch.tensor(var_scales, dtype=torch.float64)
    fn = lambda u, s: tprecond.magi_logdens(u, expand or t_expand, act,
                                            (wgt, var * s), DT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.func.vmap(torch.func.grad_and_value(fn))(
            torch.tensor(subs, dtype=torch.float64), scales)
    finally:
        torch.set_num_threads(threads)


def _rel_err(ld, ref):
    """The largest relative error over the lanes."""
    ld, ref = np.asarray(ld, np.float64), np.asarray(ref, np.float64)
    return np.abs((ld - ref) / ref).max()


def _grad_err(g, g_ref):
    """The JAX package's gradient rule: max|g - g_ref| / (max|g_ref| + 1)."""
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    return np.abs(g - g_ref).max() / (np.abs(g_ref).max() + 1.0)


# --- the float64 torch-ops ----------------------------------------------------------


@pytest.mark.parametrize("act", [1, 2, 3])
@pytest.mark.parametrize("form", ["inference", "precond"])
def test_torch_op_matches_jax(truth_path, form, act):
    """The sequential torch-op (plain, or on the Taylor-scaled state) and its
    torch.autograd gradient against the JAX package's value and jax.grad,
    float64, 200 steps."""
    prior = _prior(N_STEPS)
    u = _rough(truth_path[:N_STEPS + 1], 1, 0.1, 3)[0]
    if form == "inference":
        j_fn = lambda x: j_magi_logdens(x, j_expand, act, _j_prior(prior),
                                        "standard")
        t_fn = lambda x: t_magi_logdens(x, t_expand, act, _t_prior(prior),
                                        "standard")
    else:
        j_fn = lambda x: jprecond.magi_logdens(x, j_expand, act,
                                               _j_prior(prior), DT)
        t_fn = lambda x: tprecond.magi_logdens(x, t_expand, act,
                                               _t_prior(prior), DT)
    ref, g_ref = jax.value_and_grad(j_fn)(jnp.asarray(u))
    u_t = torch.tensor(u, requires_grad=True)
    val = t_fn(u_t)
    g, = torch.autograd.grad(val, u_t)
    assert val.dtype == torch.float64
    assert abs(val.item() - float(ref)) <= F64_VALUE_RTOL * abs(float(ref))
    g_ref = np.asarray(g_ref)
    assert np.abs(g.numpy() - g_ref).max() <= F64_GRAD_TOL * \
        np.abs(g_ref).max()


@pytest.mark.parametrize("kwargs", [
    {"temporal": "parallel"}, {"temporal": "bogus"},
    {"kalman_type": "square-root"}, {"kalman_type": "bogus"}])
def test_unported_modes_raise(truth_path, kwargs):
    prior = _t_prior(_prior(10))
    u = torch.tensor(truth_path[:11, :, :2])
    call = {"kalman_type": "standard", **kwargs}
    with pytest.raises(NotImplementedError):
        t_magi_logdens(u, t_expand, 2, prior, **call)
    if "temporal" not in kwargs:
        with pytest.raises(NotImplementedError):
            tprecond.magi_logdens(u, t_expand, 2, prior, DT, **kwargs)


# --- the twins against the JAX package's fused path ---------------------------------


@pytest.mark.parametrize("act", [1, 2, 3])
@pytest.mark.parametrize("sig2", [False, True])
def test_fused_batch_matches_jax(truth_path, act, sig2):
    """magi_fused_batch(device="cpu") (K10a's twin) against the JAX
    package's magi_fused_batch in interpret mode: 200 steps x 4 lanes."""
    prior = _prior(N_STEPS)
    subs = _rough(truth_path[:N_STEPS + 1], 4, 0.2, 7)
    s2 = np.array([0.5, 1.0, 2.0, 4.0]) if sig2 else None
    ref = np.asarray(jm.magi_fused_batch(
        jnp.asarray(subs), j_expand, act, _j_prior(prior), DT,
        sig2_lanes=None if s2 is None else jnp.asarray(s2)))
    ld = rt.magi_fused_batch(torch.tensor(subs), t_expand, act,
                             _t_prior(prior), DT, sig2_lanes=s2,
                             device="cpu")
    assert ld.shape == (4,) and ld.dtype == torch.float32
    assert _rel_err(ld, ref) <= F32_RTOL
    # the rough lanes separate
    assert np.std(ref) > 100.0


@pytest.mark.parametrize("act,sig2", [(1, False), (2, False), (3, False),
                                      (2, True)])
def test_fused_grad_matches_jax_and_torch_op(truth_path, act, sig2):
    """magi_fused_batch_grad(device="cpu") (K10a's and K10b's twins) against
    the JAX package's magi_fused_batch_grad and against torch.autograd of
    the float64 torch-op, per lane: 200 steps x 3 lanes."""
    prior = _prior(N_STEPS)
    subs = _rough(truth_path[:N_STEPS + 1], 3, 0.1, 3)
    s2 = np.array([0.25, 1.0, 4.0]) if sig2 else None
    ld, g = rt.magi_fused_batch_grad(torch.tensor(subs), t_expand, act,
                                     _t_prior(prior), DT, sig2_lanes=s2,
                                     device="cpu")
    assert g.shape == subs.shape and g.dtype == torch.float64
    ld_j, g_j = jm.magi_fused_batch_grad(
        jnp.asarray(subs), j_expand, act, _j_prior(prior), DT,
        sig2_lanes=None if s2 is None else jnp.asarray(s2))
    assert _rel_err(ld, ld_j) <= F32_RTOL
    assert _grad_err(g, g_j) <= F32_RTOL
    g_ref, val = _f64_lanes(act, prior, subs, s2)
    for i in range(3):
        assert abs(ld[i].item() - val[i].item()) <= F32_RTOL * \
            abs(val[i].item())
        assert _grad_err(g[i], g_ref[i]) <= F32_RTOL


def test_fused_grad_theta_lanes(truth_path):
    """The gradient in per-lane parameters of ode_expand: the path gradient
    and the value against the JAX package's, and the theta gradient against
    the float64 torch-op's within the JAX test's rule.  That gradient is a
    cancelling sum of the float32 path gradient, so the tolerance scales
    with its uncancelled mass |dL/du1 . u1| / theta.  (On this path the JAX
    package's own float32 theta gradient of lane 1 lands 0.100 from the
    float64 value, beyond its rule's 0.075; the port's lands 0.051.)"""
    prior = _prior(N_STEPS)
    base = truth_path[:N_STEPS + 1, :, :2]
    subs = np.broadcast_to(base, (3,) + base.shape).copy()
    thetas = np.array([0.5, 1.0, 1.5])
    ld, g_u, g_th = rt.magi_fused_batch_grad(
        torch.tensor(subs), t_expand_th, 2, _t_prior(prior), DT,
        theta_lanes=torch.tensor(thetas), device="cpu")
    assert g_u.shape == subs.shape and g_th.shape == thetas.shape
    ld_j, g_u_j, _ = jm.magi_fused_batch_grad(
        jnp.asarray(subs), j_expand_th, 2, _j_prior(prior), DT,
        theta_lanes=jnp.asarray(thetas))
    assert _rel_err(ld, ld_j) <= F32_RTOL
    assert _grad_err(g_u, g_u_j) <= F32_RTOL
    for i in range(3):
        th = torch.tensor(thetas[i], requires_grad=True)
        val = tprecond.magi_logdens(torch.tensor(subs[i]), t_expand_th, 2,
                                    _t_prior(prior), DT, theta=th)
        g_ref, = torch.autograd.grad(val, th)
        assert abs(ld[i].item() - val.item()) <= F32_RTOL * abs(val.item())
        mass = (g_u[i][..., 1] * torch.tensor(subs[i][..., 1])).abs().sum() \
            .item() / thetas[i]
        assert abs(g_th[i].item() - g_ref.item()) < 1e-2 * (mass + 1.0)


def test_fused_grad_theta_lanes_pytree(truth_path):
    """theta_lanes as a pytree, as the JAX package takes it: a dict of
    per-lane leaves reaches ode_expand as a dict, and grad_theta comes back
    as a dict.  Its values are those of the same function of one stacked
    tensor, bitwise, and the JAX package's pytree gradient within the rule
    of test_fused_grad_theta_lanes (each leaf's uncancelled mass)."""
    prior = _prior(N_STEPS)
    base = truth_path[:N_STEPS + 1, :, :2]
    subs = np.broadcast_to(base, (3,) + base.shape).copy()
    lanes = {"scale": np.array([0.5, 1.0, 1.5]),
             "shift": np.array([0.0, 0.05, -0.05])}

    def t_expand_ab(u, theta, **p):
        return torch.cat([u[..., :1] + theta["shift"],
                          theta["scale"] * u[..., 1:2],
                          torch.zeros_like(u[..., :1])], -1)

    def t_expand_stacked(u, theta, **p):
        return t_expand_ab(u, {"scale": theta[0], "shift": theta[1]})

    def j_expand_ab(u, theta, **p):
        return jnp.concatenate([u[..., :1] + theta["shift"],
                                theta["scale"] * u[..., 1:2],
                                jnp.zeros_like(u[..., :1])], -1)

    args = (torch.tensor(subs), 2, _t_prior(prior), DT)
    ld, g_u, g_th = rt.magi_fused_batch_grad(
        args[0], t_expand_ab, *args[1:],
        theta_lanes={k: torch.tensor(v) for k, v in lanes.items()},
        device="cpu")
    assert isinstance(g_th, dict) and sorted(g_th) == ["scale", "shift"]
    ld_s, g_u_s, g_th_s = rt.magi_fused_batch_grad(
        args[0], t_expand_stacked, *args[1:],
        theta_lanes=torch.tensor(np.stack([lanes["scale"], lanes["shift"]],
                                          -1)), device="cpu")
    assert torch.equal(ld, ld_s) and torch.equal(g_u, g_u_s)
    assert torch.equal(g_th["scale"], g_th_s[:, 0])
    assert torch.equal(g_th["shift"], g_th_s[:, 1])
    ld_j, g_u_j, g_th_j = jm.magi_fused_batch_grad(
        jnp.asarray(subs), j_expand_ab, 2, _j_prior(prior), DT,
        theta_lanes={k: jnp.asarray(v) for k, v in lanes.items()})
    assert _rel_err(ld, ld_j) <= F32_RTOL
    assert _grad_err(g_u, g_u_j) <= F32_RTOL
    for i in range(3):
        masses = {"scale": (g_u[i][..., 1] * torch.tensor(subs[i][..., 1]))
                  .abs().sum().item() / lanes["scale"][i],
                  "shift": g_u[i][..., 0].abs().sum().item()}
        for name, mass in masses.items():
            err = abs(g_th[name][i].item() - float(g_th_j[name][i]))
            assert err < 1e-2 * (mass + 1.0), (name, i)


@pytest.mark.parametrize("act", [1, 2, 3])
def test_grad_values_equal_value_call(truth_path, act):
    """The gradient call's log-density is the value call's, bitwise: K10a
    with the adjoint streams does the same operations."""
    prior = _t_prior(_prior(N_STEPS))
    subs = torch.tensor(_rough(truth_path[:N_STEPS + 1], 3, 0.1, 5),
                        dtype=torch.float32)
    ld = rt.magi_fused_batch(subs, t_expand, act, prior, DT, device="cpu")
    ld_g, _ = rt.magi_fused_batch_grad(subs, t_expand, act, prior, DT,
                                       device="cpu")
    assert torch.equal(ld, ld_g)


def test_backward_equals_grad_entry(truth_path):
    """.backward() through MagiLogdens gives magi_fused_batch_grad's
    gradient, each lane scaled by its grad_output."""
    prior = _t_prior(_prior(N_STEPS))
    subs = torch.tensor(_rough(truth_path[:N_STEPS + 1], 3, 0.1, 5),
                        dtype=torch.float32)
    _, g = rt.magi_fused_batch_grad(subs, t_expand, 2, prior, DT,
                                    device="cpu")
    u = subs.clone().requires_grad_(True)
    rt.magi_fused_batch(u, t_expand, 2, prior, DT, device="cpu").sum() \
        .backward()
    assert torch.equal(u.grad, g)
    w = torch.tensor([0.5, -2.0, 3.0])
    u.grad = None
    (w * rt.magi_fused_batch(u, t_expand, 2, prior, DT,
                             device="cpu")).sum().backward()
    assert torch.equal(u.grad, w[:, None, None, None] * g)


def test_twin_gradient_at_4000_steps(truth_path):
    """The twins on chip_smoke.py's informative fixture (the truth path plus
    0.1 (i + 1) rng(3) normals, 4000 steps, 2 lanes) meet the 2e-4 rule
    against the float64 torch-op in float32 on the CPU, so that the card's
    limit is attainable."""
    prior = _prior(4000)
    subs = _rough(truth_path, 2, 0.1, 3)
    ld, g = rt.magi_fused_batch_grad(torch.tensor(subs, dtype=torch.float32),
                                     t_expand, 2, _t_prior(prior), DT,
                                     device="cpu")
    g_ref, val = _f64_lanes(2, prior, subs)
    for i in range(2):
        assert abs(ld[i].item() - val[i].item()) <= F32_RTOL * \
            abs(val[i].item())
        assert _grad_err(g[i], g_ref[i]) <= F32_RTOL


@pytest.mark.parametrize("case", ["act_above_3", "blockwise_prior"])
def test_kernel_path_errors(truth_path, case):
    """n_active above 3 and a transition that differs across blocks are not
    ported to the kernels, and raise."""
    wgt, var = _prior(10)
    subs = torch.tensor(_rough(truth_path[:11], 2, 0.1, 1))
    if case == "act_above_3":
        # a 5-derivative state, 4 of them active
        expand = lambda u, **p: torch.cat([u, u, torch.zeros_like(u[..., :1])],
                                          -1)
        q5 = np.broadcast_to(np.eye(5), (3, 5, 5)).copy()
        prior = _t_prior((q5, q5))
        with pytest.raises(NotImplementedError, match="n_active <= 3"):
            rt.magi_fused_batch(subs, expand, 4, prior, DT, device="cpu")
    else:
        wgt = wgt.copy()
        wgt[1] = 2.0 * wgt[1]
        with pytest.raises(NotImplementedError, match="same transition"):
            rt.magi_fused_batch(subs, t_expand, 2, _t_prior((wgt, var)), DT,
                                device="cpu")


def test_wrappers_reject_bad_operands():
    """K10a's and K10b's wrappers check shapes and types before a launch."""
    q_const = fk._static_scaled_qconst(
        torch.tensor(_prior(4)[0]), DT, 3)
    x = torch.zeros((4, 2, 3, 5))
    R = torch.ones((6, 3, 1))
    m0 = torch.zeros((3, 3, 5))
    with pytest.raises(ValueError, match="emit"):
        fm.magi_filter_batch(x, R, m0, q_const, emit="states")
    with pytest.raises(ValueError, match="lanes"):
        fm.magi_filter_batch(x, torch.ones((6, 3, 2)), m0, q_const)
    with pytest.raises(TypeError, match="float32"):
        fm.magi_filter_batch(x.double(), R, m0, q_const)
    with pytest.raises(ValueError, match="G is needed"):
        fm.magi_adjoint_batch(x, torch.zeros((4, 3, 3, 5)), None, q_const)
