"""
Parity of the PyTorch port's building blocks (rodeo_tpu_torch: utils, prior,
kalmantv, interrogate, models, precond scaling, convert) with the JAX
package at float64 on the CPU, and the port's import rule.

Inputs are made with numpy from a seed and handed to both packages.  Unless
a test says otherwise the two compute the same float64 formulas with
different kernels (XLA vs ATen), so they agree to a few ulps: rtol 1e-12.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rodeo_tpu.utils as jutils
import rodeo_tpu.interrogate as jinterrogate
from rodeo_tpu.kalmantv import standard as jstandard
from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.ops.linalg import fast_linalg
from rodeo_tpu.prior import ibm_init as jibm_init

import rodeo_tpu_torch.utils as tutils
import rodeo_tpu_torch.interrogate as tinterrogate
from rodeo_tpu_torch.convert import from_numpy
from rodeo_tpu_torch.kalmantv import get_backend, standard as tstandard
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import precond as tprecond
from rodeo_tpu_torch.ops.linalg import fast_linalg as tfast_linalg
from rodeo_tpu_torch.ops.linalg import full_matmul_precision
from rodeo_tpu_torch.prior import ibm_init as tibm_init

RTOL = 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _psd(rng, *shape):
    a = rng.standard_normal(shape + (shape[-1],))
    return a @ np.swapaxes(a, -1, -2) + shape[-1] * np.eye(shape[-1])


def test_matrix_helpers_match_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 3, 3))
    v = rng.standard_normal((4, 3))
    V = _psd(rng, 4, 3)
    _close(tutils.mtt(_t(A)), jutils.mtt(A))
    _close(tutils.mvdot(_t(A), _t(v)), jutils.mvdot(A, v))
    _close(tutils.quadform(_t(A), _t(V)), jutils.quadform(A, V))
    # LU solves of a well-conditioned system: ~1e-15 apart
    _close(tutils.solve_var(_t(V), _t(A)), jutils.solve_var(V, A), rtol=1e-10)
    _close(tutils.solve_var(_t(V), _t(v)), jutils.solve_var(V, v), rtol=1e-10)


def test_first_order_pad_matches_jax():
    theta = np.array(jlorenz.THETA)
    Wj, padj = jutils.first_order_pad(jlorenz.lorenz_fun, 3, 4)
    Wt, padt = tutils.first_order_pad(tlorenz.lorenz_fun, 3, 4,
                                      dtype=torch.float64)
    x0 = np.array(jlorenz.X0)
    _close(Wt, Wj, rtol=0)
    _close(padt(_t(x0), 0.0, theta=_t(theta)),
           padj(jnp.asarray(x0), 0.0, theta=jnp.asarray(theta)))


@pytest.mark.parametrize("n_deriv", [2, 3, 4])
def test_ibm_init_matches_jax(n_deriv):
    sigma = np.array([0.5, 2.0, 5e7])
    for dt in (0.1, 0.002, 1.0 / 3.0):
        Qt, Rt = tibm_init(dt, n_deriv, _t(sigma))
        Qj, Rj = jibm_init(dt, n_deriv, jnp.asarray(sigma))
        _close(Qt, Qj)
        _close(Rt, Rj)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_taylor_scale_is_the_jax_numbers(dtype):
    """The fused kernels' scaling must be the same floats as in JAX."""
    for n_steps, t_max in ((200, 2.0), (10000, 20.0), (800, 10.0)):
        for n_deriv in (3, 4):
            dt = t_max / n_steps
            tv = tprecond.taylor_scale(dt, n_deriv,
                                       dtype=getattr(torch, dtype))
            ref = jprecond.taylor_scale(dt, n_deriv,
                                        dtype=getattr(jnp, dtype))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(ref))


def test_scale_prior_matches_jax():
    dt = 0.01
    Q, R = jibm_init(dt, 3, jnp.asarray([5e7, 1.0, 0.1]))
    tv = jprecond.taylor_scale(dt, 3, dtype=jnp.float64)
    Qt, Rt = tprecond.scale_prior((_t(Q), _t(R)), _t(tv))
    Qj, Rj = jprecond.scale_prior((Q, R), tv)
    _close(Qt, Qj)
    _close(Rt, Rj)


@pytest.fixture(scope="module")
def kalman_inputs():
    rng = np.random.default_rng(1)
    nb, q = 3, 3
    return dict(
        mean_past=rng.standard_normal((nb, q)),
        var_past=_psd(rng, nb, q),
        mean_state=rng.standard_normal((nb, q)),
        wgt_state=rng.standard_normal((nb, q, q)),
        var_state=_psd(rng, nb, q),
        x_meas=rng.standard_normal((nb, 1)),
        mean_meas=rng.standard_normal((nb, 1)),
        wgt_meas=rng.standard_normal((nb, 1, q)),
        var_meas=_psd(rng, nb, 1),
        mean_next=rng.standard_normal((nb, q)),
        var_next=_psd(rng, nb, q),
        mean_filt=rng.standard_normal((5, nb, q)),
        var_filt=_psd(rng, 5, nb, q),
        mean_pred=rng.standard_normal((5, nb, q)),
        var_pred=_psd(rng, 5, nb, q),
    )


def test_kalman_predict_update_forecast_match_jax(kalman_inputs):
    k = kalman_inputs
    kt = {n: _t(a) for n, a in k.items()}
    pred_t = tstandard.predict(kt["mean_past"], kt["var_past"],
                               kt["mean_state"], kt["wgt_state"],
                               kt["var_state"])
    pred_j = jstandard.predict(k["mean_past"], k["var_past"],
                               k["mean_state"], k["wgt_state"],
                               k["var_state"])
    for a, b in zip(pred_t, pred_j):
        _close(a, b)
    # the port's update is the Joseph form: compare with JAX's Joseph form
    # (solves in the update: 1e-10)
    upd_t = tstandard.update(pred_t[0], pred_t[1], kt["x_meas"],
                             kt["mean_meas"], kt["wgt_meas"], kt["var_meas"])
    upd_j = jstandard.update(pred_j[0], pred_j[1], k["x_meas"],
                             k["mean_meas"], k["wgt_meas"], k["var_meas"],
                             joseph=True)
    for a, b in zip(upd_t, upd_j):
        _close(a, b, rtol=1e-10)
    fc_t = tstandard.forecast(pred_t[0], pred_t[1], kt["mean_meas"],
                              kt["wgt_meas"], kt["var_meas"])
    fc_j = jstandard.forecast(pred_j[0], pred_j[1], k["mean_meas"],
                              k["wgt_meas"], k["var_meas"])
    for a, b in zip(fc_t, fc_j):
        _close(a, b)


@pytest.mark.parametrize("joseph", [True, False, None])
def test_update_joseph_forms_match_jax(kalman_inputs, joseph):
    """``update`` with the JAX package's ``joseph=`` keyword, called with the
    argument list of the JAX package's MAGI filter: True and False select
    the Joseph and the subtractive form as there, and None defers to the
    fast-linalg switch in both packages (off here: the subtractive form).
    Both solve the same float64 system: 1e-10."""
    k = kalman_inputs
    kt = {n: _t(a) for n, a in k.items()}
    pred_t = tstandard.predict(kt["mean_past"], kt["var_past"],
                               kt["mean_state"], kt["wgt_state"],
                               kt["var_state"])
    pred_j = jstandard.predict(k["mean_past"], k["var_past"],
                               k["mean_state"], k["wgt_state"],
                               k["var_state"])
    upd_t = tstandard.update(
        mean_state_pred=pred_t[0], var_state_pred=pred_t[1],
        x_meas=kt["x_meas"], mean_meas=kt["mean_meas"],
        wgt_meas=kt["wgt_meas"], var_meas=kt["var_meas"], joseph=joseph)
    upd_j = jstandard.update(
        mean_state_pred=pred_j[0], var_state_pred=pred_j[1],
        x_meas=k["x_meas"], mean_meas=k["mean_meas"],
        wgt_meas=k["wgt_meas"], var_meas=k["var_meas"], joseph=joseph)
    for a, b in zip(upd_t, upd_j):
        _close(a, b, rtol=1e-10)
    if joseph is False:     # the two forms differ by rounding only
        joseph_t = tstandard.update(*pred_t, kt["x_meas"], kt["mean_meas"],
                                    kt["wgt_meas"], kt["var_meas"],
                                    joseph=True)
        assert not torch.equal(upd_t[1], joseph_t[1])
        _close(upd_t[1], joseph_t[1], rtol=1e-10)


def test_kalman_smoothers_match_jax(kalman_inputs):
    k = kalman_inputs
    kt = {n: _t(a) for n, a in k.items()}
    args = ("mean_filt", "var_filt", "mean_pred", "var_pred")
    # both take the Joseph form of the conditional variance and the
    # closed-form inverse under fast_linalg: 1e-10
    with fast_linalg(), tfast_linalg():
        cond_j = jstandard.smooth_cond(*(k[a] for a in args),
                                       wgt_state=k["wgt_state"],
                                       var_state=k["var_state"])
        cond_t = tstandard.smooth_cond(*(kt[a] for a in args),
                                       wgt_state=kt["wgt_state"],
                                       var_state=kt["var_state"])
    for a, b in zip(cond_t, cond_j):
        _close(a, b, rtol=1e-10, atol=1e-12)
    mv_t = tstandard.smooth_mv(kt["mean_next"], kt["var_next"],
                               *(kt[a][0] for a in args), kt["wgt_state"])
    mv_j = jstandard.smooth_mv(k["mean_next"], k["var_next"],
                               *(k[a][0] for a in args), k["wgt_state"])
    for a, b in zip(mv_t, mv_j):
        _close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kalman_type", ["square-root", "bogus"])
def test_get_backend_raises_for_unported(kalman_type):
    with pytest.raises(NotImplementedError):
        get_backend(kalman_type)


@pytest.mark.parametrize("name", ["rodeo", "schober", "kramer"])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_interrogations_match_jax(name, model):
    jmod, tmod = {"lorenz": (jlorenz, tlorenz),
                  "fitzhugh": (jfitzhugh, tfitzhugh)}[model]
    jfun = getattr(jmod, f"{model}_fun")
    tfun = getattr(tmod, f"{model}_fun")
    rng = np.random.default_rng(2)
    nb = jmod.N_VARS
    W = np.zeros((nb, 1, 3))
    W[:, :, 1] = 1.0
    mean = rng.standard_normal((nb, 3))
    var = _psd(rng, nb, 3)
    theta = np.array(jmod.THETA)
    out_j = getattr(jinterrogate, f"interrogate_{name}")(
        key=None, ode_fun=jfun, ode_weight=W, t=0.5, mean_state_pred=mean,
        var_state_pred=var, theta=theta)
    out_t = getattr(tinterrogate, f"interrogate_{name}")(
        key=None, ode_fun=tfun, ode_weight=_t(W), t=0.5, mean_state_pred=_t(mean),
        var_state_pred=_t(var), theta=_t(theta))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-14)


def _sine_fun(X_t, t, theta):
    """An ODE with an operation (sin) that the Dual numbers do not have."""
    return torch.stack([theta[0] * torch.sin(X_t[1, 0]),
                        -theta[1] * X_t[0, 0] * X_t[1, 0]])[:, None]


def _sine_fun_jax(X_t, t, theta):
    return jnp.stack([theta[0] * jnp.sin(X_t[1, 0]),
                      -theta[1] * X_t[0, 0] * X_t[1, 0]])[:, None]


def _lorenz_rows(X_t, theta, stack):
    x, y, z = X_t[0, 0], X_t[1, 0], X_t[2, 0]
    return stack([theta[0] * (y - x), x * (theta[1] - z) - y,
                  x * y - theta[2] * z])


def _unsqueeze_fun(X_t, t, theta):
    """Lorenz63 with a tensor method (``unsqueeze``) that Duals lack."""
    return _lorenz_rows(X_t, theta, torch.stack).unsqueeze(-1)


def _dtype_fun(X_t, t, theta):
    """Lorenz63 reading the state's ``dtype``, which Duals lack."""
    half = torch.tensor(0.5, dtype=X_t.dtype)
    return _lorenz_rows(X_t, theta, torch.stack)[:, None] * half


def _lorenz_rows_jax(X_t, t, theta, scale=1.0):
    return _lorenz_rows(X_t, theta, jnp.stack)[:, None] * scale


def _broadcast_fun(X_t, t, theta):
    """A parameter ``theta (k, 3, 1)`` that broadcasts the state to a new
    leading axis, summed over it: on a Dual the tangents raise (k = 2) or
    come out short of one axis (k = 9, the state's entries)."""
    y = theta * X_t[:, 1:2] * X_t[:, 0:1]
    return sum(y[i] for i in range(len(theta)))


_JACOBIAN_MODELS = {
    "sine": (_sine_fun, _sine_fun_jax, lambda rng: np.array([0.7, 1.3]), 2),
    "unsqueeze": (_unsqueeze_fun, _lorenz_rows_jax,
                  lambda rng: np.array(jlorenz.THETA), 3),
    "dtype": (_dtype_fun,
              lambda X_t, t, theta: _lorenz_rows_jax(X_t, t, theta, 0.5),
              lambda rng: np.array(jlorenz.THETA), 3),
    "broadcast2": (_broadcast_fun, _broadcast_fun,
                   lambda rng: rng.standard_normal((2, 3, 1)), 3),
    "broadcast9": (_broadcast_fun, _broadcast_fun,
                   lambda rng: rng.standard_normal((9, 3, 1)), 3),
}


@pytest.mark.parametrize("model", ["lorenz", "fitzhugh", "sine", "unsqueeze",
                                   "dtype", "broadcast2", "broadcast9"])
def test_kramer_jacobian_paths_agree(model):
    """interrogate_kramer's Jacobian: forward mode on Duals where the Dual
    pass carries the ODE (lorenz, fitzhugh), torch.func.jacfwd otherwise
    (an operation, a tensor method or an attribute that Duals lack, a
    parameter that broadcasts the state), each against torch.func.jacfwd
    in value and in its torch.autograd gradient, and the interrogation
    against the JAX package's."""
    from rodeo_tpu_torch.interrogate import _dual_jacobian, _eval_and_jacobian
    rng = np.random.default_rng(9)
    if model in _JACOBIAN_MODELS:
        tfun, jfun, make_theta, nb = _JACOBIAN_MODELS[model]
        theta_np = make_theta(rng)
    else:
        jmod, tmod = {"lorenz": (jlorenz, tlorenz),
                      "fitzhugh": (jfitzhugh, tfitzhugh)}[model]
        jfun = getattr(jmod, f"{model}_fun")
        tfun = getattr(tmod, f"{model}_fun")
        theta_np, nb = np.array(jmod.THETA), jmod.N_VARS
    mean = rng.standard_normal((nb, 3))
    x = _t(mean).requires_grad_(True)
    theta = _t(theta_np).requires_grad_(True)
    dual = _dual_jacobian(tfun, x, 0.5, dict(theta=theta))
    assert (dual is None) == (model in _JACOBIAN_MODELS)
    ref = torch.func.jacfwd(lambda y: tfun(y, 0.5, theta=theta))(x)
    assert ref.shape == (nb, 1, nb, 3)
    (g_ref,) = torch.autograd.grad((ref ** 2).sum(), theta)
    f_ref = tfun(x, 0.5, theta=theta)
    (gf_ref,) = torch.autograd.grad(f_ref.sum(), theta)
    for fun, jac in [_eval_and_jacobian(tfun, x, 0.5, dict(theta=theta))] + (
            [] if dual is None else [dual]):
        _close(fun.detach(), f_ref.detach())
        _close(jac.detach(), ref.detach(), atol=1e-14)
        (g,) = torch.autograd.grad((jac ** 2).sum(), theta,
                                   retain_graph=True)
        _close(g, g_ref, atol=1e-13)
        (gf,) = torch.autograd.grad(fun.sum(), theta)
        _close(gf, gf_ref, atol=1e-13)
    W = np.zeros((nb, 1, 3))
    W[:, :, 1] = 1.0
    var = _psd(rng, nb, 3)
    out_j = jinterrogate.interrogate_kramer(
        key=None, ode_fun=jfun, ode_weight=W, t=0.5, mean_state_pred=mean,
        var_state_pred=var, theta=theta_np)
    out_t = tinterrogate.interrogate_kramer(
        key=None, ode_fun=tfun, ode_weight=_t(W), t=0.5,
        mean_state_pred=_t(mean), var_state_pred=_t(var),
        theta=_t(theta_np))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-14)


@pytest.mark.parametrize("name", ["rodeo", "schober", "kramer"])
def test_interrogations_take_a_leading_key(name):
    """The JAX package's positional argument list, ``(key, ode_fun,
    ode_weight, t, mean, var)``: the port accepts the key in the same place
    and, drawing nothing, ignores it (None or a torch.Generator)."""
    rng = np.random.default_rng(4)
    W = np.zeros((3, 1, 3))
    W[:, :, 1] = 1.0
    args = (W, 0.5, rng.standard_normal((3, 3)), _psd(rng, 3, 3))
    theta = np.array(jlorenz.THETA)
    out_j = getattr(jinterrogate, f"interrogate_{name}")(
        None, jlorenz.lorenz_fun, *args, theta=theta)
    fun_t = getattr(tinterrogate, f"interrogate_{name}")
    out_t = fun_t(None, tlorenz.lorenz_fun, *map(_t, args), theta=_t(theta))
    out_g = fun_t(torch.Generator().manual_seed(0), tlorenz.lorenz_fun,
                  *map(_t, args), theta=_t(theta))
    for a, b, c in zip(out_t, out_g, out_j):
        assert torch.equal(a, b)
        _close(a, c, atol=1e-14)


@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_flat_rhs_matches_jax(model):
    """The column-form right-hand sides that the plain fused path uses."""
    jmod, tmod = {"lorenz": (jlorenz, tlorenz),
                  "fitzhugh": (jfitzhugh, tfitzhugh)}[model]
    rng = np.random.default_rng(3)
    nb, B = jmod.N_VARS, 5
    x_cols = [rng.standard_normal((nb, B)) for _ in range(3)]
    th = np.array(jmod.THETA)[:, None] * (1 + 0.1 * rng.random((3, B)))
    fj = getattr(jmod, f"{model}_flat")([jnp.asarray(c) for c in x_cols],
                                        jnp.asarray(th), 0.0)
    ft = tmod.FUSED.flat([_t(c) for c in x_cols], _t(th), 0.0)
    _close(ft, fj)
    jj = getattr(jmod, f"{model}_jac_flat")([jnp.asarray(c) for c in x_cols],
                                            jnp.asarray(th), 0.0)
    jt = tmod.FUSED.jac_flat([_t(c) for c in x_cols], _t(th), 0.0)
    assert [c is None for c in jt] == [c is None for c in jj]
    _close(jt[0], jj[0])


def test_from_numpy_round_trips_a_jax_setup():
    cfg = jlorenz.setup(n_steps=100, t_max=1.0, dtype=jnp.float64)
    cfg.pop("ode_fun")
    exported = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                    else np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in cfg.items()}
    port = from_numpy(exported, device="cpu", dtype=torch.float64)
    assert isinstance(port["prior_pars"], tuple)
    for a, b in zip(port["prior_pars"], exported["prior_pars"]):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), b)
    for key in ("ode_weight", "ode_init", "theta"):
        np.testing.assert_array_equal(port[key].numpy(), exported[key])
    assert port["n_steps"] == 100 and port["t_max"] == 1.0
    # ... and holds the same configuration as the port's own setup
    own = tlorenz.setup(n_steps=100, t_max=1.0, dtype=torch.float64,
                        device="cpu")
    for key in ("ode_weight", "ode_init", "theta"):
        _close(own[key], port[key])
    for a, b in zip(own["prior_pars"], port["prior_pars"]):
        _close(a, b)
    f32 = from_numpy(exported, device="cpu", dtype=torch.float32)
    assert f32["ode_init"].dtype == torch.float32
    with pytest.raises(TypeError):
        from_numpy({"ode_fun": jlorenz.lorenz_fun}, device="cpu")


def test_full_matmul_precision_turns_tf32_off_and_restores():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    seen = []

    @full_matmul_precision
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        probe()
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_port_imports_no_jax():
    """rodeo_tpu_torch runs where JAX is not installed: no module of it may
    import jax, jaxlib or the JAX package."""
    banned = ("jax", "jaxlib", "rodeo_tpu")
    files = sorted((REPO / "rodeo_tpu_torch").rglob("*.py"))
    names = {str(p.relative_to(REPO / "rodeo_tpu_torch")) for p in files}
    assert {"solve.py", "interrogate.py", "inference/basic.py",
            "inference/fenrir.py", "inference/dalton.py",
            "prior/indep_init.py", "ops/linalg.py", "ops/precond.py"} <= names
    # chip_smoke.py, the tools whose fixtures its torch_op and coverage
    # phases run, and the tool that times the torch-ops on the card
    for path in files + [REPO / "chip_smoke.py",
                         REPO / "tools" / "torch_op_reference.py",
                         REPO / "tools" / "torch_coverage_reference.py",
                         REPO / "tools" / "torch_op_costs.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def _entry_point_calls():
    """Each public entry point that takes ``device``, called without it on
    a small Lorenz63 problem built on the CPU."""
    import rodeo_tpu_torch as rt
    from rodeo_tpu_torch.models.obs import gauss
    cfg = tlorenz.setup(n_steps=8, t_max=0.1, device="cpu")
    lanes = dict(thetas=cfg["theta"].expand(2, 3).contiguous(),
                 ode_weight=cfg["ode_weight"],
                 ode_inits=cfg["ode_init"].expand(2, 3, 3).contiguous(),
                 t_min=0.0, t_max=0.1, n_steps=8,
                 prior_pars=cfg["prior_pars"], model="lorenz")
    single = dict(theta=cfg["theta"], ode_weight=cfg["ode_weight"],
                  ode_init=cfg["ode_init"], t_min=0.0, t_max=0.1, n_steps=8,
                  prior_pars=cfg["prior_pars"], model="lorenz")
    obs_w = torch.zeros((3, 3, 1, 3))
    obs_w[..., 0] = 1.0
    obs = dict(obs_data=torch.zeros((3, 3, 1)),
               obs_times=torch.tensor([0.0, 0.05, 0.1]),
               obs_weight=obs_w, obs_var=torch.full((3, 3, 1, 1), 0.005))
    magi = dict(ode_data_subsets=torch.zeros((2, 9, 3, 2)),
                ode_expand=lambda u: torch.cat(
                    [u, torch.zeros_like(u[..., :1])], -1),
                n_active=2, prior_pars=cfg["prior_pars"], dt=0.1 / 8)
    return {
        "lorenz.setup": lambda: tlorenz.setup(n_steps=8, t_max=0.1),
        "fitzhugh.setup": lambda: tfitzhugh.setup(n_steps=8),
        "from_numpy": lambda: from_numpy(np.zeros(3)),
        "solve_mv_fused_batch": lambda: rt.solve_mv_fused_batch(**lanes),
        "basic_fused_batch": lambda: rt.basic_fused_batch(
            **lanes, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_loglik=lambda o, x: torch.sum(x)),
        "fenrir_fused_batch": lambda: rt.fenrir_fused_batch(**lanes, **obs),
        "dalton_fused_batch": lambda: rt.dalton_fused_batch(**lanes, **obs),
        "solve_sim_fused_batch": lambda: rt.solve_sim_fused_batch(**lanes),
        "solve_mv_fused_batch_grad": lambda: rt.solve_mv_fused_batch_grad(
            **lanes),
        "basic_fused_batch_grad": lambda: rt.basic_fused_batch_grad(
            **lanes, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_loglik=lambda o, x: torch.sum(x)),
        "fenrir_fused_batch_grad": lambda: rt.fenrir_fused_batch_grad(
            **lanes, **obs),
        "dalton_fused_batch_grad": lambda: rt.dalton_fused_batch_grad(
            **lanes, **obs),
        "solve_mv_fused": lambda: rt.solve_mv_fused(**single),
        "solve_mv_fused_stationary": lambda: rt.solve_mv_fused_stationary(
            **single),
        "fenrir_fused": lambda: rt.fenrir_fused(**single, **obs),
        "magi_fused_batch": lambda: rt.magi_fused_batch(**magi),
        "magi_fused_batch_grad": lambda: rt.magi_fused_batch_grad(**magi),
        "daltonng_fused_batch": lambda: rt.daltonng_fused_batch(
            **lanes, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_model=gauss(0.005), obs_dims=(0,)),
        "daltonng_fused_batch_grad": lambda: rt.daltonng_fused_batch_grad(
            **lanes, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_model=gauss(0.005), obs_dims=(0,)),
    }


@pytest.mark.parametrize("entry", [
    "lorenz.setup", "fitzhugh.setup", "from_numpy", "solve_mv_fused_batch",
    "basic_fused_batch", "fenrir_fused_batch", "dalton_fused_batch",
    "solve_sim_fused_batch", "solve_mv_fused_batch_grad",
    "basic_fused_batch_grad", "fenrir_fused_batch_grad",
    "dalton_fused_batch_grad", "solve_mv_fused", "solve_mv_fused_stationary",
    "fenrir_fused", "magi_fused_batch", "magi_fused_batch_grad",
    "daltonng_fused_batch", "daltonng_fused_batch_grad"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without ``device`` an entry point runs on CUDA; with no CUDA device
    it raises rather than fall back to the CPU, which only
    ``device="cpu"`` selects."""
    call = _entry_point_calls()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
