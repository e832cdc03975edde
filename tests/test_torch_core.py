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


def test_kalman_smoothers_match_jax(kalman_inputs):
    k = kalman_inputs
    kt = {n: _t(a) for n, a in k.items()}
    args = ("mean_filt", "var_filt", "mean_pred", "var_pred")
    # JAX takes the Joseph form of the conditional variance under
    # fast_linalg, whose closed-form inverse differs from the port's LU
    # solve by rounding: 1e-10
    with fast_linalg():
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
        ode_fun=tfun, ode_weight=_t(W), t=0.5, mean_state_pred=_t(mean),
        var_state_pred=_t(var), theta=_t(theta))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-14)


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
    own = tlorenz.setup(n_steps=100, t_max=1.0, dtype=torch.float64)
    for key in ("ode_weight", "ode_init", "theta"):
        _close(own[key], port[key])
    for a, b in zip(own["prior_pars"], port["prior_pars"]):
        _close(a, b)
    f32 = from_numpy(exported, dtype=torch.float32)
    assert f32["ode_init"].dtype == torch.float32
    with pytest.raises(TypeError):
        from_numpy({"ode_fun": jlorenz.lorenz_fun})


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
    assert files
    for path in files + [REPO / "chip_smoke.py"]:
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
