r"""
Interrogation schemes (port of :mod:`rodeo_tpu.interrogate`).

An interrogation maps the predicted state distribution at time :math:`t_n`
to a linearised measurement model :math:`(B_n, a_n, V_n)` of the
pseudo-observation :math:`Z_n = 0`:

.. math::

    Z_n \approx (W + B_n) X_n + a_n + V_n^{1/2} \eta_n.

The signature is ``(key, ode_fun, ode_weight, t, mean_state_pred,
var_state_pred, **params) -> (wgt_meas, mean_meas, var_meas)`` with stacked
block shapes, the JAX package's.  The deterministic schemes accept ``key``
and ignore it.  The stochastic Chkrebtii scheme takes, in the place of the
JAX package's key, a ``torch.Generator`` or a tensor of the standard
normals it would draw (:func:`rodeo_tpu_torch.utils.standard_normals`).
"""
import torch

from rodeo_tpu_torch.utils import mvdot, quadform, standard_normals

__all__ = ["interrogate_rodeo", "interrogate_schober", "interrogate_chkrebtii",
           "interrogate_kramer"]


def interrogate_rodeo(key, ode_fun, ode_weight, t, mean_state_pred,
                      var_state_pred, **params):
    r"""
    Zero-order linearisation at the predicted mean with measurement variance
    :math:`V_n = W \Sigma_{n|n-1} W'`.

    Args:
        key: Unused (no ported scheme draws); the JAX package's PRNG key
            position, kept so that its callers run unchanged.
        ode_fun (Callable): Block-form ODE function ``f(X, t, **params)``.
        ode_weight (Tensor(n_block, n_bmeas, n_bstate)): Weight matrix ``W``.
        t (float): Time point.
        mean_state_pred (Tensor(n_block, n_bstate)): :math:`\mu_{n|n-1}`.
        var_state_pred (Tensor(n_block, n_bstate, n_bstate)):
            :math:`\Sigma_{n|n-1}`.
        params: Model parameters forwarded to ``ode_fun``.

    Returns:
        (tuple): ``wgt_meas`` (zeros like ``ode_weight``), ``mean_meas``
        :math:`-f(\mu_{n|n-1}, t)` and ``var_meas``.
    """
    var_meas = quadform(ode_weight, var_state_pred)
    mean_meas = -ode_fun(mean_state_pred, t, **params)
    return torch.zeros_like(ode_weight), mean_meas, var_meas


def interrogate_schober(key, ode_fun, ode_weight, t, mean_state_pred,
                        var_state_pred, **params):
    r"""Zero-order linearisation with :math:`V_n = 0` (Schober et al 2019).
    Same arguments and returns as :func:`interrogate_rodeo`."""
    n_block, n_bmeas, _ = ode_weight.shape
    var_meas = mean_state_pred.new_zeros((n_block, n_bmeas, n_bmeas))
    mean_meas = -ode_fun(mean_state_pred, t, **params)
    return torch.zeros_like(ode_weight), mean_meas, var_meas


def interrogate_chkrebtii(key, ode_fun, ode_weight, t, mean_state_pred,
                          var_state_pred, kalman_type, **params):
    r"""
    Stochastic interrogation (Chkrebtii et al 2016): the ODE evaluated at a
    draw :math:`x^* \sim N(\mu_{n|n-1}, \Sigma_{n|n-1})`, with
    :math:`V_n = W \Sigma_{n|n-1} W'`.

    The draw is :math:`\mu + L z` with :math:`L` the lower Cholesky factor
    of the symmetrised :math:`\Sigma_{n|n-1}`, as
    ``jax.random.multivariate_normal`` computes it by default: NaN where
    the variance is not positive definite, as there, rather than an error.

    Args:
        key (torch.Generator | Tensor(n_block, n_bstate)): Where the
            normals :math:`z` come from: a generator, or the normals
            themselves (those the JAX package draws from block ``b``'s
            subkey in row ``b``).
        kalman_type (str): ``"standard"``; the square-root form raises
            until ``kalmantv/square_root.py`` is ported.
        (other arguments as :func:`interrogate_rodeo`)

    Returns:
        (tuple): as :func:`interrogate_rodeo`, with ``mean_meas``
        :math:`-f(x^*, t)`.
    """
    if kalman_type == "square-root":
        raise NotImplementedError(
            "interrogate_chkrebtii(kalman_type='square-root') waits for the "
            "port of kalmantv/square_root.py")
    if kalman_type != "standard":
        raise NotImplementedError(
            f"unknown kalman_type {kalman_type!r}; expected 'standard'")
    var_meas = quadform(ode_weight, var_state_pred)
    z = standard_normals(key, mean_state_pred.shape, mean_state_pred)
    sym = 0.5 * (var_state_pred + var_state_pred.mT)
    chol, info = torch.linalg.cholesky_ex(sym)
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))
    x_state = mean_state_pred + mvdot(chol, z)
    mean_meas = -ode_fun(x_state, t, **params)
    return torch.zeros_like(ode_weight), mean_meas, var_meas


def _dual_jacobian(ode_fun, x, t, params):
    """``ode_fun`` on a :class:`~rodeo_tpu_torch.ops.dual.Dual` seeded along
    every entry of ``x``: the value and the full Jacobian in one forward
    pass of plain tensor operations, or ``None`` where the pass does not
    carry exactly one tangent per entry of ``x`` for every entry of ``f``
    (an operation or a tensor method that Duals lack, a parameter that
    broadcasts the state to more axes)."""
    from rodeo_tpu_torch.ops.dual import Dual
    n = x.numel()
    seed = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
        (n,) + x.shape)
    try:
        out = ode_fun(Dual(x, seed), t, **params)
    except Exception:
        return None
    if (not isinstance(out, Dual)
            or tuple(out.d.shape) != (n,) + tuple(out.v.shape)):
        return None
    # (x entries, f entries) -> (f entries, x entries)
    jac = out.d.reshape(n, -1).mT.reshape(out.v.shape + x.shape)
    return out.v, jac


def _eval_and_jacobian(ode_fun, x, t, params):
    r"""
    ``f = ode_fun(x, t, **params)`` and its full Jacobian in ``x``,
    ``(n_block, n_bmeas, n_block, n_bstate)``, exact.

    Forward mode on the port's Dual numbers (:func:`_dual_jacobian`), all
    directions in one pass of plain tensor operations, which the torch-ops'
    Python loops pay least for per step; for any ``ode_fun`` that the Dual
    pass does not carry, ``torch.func.jacfwd``.  Either stays
    differentiable by ``torch.autograd``.
    """
    out = _dual_jacobian(ode_fun, x, t, params)
    if out is not None:
        return out

    def fun(y):
        f = ode_fun(y, t, **params)
        return f, f

    jac, f = torch.func.jacfwd(fun, has_aux=True)(x)
    return f, jac


def interrogate_kramer(key, ode_fun, ode_weight, t, mean_state_pred,
                       var_state_pred, **params):
    r"""
    First-order (EK1) linearisation at the predicted mean with the
    block-diagonal Jacobian of ``ode_fun`` (Krämer et al 2021), taken by
    automatic differentiation (:func:`_eval_and_jacobian`).
    Off-block-diagonal entries are assumed zero.  Same arguments and
    returns as :func:`interrogate_rodeo`.
    """
    n_block, n_bmeas, _ = ode_weight.shape
    fun, jac = _eval_and_jacobian(ode_fun, mean_state_pred, t, params)
    fun_meas = -fun
    # (n_block, n_bmeas, n_block, n_bstate) -> its block diagonal
    jac = torch.diagonal(jac, dim1=0, dim2=2).movedim(-1, 0)
    mean_meas = fun_meas + mvdot(jac, mean_state_pred)
    var_meas = mean_state_pred.new_zeros((n_block, n_bmeas, n_bmeas))
    return -jac, mean_meas, var_meas
