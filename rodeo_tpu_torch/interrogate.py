r"""
Interrogation schemes (port of :mod:`rodeo_tpu.interrogate`).

An interrogation maps the predicted state distribution at time :math:`t_n`
to a linearised measurement model :math:`(B_n, a_n, V_n)` of the
pseudo-observation :math:`Z_n = 0`:

.. math::

    Z_n \approx (W + B_n) X_n + a_n + V_n^{1/2} \eta_n.

The signature is ``(ode_fun, ode_weight, t, mean_state_pred,
var_state_pred, **params) -> (wgt_meas, mean_meas, var_meas)`` with stacked
block shapes.  The JAX package's leading ``key`` argument is gone: none of
the ported schemes is random (the stochastic Chkrebtii scheme is not ported
yet).
"""
import torch

from rodeo_tpu_torch.utils import mvdot, quadform

__all__ = ["interrogate_rodeo", "interrogate_schober", "interrogate_kramer"]


def interrogate_rodeo(ode_fun, ode_weight, t, mean_state_pred,
                      var_state_pred, **params):
    r"""
    Zero-order linearisation at the predicted mean with measurement variance
    :math:`V_n = W \Sigma_{n|n-1} W'`.

    Args:
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


def interrogate_schober(ode_fun, ode_weight, t, mean_state_pred,
                        var_state_pred, **params):
    r"""Zero-order linearisation with :math:`V_n = 0` (Schober et al 2019).
    Same arguments and returns as :func:`interrogate_rodeo`."""
    n_block, n_bmeas, _ = ode_weight.shape
    var_meas = mean_state_pred.new_zeros((n_block, n_bmeas, n_bmeas))
    mean_meas = -ode_fun(mean_state_pred, t, **params)
    return torch.zeros_like(ode_weight), mean_meas, var_meas


def interrogate_kramer(ode_fun, ode_weight, t, mean_state_pred,
                       var_state_pred, **params):
    r"""
    First-order (EK1) linearisation at the predicted mean with the
    block-diagonal Jacobian of ``ode_fun`` (Krämer et al 2021), taken by
    ``torch.func.jacfwd``.  Off-block-diagonal entries are assumed zero.
    Same arguments and returns as :func:`interrogate_rodeo`.
    """
    n_block, n_bmeas, _ = ode_weight.shape
    fun_meas = -ode_fun(mean_state_pred, t, **params)
    jac = torch.func.jacfwd(
        lambda x: ode_fun(x, t, **params))(mean_state_pred)
    # (n_block, n_bmeas, n_block, n_bstate) -> its block diagonal
    jac = torch.diagonal(jac, dim1=0, dim2=2).movedim(-1, 0)
    mean_meas = fun_meas + mvdot(jac, mean_state_pred)
    var_meas = mean_state_pred.new_zeros((n_block, n_bmeas, n_bmeas))
    return -jac, mean_meas, var_meas
