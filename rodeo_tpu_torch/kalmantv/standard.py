r"""
Covariance-form Kalman filtering and smoothing steps (port of
:mod:`rodeo_tpu.kalmantv.standard`).

The state-space model is

.. math::

    x_n = c_n + Q_n x_{n-1} + R_n^{1/2} \epsilon_n, \qquad
    y_n = d_n + W_n x_n + V_n^{1/2} \eta_n.

Every function is batch polymorphic over leading dimensions.  The
covariance updates use the Joseph form throughout: it stays positive
semi-definite under float32 cancellation, where the subtractive form is a
measured failure of the JAX package (``docs/design.md``, "rank-1 update").
"""
import torch

from rodeo_tpu_torch.utils import mtt, mvdot, quadform, solve_var

__all__ = ["predict", "update", "smooth_mv", "forecast", "smooth_cond"]


def predict(mean_state_past, var_state_past, mean_state, wgt_state,
            var_state):
    r"""
    Prediction step: moments of :math:`p(X_n \mid Z_{0:n-1})` from those of
    :math:`p(X_{n-1} \mid Z_{0:n-1})`.

    Returns:
        (tuple): ``mean_state_pred`` and ``var_state_pred``.
    """
    mean_state_pred = mvdot(wgt_state, mean_state_past) + mean_state
    var_state_pred = quadform(wgt_state, var_state_past) + var_state
    return mean_state_pred, var_state_pred


def update(mean_state_pred, var_state_pred, x_meas, mean_meas, wgt_meas,
           var_meas):
    r"""
    Update step: moments of :math:`p(X_n \mid Z_{0:n})` from those of
    :math:`p(X_n \mid Z_{0:n-1})`, with the Joseph-form covariance
    :math:`(I - K W)\Sigma(I - K W)' + K V K'`.

    Returns:
        (tuple): ``mean_state_filt`` and ``var_state_filt``.
    """
    mean_meas_pred = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_meas_state_pred = wgt_meas @ var_state_pred
    var_meas_meas_pred = quadform(wgt_meas, var_state_pred) + var_meas
    # Kalman gain K = Sigma W' S^{-1} = (S^{-1} W Sigma)'
    gain = mtt(solve_var(var_meas_meas_pred, var_meas_state_pred))
    mean_state_filt = mean_state_pred + mvdot(gain, x_meas - mean_meas_pred)
    eye = torch.eye(var_state_pred.shape[-1], dtype=var_state_pred.dtype,
                    device=var_state_pred.device)
    ikw = eye - gain @ wgt_meas
    var_state_filt = quadform(ikw, var_state_pred) + quadform(gain, var_meas)
    return mean_state_filt, var_state_filt


def _smooth_gain(var_state_filt, var_state_pred, wgt_state):
    r"""``Sigma_{n|n} Q'`` and the smoothing gain
    ``G_n = Sigma_{n|n} Q' Sigma_{n+1|n}^{-1}``."""
    var_state_temp = var_state_filt @ mtt(wgt_state)
    gain = mtt(solve_var(var_state_pred, mtt(var_state_temp)))
    return var_state_temp, gain


def smooth_mv(mean_state_next, var_state_next, mean_state_filt,
              var_state_filt, mean_state_pred, var_state_pred, wgt_state):
    r"""
    One step of the Rauch-Tung-Striebel smoother: moments of
    :math:`p(X_n \mid Z_{0:N})`.

    Returns:
        (tuple): ``mean_state_smooth`` and ``var_state_smooth``.
    """
    _, gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = var_state_filt + quadform(
        gain, var_state_next - var_state_pred)
    return mean_state_smooth, var_state_smooth


def forecast(mean_state_pred, var_state_pred, mean_meas, wgt_meas,
             var_meas):
    r"""
    Measurement predictive distribution at time :math:`n` given
    observations :math:`0, \dots, n-1`.

    Returns:
        (tuple): ``mean_fore`` and ``var_fore``.
    """
    mean_fore = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_fore = quadform(wgt_meas, var_state_pred) + var_meas
    return mean_fore, var_fore


def smooth_cond(mean_state_filt, var_state_filt, mean_state_pred,
                var_state_pred, wgt_state, var_state):
    r"""
    Backward Markov-kernel parameters of the smoothing pass:
    :math:`X_n \mid X_{n+1}, Z_{0:n} \sim N(A_n X_{n+1} + b_n, V_n)`, with
    :math:`V_n` in the Joseph form
    :math:`(I - A_n Q)\Sigma_{n|n}(I - A_n Q)' + A_n R A_n'`.

    Returns:
        (tuple): ``wgt_state_cond`` :math:`A_n`, ``mean_state_cond``
        :math:`b_n`, ``var_state_cond`` :math:`V_n`.
    """
    _, gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_cond = mean_state_filt - mvdot(gain, mean_state_pred)
    eye = torch.eye(var_state_filt.shape[-1], dtype=var_state_filt.dtype,
                    device=var_state_filt.device)
    igq = eye - gain @ wgt_state
    var_state_cond = quadform(igq, var_state_filt) + quadform(gain, var_state)
    return gain, mean_state_cond, var_state_cond
