r"""
Covariance-form Kalman filtering and smoothing steps (port of
:mod:`rodeo_tpu.kalmantv.standard`).

The state-space model is

.. math::

    x_n = c_n + Q_n x_{n-1} + R_n^{1/2} \epsilon_n, \qquad
    y_n = d_n + W_n x_n + V_n^{1/2} \eta_n.

Every function is batch polymorphic over leading dimensions.  As in the
JAX package, the covariance updates take the Joseph form under
:func:`rodeo_tpu_torch.ops.linalg.fast_linalg` (or when ``update`` is asked
for it): it stays positive semi-definite under float32 cancellation, where
the subtractive form is a measured failure of the JAX package
(``docs/design.md``, "rank-1 update").  Outside the switch they take the
subtractive form, as the JAX package's default path does.
"""
import torch

from rodeo_tpu_torch.utils import matmul, mtt, mvdot, quadform, solve_var

__all__ = ["predict", "update", "filter", "smooth_mv", "smooth_sim",
           "smooth", "forecast", "smooth_cond"]


def _fast_linalg_enabled():
    """:func:`rodeo_tpu_torch.ops.linalg.fast_linalg_enabled`, imported
    when called (``ops`` imports this module through the solvers)."""
    from rodeo_tpu_torch.ops.linalg import fast_linalg_enabled as enabled
    return enabled()


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
           var_meas, *, joseph=None):
    r"""
    Update step: moments of :math:`p(X_n \mid Z_{0:n})` from those of
    :math:`p(X_n \mid Z_{0:n-1})`.

    Args:
        joseph (bool | None): ``True``: the Joseph-form covariance
            :math:`(I - K W)\Sigma(I - K W)' + K V K'`; ``False``: the
            subtractive form :math:`\Sigma - K W \Sigma`; ``None``: the
            Joseph form under
            :func:`~rodeo_tpu_torch.ops.linalg.fast_linalg`, else the
            subtractive one (:func:`~rodeo_tpu_torch.ops.linalg.
            fast_linalg_enabled`).

    Returns:
        (tuple): ``mean_state_filt`` and ``var_state_filt``.
    """
    mean_meas_pred = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_meas_state_pred = matmul(wgt_meas, var_state_pred)
    var_meas_meas_pred = quadform(wgt_meas, var_state_pred) + var_meas
    # Kalman gain K = Sigma W' S^{-1} = (S^{-1} W Sigma)'
    gain = mtt(solve_var(var_meas_meas_pred, var_meas_state_pred))
    mean_state_filt = mean_state_pred + mvdot(gain, x_meas - mean_meas_pred)
    if joseph is None:
        joseph = _fast_linalg_enabled()
    if not joseph:
        return mean_state_filt, var_state_pred - matmul(gain,
                                                         var_meas_state_pred)
    eye = torch.eye(var_state_pred.shape[-1], dtype=var_state_pred.dtype,
                    device=var_state_pred.device)
    ikw = eye - matmul(gain, wgt_meas)
    var_state_filt = quadform(ikw, var_state_pred) + quadform(gain, var_meas)
    return mean_state_filt, var_state_filt


def filter(mean_state_past, var_state_past, mean_state, wgt_state,
           var_state, x_meas, mean_meas, wgt_meas, var_meas):
    r"""
    One full step of the Kalman filter: :func:`predict`, then
    :func:`update`.

    Returns:
        (tuple): ``mean_state_pred``, ``var_state_pred``,
        ``mean_state_filt`` and ``var_state_filt``.
    """
    mean_state_pred, var_state_pred = predict(
        mean_state_past=mean_state_past, var_state_past=var_state_past,
        mean_state=mean_state, wgt_state=wgt_state, var_state=var_state)
    mean_state_filt, var_state_filt = update(
        mean_state_pred=mean_state_pred, var_state_pred=var_state_pred,
        x_meas=x_meas, mean_meas=mean_meas, wgt_meas=wgt_meas,
        var_meas=var_meas)
    return mean_state_pred, var_state_pred, mean_state_filt, var_state_filt


def _smooth_gain(var_state_filt, var_state_pred, wgt_state):
    r"""``Sigma_{n|n} Q'`` and the smoothing gain
    ``G_n = Sigma_{n|n} Q' Sigma_{n+1|n}^{-1}``."""
    var_state_temp = matmul(var_state_filt, mtt(wgt_state))
    gain = mtt(solve_var(var_state_pred, mtt(var_state_temp)))
    return var_state_temp, gain


def _sim_var(gain, var_state_temp, var_state_filt, wgt_state, var_state):
    r"""The sampling smoother's conditional variance
    :math:`\Sigma_{n|n} - G_n \Sigma_{n+1|n} G_n'`; under ``fast_linalg``,
    and given the process noise, in the equal Joseph form
    :math:`(I - G Q)\Sigma_{n|n}(I - G Q)' + G R G'`, which stays positive
    semi-definite under float32 cancellation."""
    if _fast_linalg_enabled() and var_state is not None:
        eye = torch.eye(var_state_filt.shape[-1], dtype=var_state_filt.dtype,
                        device=var_state_filt.device)
        igq = eye - matmul(gain, wgt_state)
        return quadform(igq, var_state_filt) + quadform(gain, var_state)
    return var_state_filt - matmul(gain, mtt(var_state_temp))


def smooth_mv(mean_state_next, var_state_next, mean_state_filt,
              var_state_filt, mean_state_pred, var_state_pred, wgt_state,
              var_state=None):
    r"""
    One step of the Rauch-Tung-Striebel smoother: moments of
    :math:`p(X_n \mid Z_{0:N})`.  ``var_state`` is accepted, as in the JAX
    package, and unused.

    Returns:
        (tuple): ``mean_state_smooth`` and ``var_state_smooth``.
    """
    _, gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = var_state_filt + quadform(
        gain, var_state_next - var_state_pred)
    return mean_state_smooth, var_state_smooth


def smooth_sim(x_state_next, mean_state_filt, var_state_filt,
               mean_state_pred, var_state_pred, wgt_state, var_state=None):
    r"""
    One step of the sampling smoother: moments of
    :math:`p(X_n \mid X_{n+1}, Z_{0:N})`.

    Returns:
        (tuple): ``mean_state_sim`` and ``var_state_sim``.
    """
    var_state_temp, gain = _smooth_gain(var_state_filt, var_state_pred,
                                        wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    var_state_sim = _sim_var(gain, var_state_temp, var_state_filt,
                             wgt_state, var_state)
    return mean_state_sim, var_state_sim


def smooth(x_state_next, mean_state_next, var_state_next, mean_state_filt,
           var_state_filt, mean_state_pred, var_state_pred, wgt_state,
           var_state=None):
    r"""
    The sampling and the mean-variance smoother's steps in one.

    Returns:
        (tuple): ``mean_state_sim``, ``var_state_sim``,
        ``mean_state_smooth`` and ``var_state_smooth``.
    """
    var_state_temp, gain = _smooth_gain(var_state_filt, var_state_pred,
                                        wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    var_state_sim = _sim_var(gain, var_state_temp, var_state_filt,
                             wgt_state, var_state)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = var_state_filt + quadform(
        gain, var_state_next - var_state_pred)
    return mean_state_sim, var_state_sim, mean_state_smooth, var_state_smooth


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
                var_state_pred, wgt_state, var_state=None):
    r"""
    Backward Markov-kernel parameters of the smoothing pass:
    :math:`X_n \mid X_{n+1}, Z_{0:n} \sim N(A_n X_{n+1} + b_n, V_n)`, with
    :math:`V_n` as :func:`_sim_var` forms it.

    Returns:
        (tuple): ``wgt_state_cond`` :math:`A_n`, ``mean_state_cond``
        :math:`b_n`, ``var_state_cond`` :math:`V_n`.
    """
    var_state_temp, gain = _smooth_gain(var_state_filt, var_state_pred,
                                        wgt_state)
    mean_state_cond = mean_state_filt - mvdot(gain, mean_state_pred)
    var_state_cond = _sim_var(gain, var_state_temp, var_state_filt,
                              wgt_state, var_state)
    return gain, mean_state_cond, var_state_cond
