r"""
MAGI Markov-prior log-density (port of :mod:`rodeo_tpu.inference.magi`, the
sequential form).

Computes :math:`\log p(U_{0:N}, Z = 0 \mid \theta)` where :math:`U` is a
subset of the solution process expanded to the full state by a user-supplied
``ode_expand``, and the first ``n_active`` derivatives of the expanded state
are treated as exact (noise-free) pseudo-observations of the Gauss-Markov
prior.  This is the torch-op reference, differentiable by ``torch.autograd``;
the lane-batched kernel path is
:func:`rodeo_tpu_torch.ops.fused_magi.magi_fused_batch`.
"""
import math

import torch

from rodeo_tpu_torch.kalmantv import get_backend
from rodeo_tpu_torch.ops.linalg import full_matmul_precision

__all__ = ["magi_logdens"]


def _mvn_logpdf(x, mean, cov):
    """Exact Gaussian log-density through a Cholesky factor, batched over
    leading dimensions (the counterpart of
    ``jax.scipy.stats.multivariate_normal.logpdf``)."""
    chol = torch.linalg.cholesky(cov)
    y = torch.linalg.solve_triangular(chol, (x - mean)[..., None],
                                      upper=False)[..., 0]
    n = x.shape[-1]
    log_diag = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
    return (-0.5 * torch.sum(y * y, dim=-1) - 0.5 * n * math.log(2 * math.pi)
            - torch.sum(log_diag, dim=-1))


@full_matmul_precision
def magi_logdens(ode_data_subset, ode_expand, n_active, prior_pars,
                 kalman_type, temporal="sequential", **params):
    r"""
    Log-density of the MAGI approximation, on the device of the inputs.

    Args:
        ode_data_subset (Tensor(n_steps+1, n_block, n_deriv-1)): The subset
            :math:`U_{0:N}` of the solution process needed to reconstruct
            the full solution with ``ode_expand``.
        ode_expand (Callable): ``ode_expand(ode_data_subset, **params)``
            returning the full solution process :math:`X_{0:N}` of shape
            ``(n_steps+1, n_block, n_deriv)``.
        n_active (int): Number of active (non-zero-padded) derivatives.
        prior_pars (tuple): ``(prior_weight, prior_var)``.
        kalman_type (str): ``"standard"``; the square-root form is not
            ported and raises.
        temporal (str): ``"sequential"``; ``"parallel"`` raises until
            ``ops/ptime.py`` is ported.
        params: Parameters forwarded to ``ode_expand``.

    Returns:
        (Tensor): ``log p(ode_data_subset, Z = 0 | params, prior_pars)``.
    """
    kalman_funs = get_backend(kalman_type)
    if temporal == "parallel":
        raise NotImplementedError(
            "temporal='parallel' magi is not ported to rodeo_tpu_torch yet "
            "(it needs ops/ptime.py)")
    if temporal != "sequential":
        raise NotImplementedError(
            f"unknown temporal mode {temporal!r}; "
            "expected 'sequential' or 'parallel'")

    n_vars = ode_data_subset.shape[1]
    ode_state = ode_expand(ode_data_subset, **params)
    n_deriv = ode_state.shape[2]
    like = dict(dtype=ode_state.dtype, device=ode_state.device)
    # exact pseudo-observations of the first n_active derivatives
    wgt_meas = torch.eye(n_active, n_deriv, **like).expand(
        n_vars, n_active, n_deriv)
    mean_meas = torch.zeros((n_vars, n_active), **like)
    var_meas = torch.zeros((n_vars, n_active, n_active), **like)
    mean_state = torch.zeros((n_vars, n_deriv), **like)
    wgt_state, var_state = prior_pars

    mean_past = ode_state[0]
    var_past = torch.zeros((n_vars, n_deriv, n_deriv), **like)
    logdens = torch.zeros((), **like)
    for x_meas in ode_state[1:, :, :n_active]:
        mean_pred, var_pred = kalman_funs.predict(
            mean_state_past=mean_past, var_state_past=var_past,
            mean_state=mean_state, wgt_state=wgt_state, var_state=var_state)
        mean_fore, var_fore = kalman_funs.forecast(
            mean_state_pred=mean_pred, var_state_pred=var_pred,
            mean_meas=mean_meas, wgt_meas=wgt_meas, var_meas=var_meas)
        # the exact logpdf (not an eigen-masked one, which would drop the
        # near-singular directions of the tight forecast variance)
        logdens = logdens + torch.sum(_mvn_logpdf(x_meas, mean_fore,
                                                  var_fore))
        # the Joseph form: with exact pseudo-observations the subtractive
        # update loses positive definiteness within ~20 steps
        mean_past, var_past = kalman_funs.update(
            mean_state_pred=mean_pred, var_state_pred=var_pred,
            x_meas=x_meas, mean_meas=mean_meas, wgt_meas=wgt_meas,
            var_meas=var_meas, joseph=True)
    return logdens
