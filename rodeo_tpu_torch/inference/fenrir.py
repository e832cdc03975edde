r"""
Fenrir likelihood approximation (Tronarp et al 2022; port of
:mod:`rodeo_tpu.inference.fenrir`, the standard form).

The forward ODE filter becomes a backward Markov chain

.. math::

    X_N \sim N(b_N, C_N), \qquad
    X_n = A_n X_{n+1} + b_n + C_n^{1/2} \epsilon_n,

and a second Kalman filter runs backwards along it, conditioning on the
Gaussian observations :math:`Y_m = D_m X_m + \Omega_m^{1/2} \eta_m` at
their grid points and summing their forecast log-densities.  The
observation model is scattered onto the grid (:func:`_obs_grid`), so a step
without data has zero weight; the JAX package where-gates its update
there, and this port skips it, which selects the same numbers.  This is
the torch-op reference, differentiable by ``torch.autograd``; the
lane-batched kernel path is
:func:`rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch`.
"""
import torch

from rodeo_tpu_torch.kalmantv import get_backend
from rodeo_tpu_torch.ops.linalg import (fast_linalg_enabled,
                                        full_matmul_precision,
                                        mvn_logpdf_small)
from rodeo_tpu_torch.ops.obs_grid import obs_indices
from rodeo_tpu_torch.solve import _solve_filter
from rodeo_tpu_torch.utils import multivariate_normal_logpdf, mvdot

__all__ = ["fenrir", "solve_mv"]


def _forecast_update(mean_state_pred, var_state_pred, x_meas, mean_meas,
                     wgt_meas, var_meas, kalman_funs):
    r"""
    One forecast and update: the observation's log-density (summed over
    blocks) and the filtered moments.

    Returns:
        (tuple): ``logdens``, ``mean_state_filt`` and ``var_state_filt``.
    """
    mean_fore, var_fore = kalman_funs.forecast(
        mean_state_pred=mean_state_pred, var_state_pred=var_state_pred,
        mean_meas=mean_meas, wgt_meas=wgt_meas, var_meas=var_meas)
    logdens = torch.sum(multivariate_normal_logpdf(x_meas, mean_fore,
                                                   var_fore))
    mean_state_filt, var_state_filt = kalman_funs.update(
        mean_state_pred=mean_state_pred, var_state_pred=var_state_pred,
        x_meas=x_meas, mean_meas=mean_meas, wgt_meas=wgt_meas,
        var_meas=var_meas)
    return logdens, mean_state_filt, var_state_filt


def _obs_grid(t_min, t_max, n_steps, obs_data, obs_times, obs_weight,
              obs_var, dtype):
    r"""
    The observation model on every grid point ``0 .. N``: zero weight, zero
    data and unit variance where there is no observation, and a 0/1 mask.
    The grid index of a time is :func:`rodeo_tpu_torch.ops.obs_grid.
    obs_indices`' (the grid as ``jnp.linspace`` builds it).

    Returns:
        (tuple): ``d_grid (N+1, n_block, n_bobs, n_bstate)``, ``y_grid
        (N+1, n_block, n_bobs)``, ``om_grid (N+1, n_block, n_bobs,
        n_bobs)`` and ``mask (N+1,)``, on ``obs_weight``'s device.
    """
    n_obs, n_block, n_bobs, n_bstate = obs_weight.shape
    device = obs_weight.device
    like = dict(dtype=dtype, device=device)
    idx = obs_indices(t_min, t_max, n_steps, obs_times).to(device)
    d_grid = torch.zeros((n_steps + 1, n_block, n_bobs, n_bstate), **like)
    d_grid[idx] = obs_weight.to(dtype)
    y_grid = torch.zeros((n_steps + 1, n_block, n_bobs), **like)
    y_grid[idx] = obs_data.to(**like)
    om_grid = torch.eye(n_bobs, **like).repeat(n_steps + 1, n_block, 1, 1)
    om_grid[idx] = obs_var.to(**like)
    mask = torch.zeros((n_steps + 1,), **like)
    mask[idx] = 1.0
    return d_grid, y_grid, om_grid, mask


def _backward_dense(mean_state_filt, var_state_filt, mean_state_pred,
                    var_state_pred, prior_weight, prior_var, t_min, t_max,
                    n_steps, obs_data, obs_times, obs_weight, obs_var,
                    kalman_funs, temporal="sequential"):
    r"""
    The backward pass on the grid-scattered observations (the JAX
    package's masked-dense form): the chain's ``(A_n, b_n, C_n)`` for
    ``n = 0 .. N-1`` in one batched ``smooth_cond``, the filter along the
    chain with an update at each step with data, and every forecast
    log-density in one batched call, masked.  Under ``fast_linalg`` the
    log-density is the closed form (:func:`mvn_logpdf_small`), else the
    eigen-masked one.

    Returns:
        (tuple): ``logdens`` and the chain's moments and parameters
        (``state_pred``, ``state_filt``, ``wgt_state``, ``var_state``) for
        :func:`_smooth_mv`.
    """
    if temporal == "parallel":
        raise NotImplementedError(
            "temporal='parallel' waits for the port of ops/ptime.py")
    if temporal != "sequential":
        raise NotImplementedError(
            f"unknown temporal mode {temporal!r}; expected 'sequential'")
    dtype = mean_state_filt.dtype
    n_block, n_bobs = obs_weight.shape[1], obs_weight.shape[2]
    A, b, C = kalman_funs.smooth_cond(
        mean_state_filt=mean_state_filt[:n_steps],
        var_state_filt=var_state_filt[:n_steps],
        mean_state_pred=mean_state_pred[1:n_steps + 1],
        var_state_pred=var_state_pred[1:n_steps + 1],
        wgt_state=prior_weight, var_state=prior_var)
    d_grid, y_grid, om_grid, mask = _obs_grid(
        t_min, t_max, n_steps, obs_data, obs_times, obs_weight, obs_var,
        dtype)
    observed = set(obs_indices(t_min, t_max, n_steps, obs_times).tolist())
    obs_mean = mean_state_filt.new_zeros((n_block, n_bobs))

    def update(n, mean, var):
        return kalman_funs.update(
            mean_state_pred=mean, var_state_pred=var, x_meas=y_grid[n],
            mean_meas=obs_mean, wgt_meas=d_grid[n], var_meas=om_grid[n])

    mean_term, var_term = mean_state_filt[n_steps], var_state_filt[n_steps]
    m_seed, p_seed = (update(n_steps, mean_term, var_term)
                      if n_steps in observed else (mean_term, var_term))
    pred, filt = [], []
    bmean, bvar = m_seed, p_seed
    for n in range(n_steps - 1, -1, -1):
        bmean_pred, bvar_pred = kalman_funs.predict(
            mean_state_past=bmean, var_state_past=bvar, mean_state=b[n],
            wgt_state=A[n], var_state=C[n])
        bmean, bvar = (update(n, bmean_pred, bvar_pred) if n in observed
                       else (bmean_pred, bvar_pred))
        pred.append((bmean_pred, bvar_pred))
        filt.append((bmean, bvar))
    pred.reverse()
    filt.reverse()
    bpred_mean = torch.stack([m for m, _ in pred] + [mean_term])
    bpred_var = torch.stack([v for _, v in pred] + [var_term])
    fore_mean = mvdot(d_grid, bpred_mean)
    fore_var = d_grid @ bpred_var @ d_grid.mT + om_grid
    if fast_linalg_enabled() and n_bobs <= 5:
        logp = mvn_logpdf_small(y_grid, fore_mean, fore_var)
    else:
        logp = multivariate_normal_logpdf(y_grid, fore_mean, fore_var)
    logdens = torch.sum(mask[:, None] * logp)
    state_par = {
        "state_pred": (bpred_mean, bpred_var),
        "state_filt": (torch.stack([m for m, _ in filt] + [m_seed]),
                       torch.stack([v for _, v in filt] + [p_seed])),
        "wgt_state": A,
        "var_state": C,
    }
    return logdens, state_par


def _backward_inputs(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                     n_steps, interrogate, prior_pars, obs_data, obs_times,
                     obs_weight, obs_var, kalman_funs, **params):
    """The forward ODE filter, as the keyword arguments of
    :func:`_backward_dense`."""
    prior_weight, prior_var = prior_pars
    mean_filt, var_filt, mean_pred, var_pred = _solve_filter(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        kalman_funs=kalman_funs, **params)
    return dict(
        mean_state_filt=mean_filt, var_state_filt=var_filt,
        mean_state_pred=mean_pred, var_state_pred=var_pred,
        prior_weight=prior_weight, prior_var=prior_var, t_min=t_min,
        t_max=t_max, n_steps=n_steps, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs)


@full_matmul_precision
def fenrir(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
           interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
           kalman_type="standard", temporal="sequential", **params):
    r"""
    Fenrir approximate log-likelihood :math:`\log p(Y_{0:M} \mid Z_{1:N})`.

    Args:
        obs_data (Tensor(n_obs, n_block, n_bobs)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_weight (Tensor(n_obs, n_block, n_bobs, n_bstate)): :math:`D_m`.
        obs_var (Tensor(n_obs, n_block, n_bobs, n_bobs)): :math:`\Omega_m`.
        kalman_type (str): ``"standard"``; the square-root form raises
            until ``kalmantv/square_root.py`` is ported.
        temporal (str): ``"sequential"``; ``"parallel"`` raises until
            ``ops/ptime.py`` is ported.
        (other arguments as :func:`rodeo_tpu_torch.solve.solve_mv`)

    Returns:
        (Tensor): The log-likelihood.
    """
    kalman_funs = get_backend(kalman_type)
    logdens, _ = _backward_dense(temporal=temporal, **_backward_inputs(
        key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
        interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
        kalman_funs, **params))
    return logdens


def _smooth_mv(state_par, kalman_funs):
    r"""
    The smoothing pass over the backward chain's moments: the
    data-conditioned posterior, running forwards in time because the
    backward pass reversed the chain.
    """
    mean_pred, var_pred = state_par["state_pred"]
    mean_filt, var_filt = state_par["state_filt"]
    wgt_state, var_state = state_par["wgt_state"], state_par["var_state"]
    n_tot = mean_pred.shape[0]
    means, variances = [mean_filt[0], mean_filt[1]], [var_filt[0],
                                                      var_filt[1]]
    mean, var = mean_filt[1], var_filt[1]
    for k in range(n_tot - 2):
        mean, var = kalman_funs.smooth_mv(
            mean_state_next=mean, var_state_next=var,
            mean_state_filt=mean_filt[k + 2], var_state_filt=var_filt[k + 2],
            mean_state_pred=mean_pred[k + 1], var_state_pred=var_pred[k + 1],
            wgt_state=wgt_state[k + 1], var_state=var_state[k + 1])
        means.append(mean)
        variances.append(var)
    return torch.stack(means), torch.stack(variances)


@full_matmul_precision
def solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, obs_data, obs_times, obs_weight,
             obs_var, kalman_type="standard", temporal="sequential",
             **params):
    r"""
    Fenrir's data-conditioned solution posterior
    :math:`p(X_{0:N} \mid Z_{1:N}, Y_{0:M})`.  Same arguments as
    :func:`fenrir`.

    Returns:
        (tuple): ``mean_state_smooth (n_steps+1, n_block, n_bstate)`` and
        ``var_state_smooth (n_steps+1, n_block, n_bstate, n_bstate)``.
    """
    kalman_funs = get_backend(kalman_type)
    _, state_par = _backward_dense(temporal=temporal, **_backward_inputs(
        key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
        interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
        kalman_funs, **params))
    return _smooth_mv(state_par, kalman_funs)
