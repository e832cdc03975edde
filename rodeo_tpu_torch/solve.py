r"""
Probabilistic ODE solve by Kalman filtering and smoothing (port of
:mod:`rodeo_tpu.solve`, ``solve_mv`` only).

Solves :math:`W X_t = f(X_t, t, \theta)`, :math:`X_a = x_0`, under a
Gauss-Markov prior with the state-space model

.. math::

    X_n = Q X_{n-1} + R^{1/2} \epsilon_n, \qquad
    Z_n = W X_n - f(X_n, t_n, \theta) + V_n^{1/2} \eta_n,

and pseudo-observations :math:`Z_n = 0`.  The state is block diagonal,
stored as stacked ``(n_block, n_bstate, n_bstate)`` tensors.  The forward
filter is a Python loop over steps; the smoothing gains are hoisted out of
the backward loop as one batched :func:`~rodeo_tpu_torch.kalmantv.standard.
smooth_cond` over the time axis, so the loop keeps only the affine
recursion.
"""
import torch

from rodeo_tpu_torch.kalmantv import get_backend
from rodeo_tpu_torch.ops.linalg import full_matmul_precision

__all__ = ["solve_mv"]


@full_matmul_precision
def _solve_filter(ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
                  interrogate, prior_weight, prior_var, kalman_funs,
                  **params):
    r"""
    Forward pass of the solver.

    Returns:
        (tuple): filtered means and variances, predicted means and
        variances, each stacked over ``n_steps + 1`` time points with the
        deterministic initial state first.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    x_meas = ode_init.new_zeros((n_block, n_bmeas))
    mean_state = ode_init.new_zeros((n_block, n_bstate))
    var_init = ode_init.new_zeros((n_block, n_bstate, n_bstate))
    mean_filt, var_filt = [ode_init], [var_init]
    mean_pred, var_pred = [ode_init], [var_init]
    for n in range(n_steps):
        mp, vp = kalman_funs.predict(
            mean_state_past=mean_filt[-1], var_state_past=var_filt[-1],
            mean_state=mean_state, wgt_state=prior_weight,
            var_state=prior_var)
        wgt_meas, mean_meas, var_meas = interrogate(
            ode_fun=ode_fun, ode_weight=ode_weight,
            t=t_min + (t_max - t_min) * (n + 1) / n_steps,
            mean_state_pred=mp, var_state_pred=vp, **params)
        mf, vf = kalman_funs.update(
            mean_state_pred=mp, var_state_pred=vp, x_meas=x_meas,
            mean_meas=mean_meas, wgt_meas=ode_weight + wgt_meas,
            var_meas=var_meas)
        mean_pred.append(mp)
        var_pred.append(vp)
        mean_filt.append(mf)
        var_filt.append(vf)
    return (torch.stack(mean_filt), torch.stack(var_filt),
            torch.stack(mean_pred), torch.stack(var_pred))


@full_matmul_precision
def solve_mv(ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, kalman_type="standard",
             temporal="sequential", **params):
    r"""
    Posterior mean and variance of the probabilistic ODE solver.

    Args:
        ode_fun (Callable): Block-form ODE function
            ``f(X_t, t, **params)``, written in torch ops.
        ode_weight (Tensor(n_block, n_bmeas, n_bstate)): Weight matrix ``W``.
        ode_init (Tensor(n_block, n_bstate)): Initial state at ``t_min``.
        t_min, t_max (float): Time interval.
        n_steps (int): Number of steps; the step is ``(t_max-t_min)/n_steps``.
        interrogate (Callable): Interrogation scheme
            (:mod:`rodeo_tpu_torch.interrogate`).
        prior_pars (tuple): ``(prior_weight, prior_var)``, each
            ``(n_block, n_bstate, n_bstate)``.
        kalman_type (str): ``"standard"`` (the square-root form is not
            ported yet).
        temporal (str): ``"sequential"`` (the parallel-in-time smoother is
            not ported yet).
        params: Model parameters forwarded to ``ode_fun``.

    Returns:
        (tuple):
        - **mean_state_smooth** (Tensor(n_steps+1, n_block, n_bstate)).
        - **var_state_smooth** (Tensor(n_steps+1, n_block, n_bstate,
          n_bstate)).
    """
    kalman_funs = get_backend(kalman_type)
    if temporal == "parallel":
        raise NotImplementedError(
            "temporal='parallel' waits for the port of ops/ptime.py")
    if temporal != "sequential":
        raise NotImplementedError(
            f"unknown temporal mode {temporal!r}; expected 'sequential'")
    prior_weight, prior_var = prior_pars
    mean_filt, var_filt, mean_pred, var_pred = _solve_filter(
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        kalman_funs=kalman_funs, **params)
    # the backward kernel (A_n, b_n, C_n) depends only on the stored forward
    # moments: one batched smooth_cond over the whole time axis
    A, b, C = kalman_funs.smooth_cond(
        mean_state_filt=mean_filt[1:n_steps],
        var_state_filt=var_filt[1:n_steps],
        mean_state_pred=mean_pred[2:n_steps + 1],
        var_state_pred=var_pred[2:n_steps + 1],
        wgt_state=prior_weight, var_state=prior_var)
    mean_next, var_next = mean_filt[n_steps], var_filt[n_steps]
    means, variances = [mean_next], [var_next]
    for n in range(n_steps - 2, -1, -1):
        mean_next = torch.einsum("...ij,...j->...i", A[n], mean_next) + b[n]
        var_next = A[n] @ var_next @ A[n].transpose(-1, -2) + C[n]
        means.append(mean_next)
        variances.append(var_next)
    means.append(ode_init)
    variances.append(torch.zeros_like(var_next))
    return torch.stack(means[::-1]), torch.stack(variances[::-1])
