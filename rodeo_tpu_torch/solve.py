r"""
Probabilistic ODE solve by Kalman filtering and smoothing (port of
:mod:`rodeo_tpu.solve`: ``solve_mv`` and ``solve_sim``).

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

Where the JAX package takes a PRNG key, the port takes a
``torch.Generator`` or a tensor of the standard normals to use
(:func:`rodeo_tpu_torch.utils.standard_normals`).
"""
import torch

from rodeo_tpu_torch.kalmantv import get_backend
from rodeo_tpu_torch.ops.linalg import full_matmul_precision, psd_factor_eigh
from rodeo_tpu_torch.utils import mvdot, standard_normals

__all__ = ["solve_sim", "solve_mv"]


@full_matmul_precision
def _solve_filter(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
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
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
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


def _sample_mvn(z, mean, cov, method):
    r"""
    ``mean + L z`` for standard normals ``z``, with the factor ``L`` of
    ``cov`` that ``method`` names: ``"svd"``, :math:`U S^{1/2}` as
    ``jax.random.multivariate_normal(method="svd")`` forms it; ``"eigh"``,
    :func:`rodeo_tpu_torch.ops.linalg.psd_factor_eigh`, clamped at zero
    and with a gradient-safe derivative.  Both draw from singular
    covariances without failing.
    """
    if method == "eigh":
        factor = psd_factor_eigh(cov)
    elif method == "svd":
        u, sv, _ = torch.linalg.svd(cov)
        factor = u * torch.sqrt(sv)[..., None, :]
    else:
        raise NotImplementedError(
            f"unknown method {method!r}; expected 'svd' or 'eigh'")
    return mean + mvdot(factor, z)


def _draw_normals(key, n_steps, like):
    """The normals of a posterior draw, ``(n_steps, n_block, n_bstate)``:
    row ``n`` for step ``n`` of the backward pass, the last for the end
    point, in the order of the JAX package's subkeys.  Returns them with
    the key the filter's interrogations get: the generator, or ``None``
    when the normals were given."""
    z = standard_normals(key, (n_steps,) + tuple(like.shape), like)
    return z, (key if isinstance(key, torch.Generator) else None)


@full_matmul_precision
def solve_sim(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
              interrogate, prior_pars, kalman_type="standard", method="svd",
              **params):
    r"""
    A draw of the solution path from the solver's posterior.

    Args:
        key (torch.Generator | Tensor(n_steps, n_block, n_bstate)): Where
            the draw's normals come from: a generator, which the
            interrogations also get, or the normals themselves, row ``n``
            for the JAX package's subkey ``n`` (the interrogations then get
            ``None``).
        method (str): The factor of each step's conditional variance:
            ``"svd"`` (the JAX package's default) or ``"eigh"``, for which
            the backward kernels, factors and noise are computed for all
            steps at once and the loop keeps only the affine recursion.
        (other arguments as :func:`solve_mv`)

    Returns:
        (Tensor(n_steps+1, n_block, n_bstate)): The path, ``ode_init``
        first.
    """
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars
    z, key_filt = _draw_normals(key, n_steps, ode_init)
    mean_filt, var_filt, mean_pred, var_pred = _solve_filter(
        key=key_filt, ode_fun=ode_fun, ode_weight=ode_weight,
        ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate, prior_weight=prior_weight,
        prior_var=prior_var, kalman_funs=kalman_funs, **params)
    x_next = _sample_mvn(z[n_steps - 1], mean_filt[n_steps],
                         var_filt[n_steps], method)
    draws = [x_next]
    if method == "eigh":
        A, b, C = kalman_funs.smooth_cond(
            mean_state_filt=mean_filt[1:n_steps],
            var_state_filt=var_filt[1:n_steps],
            mean_state_pred=mean_pred[2:n_steps + 1],
            var_state_pred=var_pred[2:n_steps + 1],
            wgt_state=prior_weight, var_state=prior_var)
        eta = b + mvdot(psd_factor_eigh(C), z[:n_steps - 1])
        for n in range(n_steps - 2, -1, -1):
            x_next = mvdot(A[n], x_next) + eta[n]
            draws.append(x_next)
    else:
        for n in range(n_steps - 2, -1, -1):
            mean_sim, var_sim = kalman_funs.smooth_sim(
                x_state_next=x_next, mean_state_filt=mean_filt[n + 1],
                var_state_filt=var_filt[n + 1],
                mean_state_pred=mean_pred[n + 2],
                var_state_pred=var_pred[n + 2], wgt_state=prior_weight,
                var_state=prior_var)
            x_next = _sample_mvn(z[n], mean_sim, var_sim, method)
            draws.append(x_next)
    draws.append(ode_init)
    return torch.stack(draws[::-1])


@full_matmul_precision
def solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, kalman_type="standard",
             temporal="sequential", **params):
    r"""
    Posterior mean and variance of the probabilistic ODE solver.

    Args:
        key: Passed to ``interrogate`` at every step: ``None`` for the
            deterministic schemes, a ``torch.Generator`` for
            :func:`~rodeo_tpu_torch.interrogate.interrogate_chkrebtii`.
            It stands where the JAX package takes its PRNG key.
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
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
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
