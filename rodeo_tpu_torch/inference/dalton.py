r"""
DALTON for non-Gaussian observations (port of
:func:`rodeo_tpu.inference.dalton.daltonng`, the standard form).

The log-likelihood :math:`\log p(\hat Y_{0:M} \mid Z_{1:N})` is assembled as
``logy_x + logx_z - logx_yhat`` from two forward filters and the smoothing
passes over their stored moments:

- a filter that conditions on the ODE and on a Gaussian pseudo-observation
  of each datum, the Laplace linearisation :math:`\hat y = \mu_{n|n-1} +
  \hat\Omega \nabla \ell` with :math:`\hat\Omega = -(\nabla^2 \ell)^{+}` of
  the user's observation log-likelihood at the predicted mean (gradient and
  Hessian by ``torch.func``);
- the plain ODE filter (:func:`rodeo_tpu_torch.solve._solve_filter`).

This is the torch-op reference, differentiable by ``torch.autograd``
(every log-density goes through
:func:`rodeo_tpu_torch.utils.multivariate_normal_logpdf`, whose derivative
is analytic); the lane-batched kernel path is
:func:`rodeo_tpu_torch.ops.fused_daltonng.daltonng_fused_batch`.

The Hessian's masked inverse is the JAX package's closed form with its
ridge (its ``fast_linalg`` branch); the JAX package takes ``pinv`` without
``fast_linalg``, which agrees with it whenever the live block is
invertible.  The Kalman updates are the Joseph form
(:func:`rodeo_tpu_torch.kalmantv.standard.update`).
"""
import torch

from rodeo_tpu_torch.kalmantv import get_backend
from rodeo_tpu_torch.ops.linalg import (_det_small_normed,
                                        full_matmul_precision, inv_small)
from rodeo_tpu_torch.ops.obs_grid import obs_indices
from rodeo_tpu_torch.solve import _solve_filter as _solve_filter_ode
from rodeo_tpu_torch.utils import multivariate_normal_logpdf, mvdot

__all__ = ["daltonng"]


def _masked_neg_inverse(hes_diag):
    r"""``-(H)^{+}`` of the per-block Hessians ``hes_diag (n_block, q, q)``
    in closed form: components the log-likelihood never touches (zero rows)
    are set to 1 on the diagonal, inverted and zeroed back; a live block
    whose equilibrated determinant is below 100 eps gets a ridge of
    :math:`\sqrt{100 \epsilon}` times its diagonal first."""
    q = hes_diag.shape[-1]
    dtype = hes_diag.dtype
    live = torch.any(hes_diag != 0, dim=-1)                   # (nb, q)
    eye_q = torch.eye(q, dtype=dtype, device=hes_diag.device)
    dead_diag = eye_q * (~live).to(dtype)[..., None, :]
    neg_hes = -hes_diag + dead_diag
    dn = torch.abs(torch.diagonal(neg_hes, dim1=-2, dim2=-1))
    dn = torch.clamp(dn, min=torch.finfo(dtype).tiny)
    s = 1.0 / torch.sqrt(dn)
    corr = neg_hes * (s[..., :, None] * s[..., None, :])
    detn = _det_small_normed(corr)[..., None, None]
    det_tol = torch.finfo(dtype).eps * 100
    ridge = torch.where(torch.abs(detn) < det_tol,
                        torch.full_like(detn, det_tol ** 0.5),
                        torch.zeros_like(detn))
    inv_reg = inv_small(neg_hes + ridge * dn[..., :, None] * eye_q)
    mask = (live[..., :, None] & live[..., None, :]).to(dtype)
    return inv_reg * mask


def _solve_filter_nn(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                     n_steps, interrogate, prior_weight, prior_var,
                     obs_data, obs_times, obs_loglik_i, kalman_funs,
                     **params):
    r"""
    Forward pass of DALTON with non-Gaussian observations: the ODE update,
    then at an observation step the sequential update on the Laplace
    pseudo-observation at the predicted mean.

    Returns:
        (tuple): filtered means and variances, predicted means and
        variances, stacked over ``n_steps + 1`` points with the exact
        initial state first.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times).tolist()
    n_obs = len(obs_ind)
    x_meas = ode_init.new_zeros((n_block, n_bmeas))
    obs_mean = ode_init.new_zeros((n_block, n_bstate))
    mean_state = ode_init.new_zeros((n_block, n_bstate))
    var_init = ode_init.new_zeros((n_block, n_bstate, n_bstate))
    eye = torch.eye(n_bstate, dtype=ode_init.dtype, device=ode_init.device)
    mean_filt, var_filt = [ode_init], [var_init]
    mean_pred, var_pred = [ode_init], [var_init]
    # the observation at t_min enters only through logy_x
    i = 1 if obs_ind[0] == 0 else 0
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
        if i < n_obs and n + 1 == obs_ind[i]:
            def loglik(state, i=i):
                return obs_loglik_i(obs_data[i], state, i, **params)
            obs_grad = torch.func.jacrev(loglik)(mp)
            obs_hes = torch.func.jacfwd(torch.func.jacrev(loglik))(mp)
            # the block diagonal of the Hessian, (n_block, q, q)
            hes_diag = torch.diagonal(obs_hes, dim1=0, dim2=2).movedim(-1, 0)
            obs_var_hat = _masked_neg_inverse(hes_diag)
            obs_wgt_hat = (obs_var_hat != 0).to(mp.dtype)
            # components without data: zero weight and unit variance, an
            # exact identity update
            dead = torch.all(obs_wgt_hat == 0, dim=-1)
            obs_var_hat = obs_var_hat + eye * dead[..., None].to(mp.dtype)
            obs_hat = mvdot(obs_wgt_hat, mp) + mvdot(obs_var_hat, obs_grad)
            mf, vf = kalman_funs.update(
                mean_state_pred=mf, var_state_pred=vf, x_meas=obs_hat,
                mean_meas=obs_mean, wgt_meas=obs_wgt_hat,
                var_meas=obs_var_hat)
            i += 1
        mean_pred.append(mp)
        var_pred.append(vp)
        mean_filt.append(mf)
        var_filt.append(vf)
    return (torch.stack(mean_filt), torch.stack(var_filt),
            torch.stack(mean_pred), torch.stack(var_pred))


def _smooth_cond(kalman_funs, mean_filt, var_filt, mean_pred, var_pred,
                 prior_weight, prior_var):
    """The backward kernels ``(A, b, C)`` of steps ``1 .. N-1``, one batched
    ``smooth_cond``."""
    n_steps = mean_filt.shape[0] - 1
    return kalman_funs.smooth_cond(
        mean_state_filt=mean_filt[1:n_steps],
        var_state_filt=var_filt[1:n_steps],
        mean_state_pred=mean_pred[2:n_steps + 1],
        var_state_pred=var_pred[2:n_steps + 1],
        wgt_state=prior_weight, var_state=prior_var)


def _logx_yhat(mean_filt, var_filt, mean_pred, var_pred, prior_weight,
               prior_var, kalman_funs):
    r"""
    The smoothed mean path and :math:`\log p(X_{0:N} = \mu_{0:N|N} \mid
    \hat Y, Z)`.  The backward kernel is evaluated at the smoothed mean,
    where its quadratic form vanishes, so the sum over steps is one batched
    log-density of the stacked means.
    """
    n_steps = mean_filt.shape[0] - 1
    A, b, C = _smooth_cond(kalman_funs, mean_filt, var_filt, mean_pred,
                           var_pred, prior_weight, prior_var)
    mean_next = mean_filt[n_steps]
    means = []
    for n in range(n_steps - 2, -1, -1):
        mean_next = mvdot(A[n], mean_next) + b[n]
        means.append(mean_next)
    means = torch.stack(means[::-1])
    mean_out = torch.cat([mean_filt[0][None], means,
                          mean_filt[n_steps][None]])
    logx_yhat = torch.sum(multivariate_normal_logpdf(
        mean_filt[n_steps], mean_filt[n_steps], var_filt[n_steps]))
    logx_yhat = logx_yhat + torch.sum(multivariate_normal_logpdf(
        means, means, C))
    return mean_out, logx_yhat


def _logx_z(uncond_mean, mean_filt, var_filt, mean_pred, var_pred,
            prior_weight, prior_var, kalman_funs):
    r""":math:`\log p(X_{0:N} = \text{uncond\_mean} \mid Z_{1:N})` along
    the backward Markov chain of the ODE filter, one batched log-density."""
    n_steps = mean_filt.shape[0] - 1
    logx_zN = torch.sum(multivariate_normal_logpdf(
        uncond_mean[n_steps], mean_filt[n_steps], var_filt[n_steps]))
    A, b, C = _smooth_cond(kalman_funs, mean_filt, var_filt, mean_pred,
                           var_pred, prior_weight, prior_var)
    mean_sim = mvdot(A, uncond_mean[2:n_steps + 1]) + b
    return logx_zN + torch.sum(multivariate_normal_logpdf(
        uncond_mean[1:n_steps], mean_sim, C))


@full_matmul_precision
def daltonng(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, obs_data, obs_times, obs_loglik_i,
             kalman_type="standard", **params):
    r"""
    DALTON marginal log-likelihood for non-Gaussian observations,
    :math:`\log p(\hat Y_{0:M} \mid Z_{1:N})`, as
    ``logy_x + logx_z - logx_yhat``.

    Args:
        key: Passed to ``interrogate`` (the ported schemes ignore it).
        ode_fun (Callable): Block-form ODE function ``f(X, t, **params)``.
        ode_weight (Tensor(n_block, n_bmeas, n_bstate)): :math:`W`.
        ode_init (Tensor(n_block, n_bstate)): Initial state.
        t_min, t_max (float): Solution interval.
        n_steps (int): Number of solver steps.
        interrogate (Callable): Interrogation scheme.
        prior_pars (tuple): ``(prior_weight, prior_var)``.
        obs_data (Tensor(n_obs, ...)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_loglik_i (Callable): Per-observation log-likelihood
            ``obs_loglik_i(obs_data_i, state, i, **params)``, ``state``
            ``(n_block, n_bstate)``, written in torch operations that
            ``torch.func`` differentiates twice.
        kalman_type (str): ``"standard"`` (the square-root form is not
            ported and raises).
        params: Model parameters forwarded to ``ode_fun`` and
            ``obs_loglik_i``.

    Returns:
        (Tensor): The log-likelihood value.
    """
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars
    filt = _solve_filter_nn(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_loglik_i=obs_loglik_i,
        kalman_funs=kalman_funs, **params)
    mean_smooth, logx_yhat = _logx_yhat(*filt, prior_weight, prior_var,
                                        kalman_funs)
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times).tolist()
    logy_x = sum(obs_loglik_i(obs_data[i], mean_smooth[k], i, **params)
                 for i, k in enumerate(obs_ind))
    filt_z = _solve_filter_ode(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        kalman_funs=kalman_funs, **params)
    logx_z = _logx_z(mean_smooth, *filt_z, prior_weight, prior_var,
                     kalman_funs)
    return logy_x + logx_z - logx_yhat
