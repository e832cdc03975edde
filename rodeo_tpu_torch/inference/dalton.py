r"""
DALTON, the data-adaptive likelihood approximation (port of
:mod:`rodeo_tpu.inference.dalton`, the standard form).

For Gaussian observations, :func:`dalton` computes
:math:`\log p(Y_{0:M} \mid Z_{1:N}) = \log p(Y_{0:M}, Z_{1:N}) -
\log p(Z_{1:N})` from two filters run together: a joint filter that
conditions on the ODE and then on the data at the steps that carry any
(the JAX package's sequential form, equal to its stacked update for the
block-diagonal joint noise), and the plain ODE filter.  The log-density at
a step with data is the eigen-masked one of the stacked joint forecast, at
the other steps that of the ODE forecast.  :func:`solve_mv` and
:func:`solve_sim` give the data-conditioned posterior's moments and draws.

For non-Gaussian observations, :func:`daltonng` assembles
:math:`\log p(\hat Y_{0:M} \mid Z_{1:N})` as ``logy_x + logx_z -
logx_yhat`` from two forward filters and the smoothing passes over their
stored moments:

- a filter that conditions on the ODE and on a Gaussian pseudo-observation
  of each datum, the Laplace linearisation :math:`\hat y = \mu_{n|n-1} +
  \hat\Omega \nabla \ell` with :math:`\hat\Omega = -(\nabla^2
  \ell)^{+}` of the user's observation log-likelihood at the predicted
  mean (gradient and Hessian by ``torch.func``);
- the plain ODE filter (:func:`rodeo_tpu_torch.solve._solve_filter`).

:func:`solve_mv_nn` gives the first filter's smoothed moments.  The
Hessian's masked inverse is ``pinv``, or under
:func:`rodeo_tpu_torch.ops.linalg.fast_linalg` the JAX package's closed
form with its ridge, which agrees with it whenever the live block is
invertible.

These are the torch-op references, differentiable by ``torch.autograd``
(every masked log-density goes through
:func:`rodeo_tpu_torch.utils.multivariate_normal_logpdf`, whose derivative
is analytic); the lane-batched kernel paths are
:func:`rodeo_tpu_torch.ops.fused_dalton.dalton_fused_batch` and
:func:`rodeo_tpu_torch.ops.fused_daltonng.daltonng_fused_batch`.
"""
import torch

from rodeo_tpu_torch.inference.fenrir import _obs_grid
from rodeo_tpu_torch.kalmantv import get_backend, standard
from rodeo_tpu_torch.ops.linalg import (_det_small_normed,
                                        fast_linalg_enabled,
                                        full_matmul_precision, inv_small)
from rodeo_tpu_torch.ops.obs_grid import obs_indices
from rodeo_tpu_torch.solve import _draw_normals, _sample_mvn
from rodeo_tpu_torch.solve import _solve_filter as _solve_filter_ode
from rodeo_tpu_torch.utils import multivariate_normal_logpdf, mvdot, quadform

__all__ = ["dalton", "daltonng", "solve_mv", "solve_sim", "solve_mv_nn"]


def _block_diag2(var_a, var_b):
    """Block diagonal of two batched matrices, over the leading dims."""
    lead = var_a.shape[:-2]
    p, r = var_a.shape[-1], var_b.shape[-1]
    top = torch.cat([var_a, var_a.new_zeros(lead + (p, r))], dim=-1)
    bottom = torch.cat([var_b.new_zeros(lead + (r, p)), var_b], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _ode_time(t_min, t_max, n_steps, n):
    return t_min + (t_max - t_min) * (n + 1) / n_steps


@full_matmul_precision
def dalton(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
           interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
           kalman_type="standard", **params):
    r"""
    DALTON marginal log-likelihood for Gaussian observations,
    :math:`\log p(Y_{0:M} \mid Z_{1:N})`.

    Args:
        obs_data (Tensor(n_obs, n_block, n_bobs)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_weight (Tensor(n_obs, n_block, n_bobs, n_bstate)): :math:`D_m`.
        obs_var (Tensor(n_obs, n_block, n_bobs, n_bobs)): :math:`\Omega_m`.
        kalman_type (str): ``"standard"``; the square-root form raises
            until ``kalmantv/square_root.py`` is ported.
        (other arguments as :func:`rodeo_tpu_torch.solve.solve_mv`)

    Returns:
        (Tensor): The log-likelihood.
    """
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars
    return _dalton_dense(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params)


def _dalton_dense(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
                  interrogate, prior_weight, prior_var, obs_data, obs_times,
                  obs_weight, obs_var, kalman_funs, **params):
    """:func:`_dalton_dense_parts`' joint less its marginal log-density."""
    logdens_zy, logdens_z = _dalton_dense_parts(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params)
    return logdens_zy - logdens_z


def _dalton_dense_parts(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                        n_steps, interrogate, prior_weight, prior_var,
                        obs_data, obs_times, obs_weight, obs_var,
                        kalman_funs, **params):
    r"""
    The joint and marginal log-densities ``(log p(Z, Y), log p(Z))`` on the
    grid-scattered observations (the JAX package's masked-dense form).

    The joint filter updates on the ODE, then on the data at a step that
    has any (a step without data has zero weight, whose update the JAX
    package computes as an exact identity and this port skips).  The
    stacked forecast moments of each step are kept, and the log-densities
    are taken after the loop in batched calls: the eigen-masked density of
    the stacked forecast at steps with data, of its ODE block at the
    others, as the JAX package selects them.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]
    dtype = ode_init.dtype
    d_grid, y_grid, om_grid, mask = _obs_grid(
        t_min, t_max, n_steps, obs_data, obs_times, obs_weight, obs_var,
        dtype)
    observed = set(obs_indices(t_min, t_max, n_steps, obs_times).tolist())
    x_meas = ode_init.new_zeros((n_block, n_bmeas))
    obs_mean = ode_init.new_zeros((n_block, n_bobs))
    mean_state = ode_init.new_zeros((n_block, n_bstate))
    var_init = ode_init.new_zeros((n_block, n_bstate, n_bstate))
    filt_zy = filt_z = (ode_init, var_init)
    joint, marg = [], []
    for n in range(n_steps):
        t = _ode_time(t_min, t_max, n_steps, n)
        mean_pred, var_pred = kalman_funs.predict(
            mean_state_past=filt_zy[0], var_state_past=filt_zy[1],
            mean_state=mean_state, wgt_state=prior_weight,
            var_state=prior_var)
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight, t=t,
            mean_state_pred=mean_pred, var_state_pred=var_pred, **params)
        wgt_ode = ode_weight + wgt_meas
        filt_zy = kalman_funs.update(
            mean_state_pred=mean_pred, var_state_pred=var_pred,
            x_meas=x_meas, mean_meas=mean_meas, wgt_meas=wgt_ode,
            var_meas=var_meas)
        if n + 1 in observed:
            filt_zy = kalman_funs.update(
                mean_state_pred=filt_zy[0], var_state_pred=filt_zy[1],
                x_meas=y_grid[n + 1], mean_meas=obs_mean,
                wgt_meas=d_grid[n + 1], var_meas=om_grid[n + 1])
        joint.append((mean_pred, var_pred, wgt_ode, mean_meas, var_meas))

        mean_pred, var_pred = kalman_funs.predict(
            mean_state_past=filt_z[0], var_state_past=filt_z[1],
            mean_state=mean_state, wgt_state=prior_weight,
            var_state=prior_var)
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight, t=t,
            mean_state_pred=mean_pred, var_state_pred=var_pred, **params)
        wgt_ode = ode_weight + wgt_meas
        filt_z = kalman_funs.update(
            mean_state_pred=mean_pred, var_state_pred=var_pred,
            x_meas=x_meas, mean_meas=mean_meas, wgt_meas=wgt_ode,
            var_meas=var_meas)
        marg.append((mean_pred, var_pred, wgt_ode, mean_meas, var_meas))

    mean_zy, var_zy, wgt_zy, mm_zy, vm_zy = (torch.stack(a)
                                             for a in zip(*joint))
    wgt_stack = torch.cat([wgt_zy, d_grid[1:]], dim=-2)
    mean_stack = torch.cat([mm_zy, obs_mean.expand_as(y_grid[1:])], dim=-1)
    var_stack = _block_diag2(vm_zy, om_grid[1:])
    x_stack = torch.cat([x_meas.expand_as(mm_zy), y_grid[1:]], dim=-1)
    fore_mean_zy = mvdot(wgt_stack, mean_zy) + mean_stack
    fore_var_zy = quadform(wgt_stack, var_zy) + var_stack
    mean_z, var_z, wgt_z, mm_z, vm_z = (torch.stack(a) for a in zip(*marg))
    fore_mean_z = mvdot(wgt_z, mean_z) + mm_z
    fore_var_z = quadform(wgt_z, var_z) + vm_z

    logpdf = multivariate_normal_logpdf
    logp0 = torch.sum(logpdf(y_grid[0], mvdot(d_grid[0], ode_init)
                             + obs_mean, om_grid[0]))
    logp_zy_stack = logpdf(x_stack, fore_mean_zy, fore_var_zy)
    logp_zy_ode = logpdf(x_stack[..., :n_bmeas],
                         fore_mean_zy[..., :n_bmeas],
                         fore_var_zy[..., :n_bmeas, :n_bmeas])
    logp_zy = torch.where(mask[1:, None] > 0.5, logp_zy_stack, logp_zy_ode)
    logdens_zy = mask[0] * logp0 + torch.sum(logp_zy)
    logdens_z = torch.sum(logpdf(torch.zeros_like(fore_mean_z), fore_mean_z,
                                 fore_var_z))
    return logdens_zy, logdens_z


def _solve_filter(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                  n_steps, interrogate, prior_weight, prior_var, obs_data,
                  obs_times, obs_weight, obs_var, kalman_funs, **params):
    """The forward pass of DALTON with Gaussian observations: the standard
    form's :func:`_solve_filter_dense`."""
    if kalman_funs is not standard:
        raise NotImplementedError(
            "DALTON's square-root filter waits for the port of "
            "kalmantv/square_root.py")
    return _solve_filter_dense(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params)


def _solve_filter_dense(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                        n_steps, interrogate, prior_weight, prior_var,
                        obs_data, obs_times, obs_weight, obs_var,
                        kalman_funs, **params):
    r"""
    The data-conditioned forward filter on the grid-scattered
    observations: at each step the ODE update, then at a step with data
    the observation update.

    Returns:
        (tuple): filtered means and variances, predicted means and
        variances, stacked over ``n_steps + 1`` points with the exact
        initial state first.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]
    d_grid, y_grid, om_grid, _ = _obs_grid(
        t_min, t_max, n_steps, obs_data, obs_times, obs_weight, obs_var,
        ode_init.dtype)
    observed = set(obs_indices(t_min, t_max, n_steps, obs_times).tolist())
    x_meas = ode_init.new_zeros((n_block, n_bmeas))
    obs_mean = ode_init.new_zeros((n_block, n_bobs))
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
            t=_ode_time(t_min, t_max, n_steps, n), mean_state_pred=mp,
            var_state_pred=vp, **params)
        mf, vf = kalman_funs.update(
            mean_state_pred=mp, var_state_pred=vp, x_meas=x_meas,
            mean_meas=mean_meas, wgt_meas=ode_weight + wgt_meas,
            var_meas=var_meas)
        if n + 1 in observed:
            mf, vf = kalman_funs.update(
                mean_state_pred=mf, var_state_pred=vf, x_meas=y_grid[n + 1],
                mean_meas=obs_mean, wgt_meas=d_grid[n + 1],
                var_meas=om_grid[n + 1])
        mean_pred.append(mp)
        var_pred.append(vp)
        mean_filt.append(mf)
        var_filt.append(vf)
    return (torch.stack(mean_filt), torch.stack(var_filt),
            torch.stack(mean_pred), torch.stack(var_pred))


def _smooth_mv_pass(ode_init, filt, prior_weight, prior_var, kalman_funs):
    """The reverse mean-variance smoothing pass over a forward filter's
    stacked moments ``(mean_filt, var_filt, mean_pred, var_pred)``."""
    mean_filt, var_filt, mean_pred, var_pred = filt
    n_steps = mean_filt.shape[0] - 1
    mean, var = mean_filt[n_steps], var_filt[n_steps]
    means, variances = [mean], [var]
    for n in range(n_steps - 2, -1, -1):
        mean, var = kalman_funs.smooth_mv(
            mean_state_next=mean, var_state_next=var,
            mean_state_filt=mean_filt[n + 1], var_state_filt=var_filt[n + 1],
            mean_state_pred=mean_pred[n + 2], var_state_pred=var_pred[n + 2],
            wgt_state=prior_weight, var_state=prior_var)
        means.append(mean)
        variances.append(var)
    means.append(ode_init)
    variances.append(torch.zeros_like(var_filt[0]))
    return torch.stack(means[::-1]), torch.stack(variances[::-1])


def _filter_gaussian(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                     n_steps, interrogate, prior_pars, obs_data, obs_times,
                     obs_weight, obs_var, kalman_type, **params):
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars
    filt = _solve_filter(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params)
    return filt, kalman_funs


@full_matmul_precision
def solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, obs_data, obs_times, obs_weight,
             obs_var, kalman_type="standard", **params):
    r"""
    DALTON's data-conditioned posterior mean and variance of
    :math:`p(X_{0:N} \mid Y_{0:M}, Z_{1:N})` for Gaussian observations.
    Same arguments as :func:`dalton`.

    Returns:
        (tuple): ``mean_state_smooth`` and ``var_state_smooth``.
    """
    filt, kalman_funs = _filter_gaussian(
        key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
        interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
        kalman_type, **params)
    return _smooth_mv_pass(ode_init, filt, *prior_pars, kalman_funs)


@full_matmul_precision
def solve_sim(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
              interrogate, prior_pars, obs_data, obs_times, obs_weight,
              obs_var, kalman_type="standard", **params):
    r"""
    A draw from DALTON's data-conditioned posterior
    :math:`p(X_{0:N} \mid Y_{0:M}, Z_{1:N})` for Gaussian observations,
    each step's factor by SVD as in the JAX package.  ``key`` is a
    ``torch.Generator`` or the normals ``(n_steps, n_block, n_bstate)``,
    as in :func:`rodeo_tpu_torch.solve.solve_sim`; the other arguments as
    :func:`dalton`.

    Returns:
        (Tensor(n_steps+1, n_block, n_bstate)): The path.
    """
    z, key_filt = _draw_normals(key, n_steps, ode_init)
    filt, kalman_funs = _filter_gaussian(
        key_filt, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
        interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
        kalman_type, **params)
    mean_filt, var_filt, mean_pred, var_pred = filt
    prior_weight, prior_var = prior_pars
    x_next = _sample_mvn(z[n_steps - 1], mean_filt[n_steps],
                         var_filt[n_steps], "svd")
    draws = [x_next]
    for n in range(n_steps - 2, -1, -1):
        mean_sim, var_sim = kalman_funs.smooth_sim(
            x_state_next=x_next, mean_state_filt=mean_filt[n + 1],
            var_state_filt=var_filt[n + 1], mean_state_pred=mean_pred[n + 2],
            var_state_pred=var_pred[n + 2], wgt_state=prior_weight,
            var_state=prior_var)
        x_next = _sample_mvn(z[n], mean_sim, var_sim, "svd")
        draws.append(x_next)
    draws.append(ode_init)
    return torch.stack(draws[::-1])


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
    pseudo-observation at the predicted mean.  The Hessian's masked inverse
    is ``-pinv``, or under ``fast_linalg`` :func:`_masked_neg_inverse`.

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
            if fast_linalg_enabled() and n_bstate <= 5:
                obs_var_hat = _masked_neg_inverse(hes_diag)
            else:
                rtol = 10.0 * n_bstate * torch.finfo(mp.dtype).eps
                obs_var_hat = -torch.linalg.pinv(hes_diag, rtol=rtol)
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


@full_matmul_precision
def solve_mv_nn(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
                interrogate, prior_pars, obs_data, obs_times, obs_loglik_i,
                kalman_type="standard", **params):
    r"""
    DALTON's posterior mean and variance of
    :math:`p(X_{0:N} \mid \hat Y_{0:M}, Z_{1:N})` for non-Gaussian
    observations.  Same arguments as :func:`daltonng`.

    Returns:
        (tuple): ``mean_state_smooth`` and ``var_state_smooth``.
    """
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars
    filt = _solve_filter_nn(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_loglik_i=obs_loglik_i,
        kalman_funs=kalman_funs, **params)
    return _smooth_mv_pass(ode_init, filt, prior_weight, prior_var,
                           kalman_funs)
