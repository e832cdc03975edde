r"""
Taylor-mode preconditioning of the solver state (port of
:mod:`rodeo_tpu.ops.precond`: every wrapper but ``solve_mv_iterated``, which
waits for ``ops/ptime.py``).

The IBM prior over ``(x, x', ..., x^{(q)})`` with step ``dt`` has entries
spanning :math:`dt^{\pm q}`, beyond float32's range of precision on fine
grids.  In the coordinates :math:`\tilde x = T^{-1} x` with the diagonal

.. math:: T_{ii} = \sqrt{dt} \; dt^{\,q-i} / (q-i)!

the transition becomes the Pascal matrix and the noise a Hilbert-like
matrix, both :math:`O(1)`-conditioned.  Each wrapper runs its solver in
those coordinates, under :func:`rodeo_tpu_torch.ops.linalg.fast_linalg`
where the JAX package's does (all but :func:`fenrir_solve_mv`); the fused
kernels of :mod:`rodeo_tpu_torch.ops.fused_kalman` assume them.  A wrapper
that takes ``n_deriv`` runs the dense (non-blocked,
:func:`rodeo_tpu_torch.prior.indep_init`) layout when it is given: the
per-derivative scaling is then tiled across the variables.
"""
import importlib
import math

import torch

import rodeo_tpu_torch.solve as _solve
from rodeo_tpu_torch.ops.linalg import fast_linalg
from rodeo_tpu_torch.ops.obs_grid import obs_indices

# the modules, which rodeo_tpu_torch.inference shadows by its functions
_dalton = importlib.import_module("rodeo_tpu_torch.inference.dalton")
_fenrir = importlib.import_module("rodeo_tpu_torch.inference.fenrir")
_magi = importlib.import_module("rodeo_tpu_torch.inference.magi")

__all__ = ["taylor_scale", "scale_prior", "solve_mv", "solve_sim",
           "solve_mv_iterated", "fenrir", "dalton", "basic", "daltonng",
           "magi_logdens", "fenrir_solve_mv", "dalton_solve_mv",
           "dalton_solve_sim", "dalton_solve_mv_nn"]


def taylor_scale(dt, n_deriv, dtype, device=None):
    r"""
    Diagonal preconditioner ``t_vec[i] = sqrt(dt) * dt**(q-i) / (q-i)!`` for
    ``q = n_deriv - 1``.

    Built from exact factorials and iterated ``dt`` products (not ``pow``),
    as in the JAX package, in ``dtype`` on the CPU and then moved to
    ``device``: on a CUDA tensor PyTorch divides by a Python scalar through
    its reciprocal, which can differ from the JAX package's quotient in the
    last bit.

    Returns:
        (Tensor(n_deriv,)): The diagonal of :math:`T`.
    """
    dt = torch.tensor(dt, dtype=dtype)
    pows = [torch.ones_like(dt)]
    for _ in range(n_deriv - 1):
        pows.append(pows[-1] * dt)
    q = n_deriv - 1
    t_vec = torch.sqrt(dt) * torch.stack(
        [pows[q - i] / math.factorial(q - i) for i in range(n_deriv)])
    return t_vec.to(device)


def scale_prior(prior_pars, t_vec, sqrt=False):
    r"""
    Prior parameters in scaled coordinates:
    :math:`\tilde Q_{ij} = Q_{ij} t_j / t_i`,
    :math:`\tilde R_{ij} = R_{ij} / (t_i t_j)`.  With ``sqrt=True``
    ``prior_var`` is a factor :math:`R_f` of :math:`R`, whose scaled factor
    is the row-scaled :math:`T^{-1} R_f`.
    """
    prior_weight, prior_var = prior_pars
    t = t_vec.to(prior_weight.dtype)
    Qs = prior_weight * (t[None, :] / t[:, None])
    if sqrt:
        return Qs, prior_var / t[:, None]
    Rs = prior_var / (t[:, None] * t[None, :])
    return Qs, Rs


def _wrap_interrogate(interrogate, ode_weight_orig, t_vec, sqrt=False):
    """Adapter between the scaled solver state and an interrogation written
    for original coordinates; the returned ``wgt_meas`` is scaled back.
    With ``sqrt=True`` the predicted variance is a factor, unscaled by
    row."""

    def wrapped(key, ode_fun, ode_weight, t, mean_state_pred, var_state_pred,
                **params):
        t_v = t_vec.to(mean_state_pred.dtype)
        mean_orig = mean_state_pred * t_v
        # guard the user ODE's polynomial terms against float32 overflow
        if mean_orig.dtype == torch.float32:
            mean_orig = torch.clamp(torch.nan_to_num(mean_orig), -1e10, 1e10)
        if sqrt:
            var_orig = var_state_pred * t_v[:, None]
        else:
            var_orig = var_state_pred * (t_v[:, None] * t_v[None, :])
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight_orig, t=t,
            mean_state_pred=mean_orig, var_state_pred=var_orig, **params)
        return wgt_meas * t_v, mean_meas, var_meas

    return wrapped


def _scaled_inputs(ode_weight, ode_init, prior_pars, t_min, t_max, n_steps,
                   n_deriv=None, sqrt=False):
    """``t_vec`` and the weight, initial state and prior in scaled
    coordinates.  ``n_deriv=None``: the blocked layout, whose trailing
    state dimension is one variable's derivatives.  With ``n_deriv`` given,
    the dense layout of ``n_vars`` blocks of ``n_deriv`` derivatives,
    concatenated, over which the scaling is tiled."""
    state_dim = ode_init.shape[-1]
    if n_deriv is None:
        n_deriv = state_dim
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, n_deriv, dtype=ode_init.dtype,
                         device=ode_init.device)
    if n_deriv != state_dim:
        if state_dim % n_deriv:
            raise ValueError(
                f"n_deriv={n_deriv} must divide the state dimension "
                f"{state_dim} (dense layout = n_vars blocks of n_deriv "
                f"derivatives)")
        t_vec = t_vec.repeat(state_dim // n_deriv)
    return (t_vec,
            ode_weight * t_vec[None, None, :].to(ode_weight.dtype),
            ode_init / t_vec,
            scale_prior(prior_pars, t_vec, sqrt=sqrt))


def _unscale_moments(mean_s, var_s, t_vec):
    t_v = t_vec.to(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])


def solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, kalman_type="standard",
             temporal="sequential", n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.solve.solve_mv`: the same
    posterior up to rounding, computed in Taylor-scaled coordinates under
    ``fast_linalg``, which keeps the covariance filter finite in float32
    and on priors as wide as Lorenz63's (``prior_sigma=5e7`` overflows the
    plain recursion even in float64).  Same signature and return contract,
    and ``n_deriv`` for the dense layout.
    """
    sqrt = kalman_type == "square-root"
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=sqrt)
    with fast_linalg():
        mean_s, var_s = _solve.solve_mv(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec,
                                          sqrt=sqrt),
            prior_pars=prior_s, kalman_type=kalman_type, temporal=temporal,
            **params)
    return _unscale_moments(mean_s, var_s, t_vec)


def solve_sim(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
              interrogate, prior_pars, kalman_type="standard", n_deriv=None,
              **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.solve.solve_sim` (``method`` as
    there), under ``fast_linalg``; returns the path in original
    coordinates.
    """
    sqrt = kalman_type == "square-root"
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=sqrt)
    with fast_linalg():
        xs = _solve.solve_sim(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec,
                                          sqrt=sqrt),
            prior_pars=prior_s, kalman_type=kalman_type, **params)
    return xs * t_vec.to(xs.dtype)


def solve_mv_iterated(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                      n_steps, interrogate, prior_pars, **kwargs):
    """The parallel-in-time engine of the JAX package; it waits for the
    port of ``ops/ptime.py`` and raises."""
    raise NotImplementedError(
        "solve_mv_iterated waits for the port of ops/ptime.py")


def fenrir(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
           interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
           kalman_type="standard", temporal="sequential", n_deriv=None,
           **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.fenrir.fenrir`, under
    ``fast_linalg``.  The observation weight transforms as
    :math:`\tilde D = D T`, and the log-density of the data is invariant
    under the change of state coordinates, so the value is the plain
    implementation's.
    """
    sqrt = kalman_type == "square-root"
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=sqrt)
    with fast_linalg():
        return _fenrir.fenrir(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec,
                                          sqrt=sqrt),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight * t_vec.to(obs_weight.dtype),
            obs_var=obs_var, kalman_type=kalman_type, temporal=temporal,
            **params)


def dalton(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
           interrogate, prior_pars, obs_data, obs_times, obs_weight, obs_var,
           n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.dalton.dalton` (see
    :func:`fenrir`), under ``fast_linalg``.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        return _dalton.dalton(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight * t_vec.to(obs_weight.dtype),
            obs_var=obs_var, **params)


def basic(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
          interrogate, prior_pars, obs_data, obs_times, obs_loglik,
          n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.basic.basic`: the solve
    is :func:`solve_mv`, and the observation log-likelihood is evaluated on
    the unscaled solution, so the value is the plain implementation's.

    Returns:
        (tuple): the log-likelihood and the smoothed solution ``Xt``.
    """
    Xt, _ = solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_pars=prior_pars, n_deriv=n_deriv, **params)
    ode_data = Xt[obs_indices(t_min, t_max, n_steps, obs_times).to(
        Xt.device)]
    return obs_loglik(obs_data, ode_data, **params), Xt


def _wrap_obs_loglik(obs_loglik_i, t_vec):
    """Adapter so that an observation log-likelihood written for original
    coordinates sees the unscaled state; its gradient and Hessian in the
    scaled state then follow by the chain rule."""

    def wrapped(obs_i, state_scaled, i, **params):
        return obs_loglik_i(obs_i, state_scaled * t_vec.to(state_scaled.dtype),
                            i, **params)

    return wrapped


def daltonng(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, obs_data, obs_times, obs_loglik_i,
             kalman_type="standard", n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.dalton.daltonng`
    (non-Gaussian DALTON).  The two state-path log-densities (``logx_z`` and
    ``logx_yhat``) pick up the same change-of-variables Jacobian, which
    cancels in ``logy_x + logx_z - logx_yhat``, so the value is that of the
    plain implementation; the Laplace linearisation is chain-ruled through
    the scaling by :func:`_wrap_obs_loglik`.  Same signature and return.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        return _dalton.daltonng(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_loglik_i=_wrap_obs_loglik(obs_loglik_i, t_vec),
            kalman_type=kalman_type, **params)


def magi_logdens(ode_data_subset, ode_expand, n_active, prior_pars, dt,
                 kalman_type="standard", **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.magi.magi_logdens`.

    The MAGI filter runs on the Taylor-scaled state; since the observed
    pseudo-data are the scaled first ``n_active`` derivatives, the scaled
    log-density differs from the original by the exact change-of-variables
    Jacobian :math:`N\,n_{block}\sum_{i<n_{active}}\log t_i`, which is
    subtracted, so the value matches the plain implementation.  Under
    ``fast_linalg``.

    Args:
        dt (float): Solver step size (needed to build the Taylor scaling;
            the plain API encodes it only implicitly in ``prior_pars``).
        (other arguments as
        :func:`rodeo_tpu_torch.inference.magi.magi_logdens`)
    """
    probe = ode_expand(ode_data_subset, **params)
    n_steps_p1, n_block, n_deriv = probe.shape
    t_vec = taylor_scale(dt, n_deriv, dtype=probe.dtype, device=probe.device)
    prior_s = scale_prior(prior_pars, t_vec)

    def ode_expand_s(subset, **p):
        return ode_expand(subset, **p) / t_vec

    with fast_linalg():
        logdens_s = _magi.magi_logdens(
            ode_data_subset=ode_data_subset, ode_expand=ode_expand_s,
            n_active=n_active, prior_pars=prior_s, kalman_type=kalman_type,
            **params)
    jacobian = (n_steps_p1 - 1) * n_block * torch.sum(
        torch.log(t_vec[:n_active]))
    return logdens_s - jacobian


def fenrir_solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                    n_steps, interrogate, prior_pars, obs_data, obs_times,
                    obs_weight, obs_var, temporal="sequential", n_deriv=None,
                    **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.fenrir.solve_mv`: the
    data-conditioned posterior, in original coordinates.  Not under
    ``fast_linalg``, as in the JAX package: the final smoothing pass runs
    over the backward chain, whose predicted variances become numerically
    singular near the exact initial state, where the closed-form inverse
    explodes and the LU solve stays bounded.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    mean_s, var_s = _fenrir.solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
        prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
        obs_weight=obs_weight * t_vec.to(obs_weight.dtype), obs_var=obs_var,
        temporal=temporal, **params)
    return _unscale_moments(mean_s, var_s, t_vec)


def dalton_solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                    n_steps, interrogate, prior_pars, obs_data, obs_times,
                    obs_weight, obs_var, n_deriv=None, **params):
    r"""Preconditioned :func:`rodeo_tpu_torch.inference.dalton.solve_mv`,
    under ``fast_linalg``; the moments in original coordinates."""
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        mean_s, var_s = _dalton.solve_mv(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight * t_vec.to(obs_weight.dtype),
            obs_var=obs_var, **params)
    return _unscale_moments(mean_s, var_s, t_vec)


def dalton_solve_sim(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                     n_steps, interrogate, prior_pars, obs_data, obs_times,
                     obs_weight, obs_var, n_deriv=None, **params):
    r"""Preconditioned :func:`rodeo_tpu_torch.inference.dalton.solve_sim`,
    under ``fast_linalg``; the path in original coordinates."""
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        xs = _dalton.solve_sim(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight * t_vec.to(obs_weight.dtype),
            obs_var=obs_var, **params)
    return xs * t_vec.to(xs.dtype)


def dalton_solve_mv_nn(key, ode_fun, ode_weight, ode_init, t_min, t_max,
                       n_steps, interrogate, prior_pars, obs_data, obs_times,
                       obs_loglik_i, n_deriv=None, **params):
    r"""Preconditioned :func:`rodeo_tpu_torch.inference.dalton.solve_mv_nn`
    (non-Gaussian data), under ``fast_linalg``; the moments in original
    coordinates."""
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        mean_s, var_s = _dalton.solve_mv_nn(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, obs_data=obs_data, obs_times=obs_times,
            obs_loglik_i=_wrap_obs_loglik(obs_loglik_i, t_vec), **params)
    return _unscale_moments(mean_s, var_s, t_vec)
