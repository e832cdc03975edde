r"""
Taylor-mode preconditioning of the solver state (port of
:mod:`rodeo_tpu.ops.precond`: ``solve_mv``, ``daltonng`` and
``magi_logdens``).

The IBM prior over ``(x, x', ..., x^{(q)})`` with step ``dt`` has entries
spanning :math:`dt^{\pm q}`, beyond float32's range of precision on fine
grids.  In the coordinates :math:`\tilde x = T^{-1} x` with the diagonal

.. math:: T_{ii} = \sqrt{dt} \; dt^{\,q-i} / (q-i)!

the transition becomes the Pascal matrix and the noise a Hilbert-like
matrix, both :math:`O(1)`-conditioned.  :func:`solve_mv` runs
:func:`rodeo_tpu_torch.solve.solve_mv` in those coordinates; the fused
kernels of :mod:`rodeo_tpu_torch.ops.fused_kalman` assume them.
"""
import math

import torch

import rodeo_tpu_torch.solve as _solve
from rodeo_tpu_torch.inference import dalton as _dalton
from rodeo_tpu_torch.inference import magi as _magi

__all__ = ["taylor_scale", "scale_prior", "solve_mv", "daltonng",
           "magi_logdens"]


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


def scale_prior(prior_pars, t_vec):
    r"""
    Prior parameters in scaled coordinates:
    :math:`\tilde Q_{ij} = Q_{ij} t_j / t_i`,
    :math:`\tilde R_{ij} = R_{ij} / (t_i t_j)`.
    """
    prior_weight, prior_var = prior_pars
    t = t_vec.to(prior_weight.dtype)
    Qs = prior_weight * (t[None, :] / t[:, None])
    Rs = prior_var / (t[:, None] * t[None, :])
    return Qs, Rs


def _wrap_interrogate(interrogate, ode_weight_orig, t_vec):
    """Adapter between the scaled solver state and an interrogation written
    for original coordinates; the returned ``wgt_meas`` is scaled back."""

    def wrapped(key, ode_fun, ode_weight, t, mean_state_pred, var_state_pred,
                **params):
        t_v = t_vec.to(mean_state_pred.dtype)
        mean_orig = mean_state_pred * t_v
        # guard the user ODE's polynomial terms against float32 overflow
        if mean_orig.dtype == torch.float32:
            mean_orig = torch.clamp(torch.nan_to_num(mean_orig), -1e10, 1e10)
        var_orig = var_state_pred * (t_v[:, None] * t_v[None, :])
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight_orig, t=t,
            mean_state_pred=mean_orig, var_state_pred=var_orig, **params)
        return wgt_meas * t_v, mean_meas, var_meas

    return wrapped


def _scaled_inputs(ode_weight, ode_init, prior_pars, t_min, t_max, n_steps):
    """``t_vec`` and the weight, initial state and prior in scaled
    coordinates."""
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, ode_init.shape[-1], dtype=ode_init.dtype,
                         device=ode_init.device)
    return (t_vec,
            ode_weight * t_vec[None, None, :].to(ode_weight.dtype),
            ode_init / t_vec,
            scale_prior(prior_pars, t_vec))


def solve_mv(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
             interrogate, prior_pars, kalman_type="standard",
             temporal="sequential", **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.solve.solve_mv`: the same
    posterior up to rounding, computed in Taylor-scaled coordinates, which
    keeps the covariance filter finite in float32 and on priors as wide as
    Lorenz63's (``prior_sigma=5e7`` overflows the plain recursion even in
    float64).  Same signature and return contract.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps)
    mean_s, var_s = _solve.solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s, t_min=t_min,
        t_max=t_max, n_steps=n_steps,
        interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
        prior_pars=prior_s, kalman_type=kalman_type, temporal=temporal,
        **params)
    t_v = t_vec.to(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])


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
             kalman_type="standard", **params):
    r"""
    Preconditioned :func:`rodeo_tpu_torch.inference.dalton.daltonng`
    (non-Gaussian DALTON).  The two state-path log-densities (``logx_z`` and
    ``logx_yhat``) pick up the same change-of-variables Jacobian, which
    cancels in ``logy_x + logx_z - logx_yhat``, so the value is that of the
    plain implementation; the Laplace linearisation is chain-ruled through
    the scaling by :func:`_wrap_obs_loglik`.  Same signature and return.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps)
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
    subtracted, so the value matches the plain implementation.

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

    logdens_s = _magi.magi_logdens(
        ode_data_subset=ode_data_subset, ode_expand=ode_expand_s,
        n_active=n_active, prior_pars=prior_s, kalman_type=kalman_type,
        **params)
    jacobian = (n_steps_p1 - 1) * n_block * torch.sum(
        torch.log(t_vec[:n_active]))
    return logdens_s - jacobian
