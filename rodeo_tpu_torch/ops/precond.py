r"""
Taylor-mode preconditioning of the solver state (port of
:mod:`rodeo_tpu.ops.precond`, ``solve_mv`` only).

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

__all__ = ["taylor_scale", "scale_prior", "solve_mv"]


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

    def wrapped(ode_fun, ode_weight, t, mean_state_pred, var_state_pred,
                **params):
        t_v = t_vec.to(mean_state_pred.dtype)
        mean_orig = mean_state_pred * t_v
        # guard the user ODE's polynomial terms against float32 overflow
        if mean_orig.dtype == torch.float32:
            mean_orig = torch.clamp(torch.nan_to_num(mean_orig), -1e10, 1e10)
        var_orig = var_state_pred * (t_v[:, None] * t_v[None, :])
        wgt_meas, mean_meas, var_meas = interrogate(
            ode_fun=ode_fun, ode_weight=ode_weight_orig, t=t,
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


def solve_mv(ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
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
        ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s, t_min=t_min,
        t_max=t_max, n_steps=n_steps,
        interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
        prior_pars=prior_s, kalman_type=kalman_type, temporal=temporal,
        **params)
    t_v = t_vec.to(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])
