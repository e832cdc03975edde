r"""
Chkrebtii's second-order ODE (port of :mod:`rodeo_tpu.models.chkrebtii`):

.. math::

    \ddot x = \sin(2 t) - x, \qquad x(0) = -1, \ \dot x(0) = 0,

solved with one block of ``n_deriv = 4`` derivatives, the ODE weight
selecting the SECOND derivative (``W = [0, 0, 1, 0]``).  It has no
parameters: the fused kernels take a theta of one zero per lane.
"""
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.models import FusedModel
from rodeo_tpu_torch.prior import ibm_init

__all__ = ["chkrebtii_fun", "chkrebtii_flat", "chkrebtii_jac_flat", "setup",
           "FUSED"]

N_VARS = 1
N_DERIV = 4


def chkrebtii_fun(X_t, t, **params):
    """Chkrebtii's ODE in block form: ``X_t`` is ``(1, n_deriv)``."""
    return (torch.sin(2 * torch.as_tensor(t, dtype=X_t.dtype))
            - X_t[0, 0]).reshape(1, 1)


def chkrebtii_flat(x_cols, th, t):
    """Right-hand side in column form; the same arithmetic as the
    ``Chkrebtii`` CUDA functor, which reads ``t`` (a float32 time) through
    ``sinf``."""
    return torch.sin(2.0 * t) - x_cols[0]


def chkrebtii_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns: ``d f / d x = -1``, the other
    derivatives' columns zero."""
    x = x_cols[0]
    return [torch.zeros_like(x) - 1.0] + [None] * (len(x_cols) - 1)


FUSED = FusedModel(flat=chkrebtii_flat, jac_flat=chkrebtii_jac_flat,
                   cuda_functor="Chkrebtii", n_block=N_VARS, n_theta=1)


def setup(n_steps=30, t_min=0.0, t_max=10.0, prior_sigma=0.1,
          dtype=torch.float64, device=None, n_deriv=N_DERIV):
    """Solver configuration of the Chkrebtii benchmark, built on the CPU in
    ``dtype`` and moved to ``device`` (``None``: the CUDA card).
    ``n_deriv`` (4 in the JAX package's) pads the initial state with zeros
    beyond the fourth derivative; ``theta`` is ``None``."""
    device = resolve_device(device)
    W = torch.zeros((N_VARS, 1, n_deriv), dtype=dtype)
    W[:, :, 2] = 1.0
    x0 = torch.zeros((N_VARS, n_deriv), dtype=dtype)
    x0[0, :4] = torch.tensor([-1.0, 0.0, 1.0, 0.0], dtype=dtype)
    dt = (t_max - t_min) / n_steps
    prior_weight, prior_var = ibm_init(
        dt, n_deriv, torch.full((N_VARS,), prior_sigma, dtype=dtype))
    return dict(
        ode_fun=chkrebtii_fun,
        ode_weight=W.to(device),
        ode_init=x0.to(device),
        theta=None,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=(prior_weight.to(device), prior_var.to(device)),
    )
