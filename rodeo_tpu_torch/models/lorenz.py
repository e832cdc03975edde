r"""
Lorenz63 (port of :mod:`rodeo_tpu.models.lorenz`):

.. math::

    \dot x = \sigma(y - x), \quad
    \dot y = x(\rho - z) - y, \quad
    \dot z = x y - \beta z,

with :math:`(\rho, \sigma, \beta) = (28, 10, 8/3)` and
:math:`x_0 = (-12, -5, 38)`.
"""
import torch

from rodeo_tpu_torch.models import FusedModel
from rodeo_tpu_torch.prior import ibm_init
from rodeo_tpu_torch.utils import first_order_pad

__all__ = ["lorenz_fun", "lorenz_flat", "lorenz_jac_flat", "setup", "FUSED"]

N_VARS = 3
N_DERIV = 3
THETA = (28.0, 10.0, 8.0 / 3.0)
X0 = (-12.0, -5.0, 38.0)


def lorenz_fun(X_t, t, theta):
    """Lorenz63 in block form: ``X_t`` is ``(3, n_deriv)``."""
    rho, sigma, beta = theta[0], theta[1], theta[2]
    x, y, z = X_t[0, 0], X_t[1, 0], X_t[2, 0]
    dx = -sigma * x + sigma * y
    dy = rho * x - y - x * z
    dz = -beta * z + x * y
    return torch.stack([dx, dy, dz])[:, None]


def lorenz_flat(x_cols, th, t):
    """Right-hand side in column form (see
    :class:`rodeo_tpu_torch.models.FusedModel`); the same arithmetic, in the
    same order, as the ``Lorenz63`` CUDA functor."""
    x0 = x_cols[0]
    x, y, z = x0[0:1], x0[1:2], x0[2:3]
    rho, sigma, beta = th[0:1], th[1:2], th[2:3]
    f0 = -sigma * x + sigma * y
    f1 = rho * x - y - x * z
    f2 = -beta * z + x * y
    return torch.cat([f0, f1, f2])


def lorenz_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of :func:`lorenz_flat`: only the 0th
    derivative enters ``f``, with in-block partials
    ``(-sigma, -1, -beta)``."""
    sigma, beta = th[1:2], th[2:3]
    col0 = torch.cat([-sigma, -torch.ones_like(sigma), -beta])
    return [col0] + [None] * (N_DERIV - 1)


FUSED = FusedModel(flat=lorenz_flat, jac_flat=lorenz_jac_flat,
                   cuda_functor="Lorenz63", n_block=N_VARS, n_theta=3)


def setup(n_steps=10000, t_min=0.0, t_max=20.0, prior_sigma=5e7,
          dtype=torch.float32, device=None):
    """
    Solver configuration of the Lorenz63 benchmark.  Built on the CPU in
    ``dtype``, then moved to ``device``, so that every device gets the same
    numbers.

    Returns:
        dict with ``ode_fun, ode_weight, ode_init, theta, t_min, t_max,
        n_steps, prior_pars``, ready to splat into ``solve_mv``.
    """
    theta = torch.tensor(THETA, dtype=dtype)
    W, pad = first_order_pad(lorenz_fun, N_VARS, N_DERIV, dtype=dtype)
    x0 = pad(torch.tensor(X0, dtype=dtype), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_weight, prior_var = ibm_init(
        dt, N_DERIV, torch.full((N_VARS,), prior_sigma, dtype=dtype))
    return dict(
        ode_fun=lorenz_fun,
        ode_weight=W.to(device),
        ode_init=x0.to(device),
        theta=theta.to(device),
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=(prior_weight.to(device), prior_var.to(device)),
    )
