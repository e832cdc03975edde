r"""
FitzHugh-Nagumo neuron model (port of :mod:`rodeo_tpu.models.fitzhugh`):

.. math::

    \dot V = c (V - V^3/3 + R), \qquad
    \dot R = -(V - a + b R) / c,

with :math:`\theta = (a, b, c) = (0.2, 0.2, 3)` and :math:`x_0 = (-1, 1)`.
"""
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.models import FusedModel
from rodeo_tpu_torch.prior import ibm_init
from rodeo_tpu_torch.utils import first_order_pad

__all__ = ["fitzhugh_fun", "fitzhugh_flat", "fitzhugh_jac_flat", "setup",
           "FUSED"]

N_VARS = 2
N_DERIV = 3
THETA = (0.2, 0.2, 3.0)
X0 = (-1.0, 1.0)


def fitzhugh_fun(X_t, t, theta):
    """FitzHugh-Nagumo in block form: ``X_t`` is ``(2, n_deriv)``."""
    a, b, c = theta[0], theta[1], theta[2]
    V, R = X_t[0, 0], X_t[1, 0]
    return torch.stack([c * (V - V * V * V / 3 + R),
                        -1.0 / c * (V - a + b * R)])[:, None]


def fitzhugh_flat(x_cols, th, t):
    """Right-hand side in column form; the same arithmetic, in the same
    order, as the ``FitzHughNagumo`` CUDA functor.  ``V^3 / 3`` is a product
    with the float32 ``1/3``, which PyTorch on CUDA also takes for a division
    by 3, so the CPU, the card and the kernel round alike."""
    x0 = x_cols[0]
    V, R = x0[0:1], x0[1:2]
    a, b, c = th[0:1], th[1:2], th[2:3]
    f0 = c * (V - V * V * V * (1.0 / 3.0) + R)
    f1 = -(V - a + b * R) / c
    return torch.cat([f0, f1])


def fitzhugh_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of :func:`fitzhugh_flat`:
    ``d f_V / dV = c (1 - V^2)``, ``d f_R / dR = -b / c``."""
    V = x_cols[0][0:1]
    b, c = th[1:2], th[2:3]
    col0 = torch.cat([c * (1.0 - V * V), -b / c])
    return [col0] + [None] * (len(x_cols) - 1)


FUSED = FusedModel(flat=fitzhugh_flat, jac_flat=fitzhugh_jac_flat,
                   cuda_functor="FitzHughNagumo", n_block=N_VARS, n_theta=3)


def setup(n_steps=250, t_min=0.0, t_max=10.0, prior_sigma=0.1,
          dtype=torch.float64, device=None, n_deriv=N_DERIV):
    """Solver configuration of the FitzHugh-Nagumo benchmark, built on the
    CPU in ``dtype`` and moved to ``device`` (``None``: the CUDA card).
    ``n_deriv`` beyond 3 pads the weight and the initial state with zeros
    past the third derivative, under the IBM prior of ``n_deriv``
    derivatives."""
    device = resolve_device(device)
    theta = torch.tensor(THETA, dtype=dtype)
    W, pad = first_order_pad(fitzhugh_fun, N_VARS, N_DERIV, dtype=dtype)
    x0 = pad(torch.tensor(X0, dtype=dtype), t_min, theta=theta)
    extra = n_deriv - N_DERIV
    W = torch.nn.functional.pad(W, (0, extra))
    x0 = torch.nn.functional.pad(x0, (0, extra))
    dt = (t_max - t_min) / n_steps
    prior_weight, prior_var = ibm_init(
        dt, n_deriv, torch.full((N_VARS,), prior_sigma, dtype=dtype))
    return dict(
        ode_fun=fitzhugh_fun,
        ode_weight=W.to(device),
        ode_init=x0.to(device),
        theta=theta.to(device),
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=(prior_weight.to(device), prior_var.to(device)),
    )
