r"""
SEIRAH six-compartment COVID-19 model (port of
:mod:`rodeo_tpu.models.seirah`):

.. math::

    \dot S = -b S (I + \alpha A)/N, \quad
    \dot E = b S (I + \alpha A)/N - E/D_e, \ldots

State :math:`(S, E, I, R, A, H)`, parameters
:math:`\theta = (b, r, \alpha, D_e, D_I, D_q)`.  It has no hand-written
Jacobian: EK1 takes the column of
:func:`~rodeo_tpu_torch.models.own_block_jacobian`.
"""
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.models import FusedModel, own_block_jacobian
from rodeo_tpu_torch.prior import ibm_init
from rodeo_tpu_torch.utils import first_order_pad

__all__ = ["seirah_fun", "seirah_flat", "seirah_jac_flat", "setup", "FUSED"]

N_VARS = 6
N_DERIV = 3
THETA = (2.23, 0.034, 0.55, 5.1, 2.3, 1.13)
X0 = (63884630.0, 15492.0, 21752.0, 0.0, 618013.0, 93583.0)
D_H = 30.0  # fixed hospitalization duration


def seirah_fun(X_t, t, theta):
    """SEIRAH in block form: ``X_t`` is ``(6, n_deriv)``."""
    b, r, alpha, D_e, D_I, D_q = (theta[i] for i in range(6))
    S, E, I, R, A, H = X_t[:, 0]
    N = S + E + I + R + A + H
    D_h = D_H
    dS = -b * S * (I + alpha * A) / N
    dE = b * S * (I + alpha * A) / N - E / D_e
    dI = r * E / D_e - I / D_q - I / D_I
    dR = (I + A) / D_I + H / D_h
    dA = (1 - r) * E / D_e - A / D_I
    dH = I / D_q - H / D_h
    return torch.stack([dS, dE, dI, dR, dA, dH])[:, None]


def seirah_flat(x_cols, th, t):
    """Right-hand side in column form; the same arithmetic, in the same
    order, as the ``Seirah`` CUDA functor.  ``H / D_H`` is a product with
    the float32 ``1 / D_H``, which PyTorch on CUDA takes for a division by
    a number, so the CPU, the card and the kernel round alike."""
    x0 = x_cols[0]
    S, E, I = x0[0:1], x0[1:2], x0[2:3]
    R, A, H = x0[3:4], x0[4:5], x0[5:6]
    b, r, alpha = th[0:1], th[1:2], th[2:3]
    D_e, D_I, D_q = th[3:4], th[4:5], th[5:6]
    N = S + E + I + R + A + H
    inf = b * S * (I + alpha * A) / N
    dS = -inf
    dE = inf - E / D_e
    dI = r * E / D_e - I / D_q - I / D_I
    dR = (I + A) / D_I + H * (1.0 / D_H)
    dA = (1.0 - r) * E / D_e - A / D_I
    dH = I / D_q - H * (1.0 / D_H)
    return torch.cat([dS, dE, dI, dR, dA, dH])


def seirah_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of :func:`seirah_flat`, column 0 by
    Duals (:func:`~rodeo_tpu_torch.models.own_block_jacobian`)."""
    return [own_block_jacobian(seirah_flat, x_cols, th, t)] \
        + [None] * (len(x_cols) - 1)


FUSED = FusedModel(flat=seirah_flat, jac_flat=seirah_jac_flat,
                   cuda_functor="Seirah", n_block=N_VARS, n_theta=6)


def setup(n_steps=80, t_min=0.0, t_max=60.0, prior_sigma=0.1,
          dtype=torch.float64, device=None):
    """Solver configuration of the SEIRAH benchmark, built on the CPU in
    ``dtype`` and moved to ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    theta = torch.tensor(THETA, dtype=dtype)
    W, pad = first_order_pad(seirah_fun, N_VARS, N_DERIV, dtype=dtype)
    x0 = pad(torch.tensor(X0, dtype=dtype), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_weight, prior_var = ibm_init(
        dt, N_DERIV, torch.full((N_VARS,), prior_sigma, dtype=dtype))
    return dict(
        ode_fun=seirah_fun,
        ode_weight=W.to(device),
        ode_init=x0.to(device),
        theta=theta.to(device),
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=(prior_weight.to(device), prior_var.to(device)),
    )
