r"""
Hes1 gene-regulation oscillator on the log scale (port of
:mod:`rodeo_tpu.models.hes1`):

.. math::

    \dot P = -a H + b M / P - c, \quad
    \dot M = -d + e / (1 + P^2) / M, \quad
    \dot H = -a P + f/(H (1 + P^2)) - g,

solved for :math:`X = (\log P, \log M, \log H)`, with :math:`\theta = (a,
b, c, d, e, f, g)`.  It has no hand-written Jacobian: EK1 takes the
column of :func:`~rodeo_tpu_torch.models.own_block_jacobian`.
"""
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.models import FusedModel, own_block_jacobian
from rodeo_tpu_torch.prior import ibm_init
from rodeo_tpu_torch.utils import first_order_pad

__all__ = ["hes1_fun", "hes1_flat", "hes1_jac_flat", "setup", "FUSED"]

N_VARS = 3
N_DERIV = 3
THETA = (0.022, 0.3, 0.031, 0.028, 0.5, 20.0, 0.3)
X0 = (1.439, 2.037, 17.904)  # (P, M, H) levels


def hes1_fun(X_t, t, theta):
    """Hes1 in log-scale block form: ``X_t`` is ``(3, n_deriv)``."""
    a, b, c, d, e, f, g = (theta[i] for i in range(7))
    P, M, H = torch.exp(X_t[:, 0])
    dP = -a * H + b * M / P - c
    dM = -d + e / (1 + P * P) / M
    dH = -a * P + f / (H * (1 + P * P)) - g
    return torch.stack([dP, dM, dH])[:, None]


def hes1_flat(x_cols, th, t):
    """Right-hand side in column form (log scale); the same arithmetic, in
    the same order, as the ``Hes1`` CUDA functor."""
    x0 = x_cols[0]
    P, M, H = torch.exp(x0[0:1]), torch.exp(x0[1:2]), torch.exp(x0[2:3])
    a, b, c = th[0:1], th[1:2], th[2:3]
    d, e, f, g = th[3:4], th[4:5], th[5:6], th[6:7]
    one_p2 = 1.0 + P * P
    dP = -a * H + b * M / P - c
    dM = -d + e / one_p2 / M
    dH = -a * P + f / (H * one_p2) - g
    return torch.cat([dP, dM, dH])


def hes1_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of :func:`hes1_flat`, column 0 by
    Duals (:func:`~rodeo_tpu_torch.models.own_block_jacobian`)."""
    return [own_block_jacobian(hes1_flat, x_cols, th, t)] \
        + [None] * (len(x_cols) - 1)


FUSED = FusedModel(flat=hes1_flat, jac_flat=hes1_jac_flat,
                   cuda_functor="Hes1", n_block=N_VARS, n_theta=7)


def setup(n_steps=120, t_min=0.0, t_max=240.0, prior_sigma=0.1,
          dtype=torch.float64, device=None):
    """Solver configuration of the Hes1 benchmark, built on the CPU in
    ``dtype`` and moved to ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    theta = torch.tensor(THETA, dtype=dtype)
    W, pad = first_order_pad(hes1_fun, N_VARS, N_DERIV, dtype=dtype)
    x0 = pad(torch.log(torch.tensor(X0, dtype=dtype)), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_weight, prior_var = ibm_init(
        dt, N_DERIV, torch.full((N_VARS,), prior_sigma, dtype=dtype))
    return dict(
        ode_fun=hes1_fun,
        ode_weight=W.to(device),
        ode_init=x0.to(device),
        theta=theta.to(device),
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=(prior_weight.to(device), prior_var.to(device)),
    )
