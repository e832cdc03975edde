r"""
q-times integrated Brownian motion (IBM) solution prior (port of
:mod:`rodeo_tpu.prior.ibm`).

For the prior :math:`x^{(q)}(t) = \sigma B(t)` the discrete-time transition
and process-noise matrices are

.. math::

    Q_{ij} = \mathbb{1}_{i \le j} \frac{(\Delta t)^{j-i}}{(j-i)!}, \qquad
    R_{ij} = \sigma^2
      \frac{(\Delta t)^{2q-1-i-j}}{(2q-1-i-j)\,(q-i)!\,(q-j)!}.

The ``dt`` powers are iterated products and the factorials exact Python
integers, as in the JAX package, so both build the same numbers.
"""
import math

import torch

__all__ = ["ibm_state", "ibm_init"]


def ibm_state(dt, q, sigma, dtype=torch.float64, device=None):
    r"""
    Transition ``Q`` and process noise ``R`` of the q-times integrated
    Brownian motion over a step ``dt``.

    Args:
        dt (float | Tensor): Step size.
        q (int): Number of integrations (the state has ``q + 1`` entries).
        sigma (float): Diffusion scale.
        dtype, device: Of the result.

    Returns:
        (tuple): ``Q`` (q+1, q+1) and ``R`` (q+1, q+1).
    """
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    pows = [torch.ones_like(dt)]
    for _ in range(2 * q + 1):
        pows.append(pows[-1] * dt)
    Q = torch.stack([
        torch.stack([pows[j - i] / math.factorial(j - i)
                     if j >= i else torch.zeros_like(dt)
                     for j in range(q + 1)])
        for i in range(q + 1)])
    R = torch.stack([
        torch.stack([pows[2 * q + 1 - i - j]
                     / ((2 * q + 1 - i - j)
                        * math.factorial(q - i) * math.factorial(q - j))
                     for j in range(q + 1)])
        for i in range(q + 1)])
    return Q, sigma ** 2 * R


def ibm_init(dt, n_deriv, sigma):
    r"""
    Stacked block IBM prior: one ``(q+1, q+1)`` pair with unit diffusion,
    broadcast to ``n_block = len(sigma)`` blocks, the noise of block ``b``
    scaled by ``sigma[b]**2``.  Built in ``sigma``'s dtype and on its
    device.

    Args:
        dt (float): Step size.
        n_deriv (int): State dimension per block (``q + 1``).
        sigma (Tensor(n_block)): Per-block diffusion scales.

    Returns:
        (tuple):
        - **prior_weight** (Tensor(n_block, n_deriv, n_deriv)): :math:`Q`.
        - **prior_var** (Tensor(n_block, n_deriv, n_deriv)): :math:`R`.
    """
    n_block = sigma.shape[0]
    wgt_one, var_one = ibm_state(dt, n_deriv - 1, 1.0, dtype=sigma.dtype,
                                 device=sigma.device)
    prior_weight = wgt_one.expand((n_block,) + wgt_one.shape)
    prior_var = sigma[:, None, None] ** 2 * var_one
    return prior_weight, prior_var
