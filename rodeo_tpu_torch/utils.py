r"""
Small batched linear-algebra helpers (port of :mod:`rodeo_tpu.utils`).

Every function is batch polymorphic: matrix arguments may carry any number of
leading batch dimensions (the ``n_block`` axis of the block-diagonal solver
state, the time axis of a hoisted smoother, ...).
"""
import torch

__all__ = ["mtt", "mvdot", "quadform", "solve_var", "first_order_pad"]


def mtt(mat):
    """Matrix transpose on the trailing two dimensions."""
    return mat.transpose(-1, -2)


def mvdot(mat, vec):
    """Batched matrix-vector product on trailing dims: ``mat @ vec``."""
    return torch.einsum("...ij,...j->...i", mat, vec)


def quadform(wgt, var):
    """Batched quadratic form ``wgt @ var @ wgt.T`` on trailing dims, as two
    two-operand contractions: a three-operand ``torch.einsum`` asks
    opt_einsum for a contraction path on every call, which costs more than
    the product at these sizes."""
    return torch.einsum("...ik,...lk->...il",
                        torch.einsum("...ij,...jk->...ik", wgt, var), wgt)


def solve_var(V, B):
    r"""
    :math:`X = V^{-1} B` for a variance (symmetric positive-definite) ``V``,
    by a batched LU solve as the JAX package's default path.

    ``B`` may be a matrix ``(..., n, k)`` or a vector ``(..., n)``.
    """
    if B.ndim == V.ndim - 1:
        return torch.linalg.solve(V, B[..., None])[..., 0]
    return torch.linalg.solve(V, B)


def first_order_pad(ode_fun, n_vars, n_deriv, dtype=None, device=None):
    r"""
    ODE weight matrix ``W`` and an initial-state padding function for a
    first-order ODE system lifted to ``n_deriv`` derivatives.

    Args:
        ode_fun (Callable): Block-form ODE function ``f(X, t, **params)``.
        n_vars (int): Number of ODE variables (blocks).
        n_deriv (int): Number of derivatives per block in the solver state.
        dtype, device: Of ``W``.

    Returns:
        (tuple):
        - **W** (Tensor(n_vars, 1, n_deriv)): selects the first derivative
          of each block.
        - **ode_init** (Callable): ``ode_init(x0, t, **params)`` returning
          the zero-padded initial state ``(n_vars, n_deriv)``.
    """

    def ode_init(x0, t, **params):
        x0 = x0[:, None]
        zeros = x0.new_zeros((n_vars, n_deriv - 2))
        return torch.hstack([x0, ode_fun(x0, t, **params), zeros])

    W = torch.zeros((n_vars, 1, n_deriv), dtype=dtype, device=device)
    W[:, :, 1] = 1.0
    return W, ode_init
