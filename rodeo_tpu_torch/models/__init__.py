r"""
Benchmark ODE systems (port of :mod:`rodeo_tpu.models`): Lorenz63,
FitzHugh-Nagumo, Chkrebtii's second-order ODE, Hes1 and SEIRAH.

A model that the fused kernels can run carries a :class:`FusedModel`
named ``FUSED``: its right-hand side in column form for the plain
PyTorch path, and the name of the CUDA functor that computes the same
thing inside the kernel (``ops/csrc/models.cuh``).
"""
import dataclasses
from typing import Callable

import torch

__all__ = ["FusedModel", "own_block_jacobian"]


@dataclasses.dataclass(frozen=True)
class FusedModel:
    """A model as the fused kernels see it.

    Attributes:
        flat: ``flat(x_cols, th, t) -> (n_block, B)``, where ``x_cols`` is a
            list of ``n_deriv`` columns ``(n_block, B)`` (column ``j`` is
            the j-th derivative of every variable) and ``th`` is
            ``(n_theta, B)``.
        jac_flat: Same arguments; returns the list of block-diagonal
            Jacobian columns, ``None`` where a column is zero.
        cuda_functor: Name of the functor in ``ops/csrc/models.cuh``.
        n_block, n_theta: Number of variables and of parameters.
    """
    flat: Callable
    jac_flat: Callable
    cuda_functor: str
    n_block: int
    n_theta: int


def own_block_jacobian(flat, x_cols, th, t):
    r"""
    Column 0 of the block-diagonal Jacobian of ``flat`` (a model's
    right-hand side in column form), ``d f_b / d x_b`` for each block
    ``b``: ``flat`` evaluated once on
    :class:`~rodeo_tpu_torch.ops.dual.Dual` numbers along ``n_block``
    directions, direction ``b`` seeding block ``b``'s entry of column 0
    alone, and direction ``b``'s tangent of block ``b`` kept.  A kernel's
    thread evaluates its functor so on ``csrc/dual.cuh``'s Duals, seeding
    its own block (``jac0_own`` of ``csrc/block_step.cuh``): the same
    operations, so the same bits.  For models without a hand-written
    Jacobian (Hes1, SEIRAH), as the JAX package takes ``jvp_jac_flat``.

    Where the columns are Duals already (K11a's twin, carrying theta's
    tangents), the numbers nest: the seeds are constants along theta's
    directions, as the kernel's ``DualT<Dual>`` seeds are, and the column
    comes back a Dual carrying its own tangents along theta.

    Returns:
        (Tensor(n_block, B) or Dual): The Jacobian's column 0.
    """
    from rodeo_tpu_torch.ops.dual import Dual, constant, primal

    x0 = x_cols[0]
    x0v = primal(x0)
    n_block = x0v.shape[0]
    seed = torch.eye(n_block, dtype=x0v.dtype, device=x0v.device)
    seed = seed.reshape((n_block, n_block) + (1,) * (x0v.ndim - 1)).expand(
        (n_block,) + tuple(x0v.shape))
    if isinstance(x0, Dual):
        seed = constant(seed, x0.n_dir)
    out = flat([Dual(x0, seed)] + list(x_cols[1:]), th, t)
    return _own_blocks(out.d, 0)


def _own_blocks(d, axis):
    """Direction ``b``'s tangent of block ``b``: the diagonal of ``d``'s
    axes ``axis`` (the directions) and ``axis + 1`` (the blocks), in the
    blocks' place; of a Dual's value and tangents alike."""
    from rodeo_tpu_torch.ops.dual import Dual

    if isinstance(d, Dual):
        return Dual(_own_blocks(d.v, axis), _own_blocks(d.d, axis + 1))
    return torch.diagonal(d, dim1=axis, dim2=axis + 1).movedim(-1, axis)
