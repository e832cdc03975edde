r"""
Benchmark ODE systems (port of :mod:`rodeo_tpu.models`: Lorenz63 and
FitzHugh-Nagumo so far).

A model that the fused kernels can run carries a :class:`FusedModel`
named ``FUSED``: its right-hand side in column form for the plain
PyTorch path, and the name of the CUDA functor that computes the same
thing inside the kernel (``ops/csrc/models.cuh``).
"""
import dataclasses
from typing import Callable

__all__ = ["FusedModel"]


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
