r"""
rodeo-tpu-torch: the PyTorch / CUDA port of :mod:`rodeo_tpu` for one NVIDIA
Hopper GPU (H100).

The JAX package ``rodeo_tpu`` stays the reference; this package mirrors its
module names so that every function has an obvious counterpart, and holds
itself to the JAX package's numbers in ``tests/test_torch_*.py``.  It imports
``torch`` and never ``jax``.

Ported so far (the ``solve_mv`` slice):

- :func:`rodeo_tpu_torch.solve_mv`, :mod:`rodeo_tpu_torch.prior`,
  :mod:`rodeo_tpu_torch.interrogate`, :mod:`rodeo_tpu_torch.kalmantv`
  (standard form), :mod:`rodeo_tpu_torch.utils`;
- :mod:`rodeo_tpu_torch.ops.precond` (Taylor preconditioning);
- :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`, the
  lane-batched solve carried by two hand-written CUDA kernels
  (``ops/csrc/filter_batch.cu``, ``ops/csrc/smoother_batch.cu``).
"""

__version__ = "0.1.0"

from rodeo_tpu_torch import interrogate
from rodeo_tpu_torch import prior
from rodeo_tpu_torch.solve import solve_mv

__all__ = ["interrogate", "prior", "solve_mv"]
