r"""
Matmul precision guard (the port of
:func:`rodeo_tpu.ops.linalg.full_matmul_precision`).

On a TPU the JAX package forces "highest" matmul precision because the
default float32 ``dot_general`` runs bfloat16 passes, whose rounding the
chaotic Lorenz63 filter amplifies catastrophically.  The GPU's analogue is
TF32: PyTorch may run float32 matrix products (``allow_tf32`` on the cuBLAS
side) and convolutions (cuDNN) with 10-bit mantissas.  The guard switches
both off for the duration of a call and checks that they are off.
"""
import functools

import torch

__all__ = ["full_matmul_precision"]


def full_matmul_precision(fn):
    """Run ``fn`` with TF32 off for float32 matmuls and cuDNN, restoring the
    caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32):
                raise RuntimeError("TF32 could not be switched off")
            return fn(*args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    return wrapped
