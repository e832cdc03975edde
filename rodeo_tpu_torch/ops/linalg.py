r"""
Matmul precision guard (the port of
:func:`rodeo_tpu.ops.linalg.full_matmul_precision`) and the closed-form
inverse of tiny matrices (:func:`inv_small`).

On a TPU the JAX package forces "highest" matmul precision because the
default float32 ``dot_general`` runs bfloat16 passes, whose rounding the
chaotic Lorenz63 filter amplifies catastrophically.  The GPU's analogue is
TF32: PyTorch may run float32 matrix products (``allow_tf32`` on the cuBLAS
side) and convolutions (cuDNN) with 10-bit mantissas.  The guard switches
both off for the duration of a call and checks that they are off.
"""
import functools

import torch

__all__ = ["full_matmul_precision", "inv_small"]


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


def _det2(a):
    return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]


def inv_small(a):
    """Closed-form inverse over the trailing dims, up to 5 x 5 (batched),
    as :func:`rodeo_tpu.ops.linalg.inv_small` computes it.

    Scale-normalised: the determinant of an n x n adjugate grows like
    ``|a|**n``, which overflows float32 for entries beyond ~1e12, so the
    matrix is divided by its largest absolute entry first.
    """
    n = a.shape[-1]
    if n == 1:
        return 1.0 / a
    scale = torch.amax(torch.abs(a), dim=(-1, -2), keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return _inv_small_normed(a / scale) / scale


def _inv_small_normed(a):
    """The cofactor form for n <= 3; one 2 + (n - 2) Schur split for n = 4
    and 5, recursing into the cofactor forms."""
    n = a.shape[-1]
    if n == 2:
        det = _det2(a)[..., None, None]
        adj = torch.stack([
            torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
            torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
        ], dim=-2)
        return adj / det
    if n == 3:
        m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
        m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
        c00 = m11 * m22 - m12 * m21
        c01 = m12 * m20 - m10 * m22
        c02 = m10 * m21 - m11 * m20
        c10 = m02 * m21 - m01 * m22
        c11 = m00 * m22 - m02 * m20
        c12 = m01 * m20 - m00 * m21
        c20 = m01 * m12 - m02 * m11
        c21 = m02 * m10 - m00 * m12
        c22 = m00 * m11 - m01 * m10
        det = m00 * c00 + m01 * c01 + m02 * c02
        adj = torch.stack([
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    if n in (4, 5):
        k = 2
        A, B = a[..., :k, :k], a[..., :k, k:]
        Cc, D = a[..., k:, :k], a[..., k:, k:]
        Ainv = _inv_small_normed(A)
        AinvB = Ainv @ B
        CAinv = Cc @ Ainv
        Sinv = _inv_small_normed(D - CAinv @ B)
        UR = -(AinvB @ Sinv)
        UL = Ainv - UR @ CAinv
        LL = -(Sinv @ CAinv)
        top = torch.cat([UL, UR], dim=-1)
        bot = torch.cat([LL, Sinv], dim=-1)
        return torch.cat([top, bot], dim=-2)
    raise ValueError(f"inv_small supports n in (1, ..., 5), got {n}")
