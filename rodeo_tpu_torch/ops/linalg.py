r"""
Matmul precision guard (the port of
:func:`rodeo_tpu.ops.linalg.full_matmul_precision`), the fast-linalg switch
(:func:`fast_linalg`) and closed forms for tiny matrices: the inverse
(:func:`inv_small`), the determinant (:func:`_det_small_normed`), the
solves (:func:`solve_small`, :func:`solve_psd`, :func:`tri_solve_small`),
the log-density (:func:`mvn_logpdf_small`), the symmetric
eigendecomposition (:func:`sym_eigh_small`), the lower Cholesky factor
(:func:`chol_small`) and the gradient-safe eigen factor
(:func:`psd_factor_eigh`).

On a TPU the JAX package forces "highest" matmul precision because the
default float32 ``dot_general`` runs bfloat16 passes, whose rounding the
chaotic Lorenz63 filter amplifies catastrophically.  The GPU's analogue is
TF32: PyTorch may run float32 matrix products (``allow_tf32`` on the cuBLAS
side) and convolutions (cuDNN) with 10-bit mantissas.  The guard switches
both off for the duration of a call and checks that they are off.

The closed forms lose ``cond(A) * eps`` accuracy, so the solvers take them
only inside :func:`fast_linalg`, which the Taylor-preconditioned wrappers of
:mod:`rodeo_tpu_torch.ops.precond` enter (their matrices are
:math:`O(1)`-conditioned); outside it the solves are LAPACK's, as in the
JAX package.  The switch is read when a function runs, which in eager
PyTorch plays the part of the JAX package's trace time.
"""
import contextlib
import contextvars
import functools
import math

import torch

__all__ = ["full_matmul_precision", "fast_linalg", "fast_linalg_enabled",
           "inv_small", "mvn_logpdf_small", "solve_small", "solve_psd",
           "psd_factor_eigh", "sym_eigh_small", "chol_small",
           "tri_solve_small", "matmul_small"]


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


_FAST = contextvars.ContextVar("rodeo_tpu_torch_fast_linalg", default=False)


@contextlib.contextmanager
def fast_linalg(enable=True):
    """Within the context, tiny solves take their closed forms and the
    Kalman updates their Joseph forms (:func:`fast_linalg_enabled`)."""
    token = _FAST.set(enable)
    try:
        yield
    finally:
        _FAST.reset(token)


def fast_linalg_enabled():
    """Whether :func:`fast_linalg` is on in the current context."""
    return _FAST.get()


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


def _det_small_normed(a):
    """Closed-form determinant over the trailing dims, up to 5 x 5
    (batched); n = 4, 5 by the Schur split det(M) = det(A) det(D - C A^{-1}
    B).  Not scale-normalised: the caller passes an equilibrated matrix."""
    n = a.shape[-1]
    if n == 1:
        return a[..., 0, 0]
    if n == 2:
        return _det2(a)
    if n == 3:
        m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
        m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
        return (m00 * (m11 * m22 - m12 * m21)
                + m01 * (m12 * m20 - m10 * m22)
                + m02 * (m10 * m21 - m11 * m20))
    if n in (4, 5):
        k = 2
        A, B = a[..., :k, :k], a[..., :k, k:]
        Cc, D = a[..., k:, :k], a[..., k:, k:]
        return _det2(A) * _det_small_normed(D - Cc @ _inv_small_normed(A) @ B)
    raise ValueError(f"_det_small_normed supports n <= 5, got {n}")


def mvn_logpdf_small(x, mean, cov):
    r"""
    Multivariate-normal log-density by the closed-form determinant and
    solve, over trailing dims up to 5 (batched), as
    :func:`rodeo_tpu.ops.linalg.mvn_logpdf_small` computes it.
    Scale-normalised; the covariance must be positive definite
    (:func:`rodeo_tpu_torch.utils.multivariate_normal_logpdf` takes
    singular ones).

    Returns:
        (Tensor(...)): Log-density values.
    """
    n = cov.shape[-1]
    scale = torch.amax(torch.abs(cov), dim=(-1, -2), keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    det_n = _det_small_normed(cov / scale)
    tiny = torch.finfo(cov.dtype).tiny
    logdet = (n * torch.log(scale[..., 0, 0])
              + torch.log(torch.clamp(det_n, min=tiny)))
    z = x - mean
    quad = torch.sum(z * solve_small(cov, z), dim=-1)
    return -0.5 * (quad + logdet + n * 1.8378770664093453)


def solve_small(a, b):
    """
    ``a^{-1} b``: the closed form when the trailing dimension of ``a`` is at
    most 5 and :func:`fast_linalg` is on, an LU solve otherwise.  ``b`` is a
    matrix ``(..., n, k)`` or a vector ``(..., n)``.
    """
    n = a.shape[-1]
    vector = b.ndim == a.ndim - 1
    if not _FAST.get() or n > 5:
        if vector:
            return torch.linalg.solve(a, b[..., None])[..., 0]
        return torch.linalg.solve(a, b)
    if vector:
        if n == 1:
            return b / a[..., 0]
        return torch.einsum("...ij,...j->...i", inv_small(a), b)
    if n == 1:
        return b / a
    return inv_small(a) @ b


def _cholesky_or_nan(a):
    """Lower Cholesky factor, NaN where ``a`` is not positive definite (as
    the JAX package's factorisation returns, where PyTorch's raises)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))


def solve_psd(a, b):
    r"""
    ``a^{-1} b`` for a symmetric positive-definite ``a``, dispatched as
    :func:`rodeo_tpu.ops.linalg.solve_psd`: an LU solve with
    :func:`fast_linalg` off, the closed form for :math:`n \le 5` with it
    on, and a Cholesky factor with two triangular solves for :math:`n > 5`
    with it on (NaN where ``a`` is not positive definite).

    ``b`` is a matrix ``(..., n, k)`` or a vector ``(..., n)``.
    """
    n = a.shape[-1]
    if not _FAST.get() or n <= 5:
        return solve_small(a, b)
    vector = b.ndim == a.ndim - 1
    bb = b[..., None] if vector else b
    chol = _cholesky_or_nan(a)
    y = torch.linalg.solve_triangular(chol, bb, upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return x[..., 0] if vector else x


# Matrices per torch.linalg.eigh call in psd_factor_eigh.  On the H100 the
# batched eigh's workspace grows with the batch: 16 GB for the 30 000
# 3 x 3 float64 covariances of a 10 000-step Lorenz63 draw
# (tools/torch_op_costs.py), so a whole time axis is factored in chunks.
EIGH_CHUNK = 1024


def _eigh(cov, chunk=None):
    """``torch.linalg.eigh(cov)``, at most ``chunk`` (default
    :data:`EIGH_CHUNK`) matrices at a time."""
    chunk = EIGH_CHUNK if chunk is None else chunk
    flat = cov.reshape((-1,) + tuple(cov.shape[-2:]))
    if flat.shape[0] <= chunk:
        return torch.linalg.eigh(cov)
    w, v = zip(*(torch.linalg.eigh(c) for c in flat.split(chunk)))
    return (torch.cat(w).reshape(cov.shape[:-1]),
            torch.cat(v).reshape(cov.shape))


def _psd_factor_parts(cov):
    """The eigen factor and what its derivative reuses."""
    w, v = _eigh(cov)
    sqw = torch.sqrt(torch.clamp(w, min=0.0))
    eps = torch.finfo(w.dtype).eps
    scale = torch.clamp(torch.abs(w[..., -1:]), min=1.0)      # (..., 1)
    diff = w[..., None, :] - w[..., :, None]                  # l_j - l_i
    f = diff / (diff * diff + (eps * scale[..., None]) ** 2)  # safe 1/(l_j - l_i)
    f = f * (1.0 - torch.eye(w.shape[-1], dtype=w.dtype, device=w.device))
    # directions clamped to zero: d sqrt(max(w, 0)) = 0 there
    live = w > eps ** 0.5 * scale
    c = torch.where(live, 1.0 / (2.0 * sqw + eps * scale),
                    torch.zeros_like(w))
    return v, sqw, f, c


class _PsdFactorEigh(torch.autograd.Function):
    r"""The eigen factor with the JAX package's clamped derivative
    (``rodeo_tpu/ops/linalg.py``, ``_psd_factor_eigh_jvp``): with
    :math:`M = V' dC V`, :math:`dL = V (f \circ M) S + V
    \operatorname{diag}(c \circ \operatorname{diag} M)`, where
    :math:`f_{ij}` is the safe :math:`1/(\lambda_j - \lambda_i)`,
    :math:`S = \operatorname{diag}(\sqrt{\max(\lambda, 0)})` and
    :math:`c` masks the clamped directions to zero.  ``backward`` is its
    transpose, :math:`\bar C = V K V'` with :math:`K = f \circ (V' \bar L
    S) + \operatorname{diag}(c \circ \operatorname{diag}(V' \bar L))`;
    ``eigh``'s own derivative, NaN on repeated eigenvalues, is never
    taken."""

    @staticmethod
    def forward(cov):
        w, v = _eigh(cov)
        return v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (cov,) = ctx.saved_tensors
        v, sqw, f, c = _psd_factor_parts(cov)
        vg = v.mT @ g
        k = f * (vg * sqw[..., None, :])
        k = k + torch.diag_embed(c * torch.diagonal(vg, dim1=-2, dim2=-1))
        return v @ k @ v.mT

    @staticmethod
    def jvp(ctx, dcov):
        (cov,) = ctx.saved_tensors
        v, sqw, f, c = _psd_factor_parts(cov)
        m = v.mT @ dcov @ v
        dv = v @ (f * m)
        dsqw = c * torch.diagonal(m, dim1=-2, dim2=-1)
        return dv * sqw[..., None, :] + v * dsqw[..., None, :]


def psd_factor_eigh(cov):
    r"""
    PSD factor :math:`L = V \operatorname{diag}(\sqrt{\max(w, 0)})` with
    :math:`L L' = \mathrm{cov}`, from a symmetric eigendecomposition, with
    the gradient-safe derivative of
    :func:`rodeo_tpu.ops.linalg.psd_factor_eigh` (see
    :class:`_PsdFactorEigh`): exact where the eigensystem is simple, a
    bounded surrogate on the degenerate set, zero along clamped directions.

    Args:
        cov (Tensor(..., n, n)): Symmetric PSD matrices.

    Returns:
        (Tensor(..., n, n)): The factors.
    """
    return _PsdFactorEigh.apply(cov)


def sym_eigh_small(a):
    r"""
    Closed-form symmetric eigendecomposition over the trailing dims, up to
    3 x 3 (batched, elementwise operations only), formula for formula as
    :func:`rodeo_tpu.ops.linalg.sym_eigh_small`: which directions a masked
    log-density keeps depends on this rounding.

    Eigenvalues by the trigonometric solution of the characteristic cubic;
    eigenvectors by the Cayley-Hamilton construction (the image of two
    fixed probe vectors under :math:`\prod_{j \ne i}(A - \lambda_j I)`,
    the larger kept), completed to an orthonormal triple from the
    better-separated end of the spectrum.  Scale-normalised.

    Returns:
        (tuple): ``(w, v)``, the eigenvalues ascending and the eigenvectors
        as columns, as ``torch.linalg.eigh`` returns them.
    """
    n = a.shape[-1]
    if n == 1:
        return a[..., 0], torch.ones_like(a)
    scale = torch.amax(torch.abs(a), dim=(-1, -2), keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    A = a / scale
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    if n == 2:
        a00, a01, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
        tr2 = 0.5 * (a00 + a11)
        d = torch.sqrt(torch.clamp((0.5 * (a00 - a11)) ** 2 + a01 * a01,
                                   min=0.0))
        w = torch.stack([tr2 - d, tr2 + d], dim=-1)
        B = A - w[..., 1, None, None] * eye
        c0, c1 = B[..., :, 0], B[..., :, 1]
        pick = (torch.sum(c0 * c0, -1, keepdim=True)
                >= torch.sum(c1 * c1, -1, keepdim=True))
        v0 = torch.where(pick, c0, c1)
        v0 = v0 / torch.sqrt(torch.clamp(
            torch.sum(v0 * v0, -1, keepdim=True), min=1e-38))
        v1 = torch.stack([-v0[..., 1], v0[..., 0]], dim=-1)
        return w * scale[..., 0], torch.stack([v0, v1], dim=-1)
    if n != 3:
        raise ValueError("sym_eigh_small supports n <= 3")
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    qm = (a00 + a11 + a22) / 3.0
    p2 = ((a00 - qm) ** 2 + (a11 - qm) ** 2 + (a22 - qm) ** 2
          + 2.0 * p1)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-38))
    B = (A - qm[..., None, None] * eye) / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w_hi = qm + 2.0 * p * torch.cos(phi)
    w_lo = qm + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w_mid = 3.0 * qm - w_hi - w_lo
    w = torch.stack([w_lo, w_mid, w_hi], dim=-1)           # ascending
    u1 = torch.tensor([1.0, 0.62, 0.29], dtype=a.dtype, device=a.device)
    u2 = torch.tensor([-0.33, 0.81, 1.0], dtype=a.dtype, device=a.device)

    def eigvec(wj, wk):
        # v_i spans the column space of (A - wj I)(A - wk I); the image of
        # a probe u, as broadcast sums (no batched 3 x 3 matmuls)
        B1 = A - wj[..., None, None] * eye
        B2 = A - wk[..., None, None] * eye

        def image(u):
            b2u = torch.sum(B2 * u, dim=-1)
            return torch.sum(B1 * b2u[..., None, :], dim=-1)

        c1, c2 = image(u1), image(u2)
        n1 = torch.sum(c1 * c1, -1, keepdim=True)
        n2 = torch.sum(c2 * c2, -1, keepdim=True)
        v = torch.where(n1 >= n2, c1, c2)
        return v / torch.sqrt(torch.clamp(
            torch.sum(v * v, -1, keepdim=True), min=1e-38))

    v0c = eigvec(w[..., 1], w[..., 2])
    v2c = eigvec(w[..., 0], w[..., 1])
    low_sep = (w[..., 1] - w[..., 0]) >= (w[..., 2] - w[..., 1])
    anchor = torch.where(low_sep[..., None], v0c, v2c)
    # exact-isotropic input: both candidates vanish; seed with an axis
    a2 = torch.sum(anchor * anchor, -1, keepdim=True)
    anchor = torch.where(a2 > 0.5, anchor, eye[2].expand(anchor.shape))
    other = torch.where(low_sep[..., None], v2c, v0c)
    other = other - torch.sum(other * anchor, -1, keepdim=True) * anchor
    onorm = torch.sqrt(torch.clamp(
        torch.sum(other * other, -1, keepdim=True), min=1e-38))
    # the secondary collapsed onto the anchor (isotropic): the anchor's
    # least-aligned axis, re-projected
    fallback = eye[0] - anchor * anchor[..., 0:1]
    fb2 = eye[1] - anchor * anchor[..., 1:2]
    fa = torch.where(
        torch.abs(anchor[..., 0:1]) <= torch.abs(anchor[..., 1:2]),
        fallback, fb2)
    other = torch.where(onorm > 1e-6, other / onorm,
                        fa / torch.sqrt(torch.clamp(
                            torch.sum(fa * fa, -1, keepdim=True),
                            min=1e-38)))
    mid = torch.linalg.cross(anchor, other)
    mid = mid / torch.sqrt(torch.clamp(
        torch.sum(mid * mid, -1, keepdim=True), min=1e-38))
    v0 = torch.where(low_sep[..., None], anchor, other)
    v2 = torch.where(low_sep[..., None], other, anchor)
    v = torch.stack([v0, mid, v2], dim=-1)
    return w * scale[..., 0], v


def chol_small(a, floor=1e-12):
    r"""
    Closed-form lower Cholesky factor over the trailing dims, up to 5 x 5
    (batched), as :func:`rodeo_tpu.ops.linalg.chol_small` computes it.

    Normalised to correlation form with a *relative* pivot floor, since
    near-unit correlations cancel catastrophically in float32.  A floored
    pivot marks a numerically null direction; the entries below it are set
    to zero rather than divided by the floor, which would blow the later
    columns up by ~1/floor.
    """
    n = a.shape[-1]
    tiny = torch.finfo(a.dtype).tiny
    d = torch.sqrt(torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1),
                               min=tiny))                       # (..., n)
    corr = a / (d[..., :, None] * d[..., None, :])
    L = [[None] * n for _ in range(n)]
    ok = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = corr[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = torch.sqrt(torch.clamp(s, min=floor))
            else:
                L[i][j] = torch.where(ok[j], s / L[j][j],
                                      torch.zeros_like(s))
    zero = torch.zeros_like(corr[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2) * d[..., :, None]


def tri_solve_small(chol, b, lower=True, transpose=False):
    r"""
    Triangular solve by unrolled substitution over trailing dims up to 5
    (batched; ``b`` is ``(..., n, k)``), as
    :func:`rodeo_tpu.ops.linalg.tri_solve_small`; ``transpose=True`` solves
    against ``chol'``.
    """
    n = chol.shape[-1]
    if not lower:
        return tri_solve_small(chol.mT, b, lower=True,
                               transpose=not transpose)
    out = [None] * n
    order = range(n - 1, -1, -1) if transpose else range(n)
    for i in order:
        s = b[..., i, :]
        for k in (range(i + 1, n) if transpose else range(i)):
            entry = chol[..., k, i, None] if transpose else chol[..., i, k,
                                                                 None]
            s = s - entry * out[k]
        out[i] = s / chol[..., i, i, None]
    return torch.stack(out, dim=-2)


def matmul_small(a, b):
    """Batched matrix product as a broadcast product and sum under
    :func:`fast_linalg` with both trailing dims at most 8, ``@``
    otherwise (:func:`rodeo_tpu.ops.linalg.matmul_small`)."""
    if (_FAST.get() and a.shape[-1] <= 8 and a.shape[-2] <= 8
            and b.shape[-1] <= 8):
        return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)
    return a @ b
