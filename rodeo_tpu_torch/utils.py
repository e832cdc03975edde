r"""
Small batched linear-algebra helpers (port of :mod:`rodeo_tpu.utils`).

Every function is batch polymorphic: matrix arguments may carry any number of
leading batch dimensions (the ``n_block`` axis of the block-diagonal solver
state, the time axis of a hoisted smoother, ...).
"""
import math

import torch

__all__ = ["mtt", "mvdot", "quadform", "solve_var", "first_order_pad",
           "multivariate_normal_logpdf"]


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


def _mvn_logpdf_pieces(x, mean, cov):
    """The masked-eigen log-density and the quantities its derivatives
    reuse: ``(val, (w, v, z, live, w_safe))``.

    A direction is live where its eigenvalue clears both the reference's
    absolute screen (``isclose(w, 0)``) and a screen relative to the
    largest eigenvalue (100 eps of the dtype).  For 2 x 2 covariances the
    small eigenvalue is recomputed as ``det / lam_hi``, and kept where the
    determinant resolves above its own rounding (the JAX package's 2 x 2
    refinement)."""
    w, v = torch.linalg.eigh(cov)
    rel_tol = 100.0 * torch.finfo(cov.dtype).eps
    rel_live = None
    if cov.shape[-1] == 2:
        det = (cov[..., 0, 0] * cov[..., 1, 1]
               - cov[..., 0, 1] * cov[..., 1, 0])
        noise_mag = (cov[..., 0, 0] * cov[..., 1, 1]
                     + cov[..., 0, 1] * cov[..., 1, 0])
        hi = w[..., 1]
        lo = torch.where(hi != 0, det / torch.where(
            hi == 0, torch.ones_like(hi), hi), w[..., 0])
        w = torch.stack([lo, hi], dim=-1)
        rel_live = torch.stack(
            [det > rel_tol * noise_mag, hi > rel_tol * torch.abs(hi)],
            dim=-1)
    z = mvdot(mtt(v), x - mean)
    if rel_live is None:
        wmax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
        rel_live = w > rel_tol * wmax
    live = ~torch.isclose(w, torch.zeros_like(w), rtol=1e-300,
                          atol=1e-8) & rel_live
    w_safe = torch.where(live, w, torch.ones_like(w))
    val = z * z / w_safe + torch.log(w_safe)
    val = -0.5 * torch.sum(torch.where(live, val, torch.zeros_like(val)),
                           dim=-1)
    val = val - 0.5 * math.log(2 * math.pi) * torch.sum(live, dim=-1).to(
        val.dtype)
    return val, (w, v, z, live, w_safe)


def _pinv_terms(x, mean, cov):
    """``alpha`` (the masked pseudo-inverse times ``x - mean``, in the
    eigenbasis) and the pieces of :func:`_mvn_logpdf_pieces`."""
    _, (w, v, z, live, w_safe) = _mvn_logpdf_pieces(x, mean, cov)
    alpha = torch.where(live, z / w_safe, torch.zeros_like(z))
    return alpha, v, live, w_safe


class _MvnLogpdf(torch.autograd.Function):
    """The masked-eigen log-density with its derivative in closed form
    (constant-rank semantics): ``d val = -1/2 [2 a'(dx - dmean) - a' dcov a
    + tr(cov^+ dcov)]``, ``a = cov^+ (x - mean)``.  The derivative of
    ``eigh`` divides by eigenvalue gaps and is NaN on repeated eigenvalues,
    so it is never taken."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, mean, cov):
        return _mvn_logpdf_pieces(x, mean, cov)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, mean, cov = ctx.saved_tensors
        alpha, v, live, w_safe = _pinv_terms(x, mean, cov)
        a = mvdot(v, alpha)
        inv_w = torch.where(live, 1.0 / w_safe, torch.zeros_like(w_safe))
        pinv = (v * inv_w[..., None, :]) @ mtt(v)
        g_x = -g[..., None] * a
        g_cov = 0.5 * g[..., None, None] * (a[..., :, None] * a[..., None, :]
                                            - pinv)
        return (g_x.sum_to_size(x.shape), (-g_x).sum_to_size(mean.shape),
                g_cov.sum_to_size(cov.shape))

    @staticmethod
    def jvp(ctx, dx, dmean, dcov):
        x, mean, cov = ctx.saved_tensors
        alpha, v, live, w_safe = _pinv_terms(x, mean, cov)
        zero = torch.zeros_like(w_safe)
        term1 = 0.0
        if dx is not None or dmean is not None:
            dd = (dx if dx is not None else 0.0) - \
                (dmean if dmean is not None else 0.0)
            term1 = 2.0 * torch.sum(alpha * mvdot(mtt(v), dd), dim=-1)
        term23 = 0.0
        if dcov is not None:
            Mv = mtt(v) @ dcov @ v
            term2 = -torch.sum(alpha[..., :, None] * Mv * alpha[..., None, :],
                               dim=(-2, -1))
            Mdiag = torch.diagonal(Mv, dim1=-2, dim2=-1)
            term3 = torch.sum(torch.where(live, Mdiag / w_safe, zero), dim=-1)
            term23 = term2 + term3
        return -0.5 * (term1 + term23)


def multivariate_normal_logpdf(x, mean, cov):
    r"""
    Log-density of a (possibly singular) multivariate normal, batched over
    leading dims (port of :func:`rodeo_tpu.utils.multivariate_normal_logpdf`).

    An eigendecomposition masks the (near-)null directions, which then add
    neither to the quadratic form nor to the normalising constant.  The
    derivative (``torch.autograd`` and ``torch.func.jvp`` alike) is the
    analytic one of the masked pseudo-inverse, never that of ``eigh``.

    Args:
        x (Tensor(..., p)): Observation.
        mean (Tensor(..., p)): Mean.
        cov (Tensor(..., p, p)): Symmetric PSD covariance.

    Returns:
        (Tensor(...)): Log-density value(s).
    """
    return _MvnLogpdf.apply(x, mean, cov)
