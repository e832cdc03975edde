r"""
Small batched linear-algebra helpers (port of :mod:`rodeo_tpu.utils`).

Every function is batch polymorphic: matrix arguments may carry any number of
leading batch dimensions (the ``n_block`` axis of the block-diagonal solver
state, the time axis of a hoisted smoother, ...).
"""
import math

import torch

__all__ = ["mtt", "matmul", "mvdot", "quadform", "add_sqrt", "solve_var", "mvncond",
           "standard_normals", "first_order_pad",
           "multivariate_normal_logpdf"]


def mtt(mat):
    """Matrix transpose on the trailing two dimensions."""
    return mat.transpose(-1, -2)


def matmul(a, b):
    """``a @ b``, as one ``torch.bmm`` when both are 3-D with the same
    leading dimension (the torch-ops' per-step operands): ``torch.matmul``
    broadcasts through expand and view operations there, which the Python
    loops of the torch-ops, forward and backward, pay per step."""
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]:
        return torch.bmm(a, b)
    return torch.matmul(a, b)


def mvdot(mat, vec):
    """Batched matrix-vector product on trailing dims: ``mat @ vec``."""
    return matmul(mat, vec.unsqueeze(-1)).squeeze(-1)


def quadform(wgt, var):
    """Batched quadratic form ``wgt @ var @ wgt.T`` on trailing dims, as two
    products (:func:`matmul`): an ``einsum`` dispatches several times as
    many operations."""
    return matmul(matmul(wgt, var), wgt.mT)


def add_sqrt(sqrt_A, sqrt_B):
    r"""
    A factor :math:`L` with :math:`L L' = A + B`, given factors
    :math:`A^{1/2}` and :math:`B^{1/2}` (port of
    :func:`rodeo_tpu.utils.add_sqrt`): the transposed R of the QR
    decomposition of the stacked transposed factors, or, under
    :func:`rodeo_tpu_torch.ops.linalg.fast_linalg` with :math:`n \le 5`,
    the closed-form Cholesky factor of the Gram sum
    :math:`A^{1/2} A^{1/2\prime} + B^{1/2} B^{1/2\prime}`.  The two differ
    by an orthogonal rotation: compare :math:`L L'`, not :math:`L`.

    Args:
        sqrt_A (Tensor(..., n, m_a)): Factor of ``A``.
        sqrt_B (Tensor(..., n, m_b)): Factor of ``B``.

    Returns:
        (Tensor(..., n, n)): ``L``.
    """
    from rodeo_tpu_torch.ops.linalg import chol_small, fast_linalg_enabled
    n = sqrt_A.shape[-2]
    if fast_linalg_enabled() and n <= 5:
        gram = ((sqrt_A[..., :, None, :] * sqrt_A[..., None, :, :]).sum(-1)
                + (sqrt_B[..., :, None, :] * sqrt_B[..., None, :, :]).sum(-1))
        return chol_small(gram)
    stacked = torch.cat([mtt(sqrt_A), mtt(sqrt_B)], dim=-2)
    _, r = torch.linalg.qr(stacked, mode="reduced")
    return mtt(r)


def solve_var(V, B):
    r"""
    :math:`X = V^{-1} B` for a variance (symmetric positive-definite) ``V``,
    through :func:`rodeo_tpu_torch.ops.linalg.solve_psd` as the JAX
    package's: a batched LU solve, or under ``fast_linalg`` the closed form
    (:math:`n \le 5`) or a Cholesky solve (:math:`n > 5`).

    ``B`` may be a matrix ``(..., n, k)`` or a vector ``(..., n)``.
    """
    from rodeo_tpu_torch.ops.linalg import solve_psd
    return solve_psd(V, B)


def mvncond(mu, Sigma, icond):
    r"""
    Gaussian conditional parameters (port of :func:`rodeo_tpu.utils.
    mvncond`): for :math:`y \sim N(\mu, \Sigma)`, ``A``, ``b`` and ``V``
    with :math:`y[\neg icond] \mid y[icond] \sim N(A\, y[icond] + b, V)`.

    Args:
        mu (Tensor(n,)): Mean of ``y``.
        Sigma (Tensor(n, n)): Covariance of ``y``.
        icond (Tensor(n,) of bool): Which entries are conditioned on.

    Returns:
        (tuple): ``A (n1, n2)``, ``b (n1,)`` and ``V (n1, n1)``, with
        ``n2 = sum(icond)`` and ``n1 = n - n2``.
    """
    icond = torch.as_tensor(icond, dtype=torch.bool, device=mu.device)
    free_idx = torch.nonzero(~icond)[:, 0]
    cond_idx = torch.nonzero(icond)[:, 0]
    S12 = Sigma[free_idx][:, cond_idx]
    S22 = Sigma[cond_idx][:, cond_idx]
    S21 = Sigma[cond_idx][:, free_idx]
    S11 = Sigma[free_idx][:, free_idx]
    eye = torch.eye(S22.shape[0], dtype=Sigma.dtype, device=Sigma.device)
    A = S12 @ solve_var(S22, eye)
    b = mu[~icond] - A @ mu[icond]
    V = S11 - A @ S21
    return A, b, V


def standard_normals(key, shape, like):
    r"""
    Standard normals of ``shape`` in ``like``'s dtype and on its device,
    from ``key``: a ``torch.Generator``, drawn from (on the generator's
    device, then moved), or a tensor of normals already drawn, which must
    have that shape.  This is the port's counterpart of a JAX key.
    """
    if isinstance(key, torch.Generator):
        z = torch.randn(shape, generator=key, dtype=like.dtype,
                        device=key.device)
        return z.to(like.device)
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            raise ValueError(f"normals of shape {tuple(key.shape)} given "
                             f"where {tuple(shape)} are drawn")
        return key.to(dtype=like.dtype, device=like.device)
    raise ValueError("a draw needs a torch.Generator or a tensor of "
                     f"standard normals as its key, got {type(key)!r}")


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
