r"""
Lane-batched fused solve on the GPU (port of the batch path of
:mod:`rodeo_tpu.ops.pallas_kalman`: ``fused_filter_batch(emit="gains")``,
``smoother_recursion_batch`` and ``solve_mv_fused_batch``).

``B`` independent solves (parameter candidates, MCMC chains) ride one pair
of kernels, batched along a trailing lane axis:

- **K1** ``csrc/filter_batch.cu`` replaces ``_filter_kernel_batch``: the
  whole forward EK1 / EK0 filter, the ODE right-hand side evaluated inside
  the kernel, emitting the per-step smoothing gains ``(G, g, L)``;
- **K2** ``csrc/smoother_batch.cu`` replaces ``_smoother_kernel_batch``:
  the reverse affine recursion ``m_n = g_n + G_n m_{n+1}``,
  ``P_n = L_n + G_n P_{n+1} G_n'``.

Each kernel has a plain PyTorch twin here (``_filter_batch_plain``,
``_smoother_batch_plain``): the same algebra, operation for operation, on
``(n_block, B)`` columns with a Python loop over steps.  A wrapper takes
the twin only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts the kernel launches.

The kernels work in float32 in the Taylor-scaled coordinates of
:mod:`rodeo_tpu_torch.ops.precond`, with the Joseph-form update, as the
TPU kernels did.  Covariances are packed upper triangles in
:func:`_tri_idx` order.
"""
import ctypes
import importlib
import math

import numpy as np
import torch

from rodeo_tpu_torch.models import FusedModel
from rodeo_tpu_torch.ops import _build
from rodeo_tpu_torch.ops.precond import taylor_scale, scale_prior

__all__ = ["fused_filter_batch", "smoother_recursion_batch",
           "solve_mv_fused_batch", "resolve_kalman_type", "unpack_cov",
           "LAUNCHES"]

# kernel launches since the last reset, by kernel
LAUNCHES = {"filter_batch": 0, "smoother_batch": 0}

# interrogation modes and model functors, numbered as the C entry point
# rodeo_filter_batch (csrc/filter_batch.cu) numbers them
_MODES = {"kramer": 0, "rodeo": 1}
_FUNCTORS = {"Lorenz63": 0, "FitzHughNagumo": 1}
_KERNEL_Q = 3   # the state size per block the kernels are instantiated for


def _tri_idx(q):
    """Upper-triangle (i, j) pairs and a dense->packed index map."""
    pairs = [(i, j) for i in range(q) for j in range(i, q)]
    where = {}
    for k, (i, j) in enumerate(pairs):
        where[(i, j)] = k
        where[(j, i)] = k
    return pairs, where


def _coef_mul(a, col):
    """Multiply a column by a coefficient that is either a Python float
    (0.0 -> dropped, 1.0 -> identity) or a column."""
    if isinstance(a, float):
        if a == 0.0:
            return None
        if a == 1.0:
            return col
    return a * col


def _acc(acc, term):
    if term is None:
        return acc
    return term if acc is None else acc + term


def _sym_quadform(q, A, P_cols, where):
    """Columns of the upper triangle of ``A P A'``, ``A`` a list of lists
    of coefficients and ``P_cols`` packed symmetric."""
    T = [[None] * q for _ in range(q)]
    for i in range(q):
        for k in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, _coef_mul(A[i][j], P_cols[where[(j, k)]]))
            T[i][k] = acc
    out = []
    for i in range(q):
        for l in range(i, q):
            acc = None
            for k in range(q):
                if T[i][k] is None:
                    continue
                acc = _acc(acc, _coef_mul(A[l][k], T[i][k]))
            out.append(acc)
    return out


def _matvec(q, A, v_cols):
    """Columns of ``A v`` with the same coefficient conventions."""
    out = []
    for i in range(q):
        acc = None
        for j in range(q):
            acc = _acc(acc, _coef_mul(A[i][j], v_cols[j]))
        out.append(acc)
    return out


def _sym_inv(q, p_cols):
    """Closed-form inverse of a packed-symmetric matrix in column
    arithmetic, scale-normalised against float32 determinant overflow:
    cofactor forms for q <= 3, one 2 + (q-2) Schur split for q = 4, 5."""
    if q == 1:
        return [1.0 / p_cols[0]]
    if q == 2:
        a, b, d = p_cols
        inv_det = 1.0 / (a * d - b * b)
        return [d * inv_det, -b * inv_det, a * inv_det]
    if q == 3:
        a, b, c, d, e, f = p_cols  # [00,01,02,11,12,22]
        s = torch.maximum(torch.abs(a),
                          torch.maximum(torch.abs(d), torch.abs(f)))
        rs = 1.0 / torch.clamp(s, min=1e-30)
        a, b, c, d, e, f = a * rs, b * rs, c * rs, d * rs, e * rs, f * rs
        co00 = d * f - e * e
        co01 = c * e - b * f
        co02 = b * e - c * d
        co11 = a * f - c * c
        co12 = b * c - a * e
        co22 = a * d - b * b
        det = a * co00 + b * co01 + c * co02
        inv_det = rs / det
        return [co00 * inv_det, co01 * inv_det, co02 * inv_det,
                co11 * inv_det, co12 * inv_det, co22 * inv_det]
    if q in (4, 5):
        pairs, where = _tri_idx(q)
        diag = [p_cols[where[(i, i)]] for i in range(q)]
        s = diag[0]
        for dcol in diag[1:]:
            s = torch.maximum(torch.abs(s), torch.abs(dcol))
        rs = 1.0 / torch.clamp(s, min=1e-30)
        pc = [col * rs for col in p_cols]
        k, m = 2, q - 2
        # M = [[A, B], [B', D]] with A (k,k), B (k,m), D (m,m)
        Ainv = _sym_inv(k, [pc[where[(0, 0)]], pc[where[(0, 1)]],
                            pc[where[(1, 1)]]])
        _, whA = _tri_idx(k)
        B = [[pc[where[(i, k + j)]] for j in range(m)] for i in range(k)]
        # C = A^{-1} B
        C = [[None] * m for _ in range(k)]
        for i in range(k):
            for j in range(m):
                acc = None
                for l in range(k):
                    acc = _acc(acc, Ainv[whA[(i, l)]] * B[l][j])
                C[i][j] = acc
        # Schur complement S = D - B' C (packed symmetric)
        _, whS = _tri_idx(m)
        S_cols = []
        for i in range(m):
            for j in range(i, m):
                acc = pc[where[(k + i, k + j)]]
                for l in range(k):
                    acc = acc - B[l][i] * C[l][j]
                S_cols.append(acc)
        Sinv = _sym_inv(m, S_cols)
        # inverse blocks: UL = A^{-1} + C S^{-1} C', UR = -C S^{-1},
        # LR = S^{-1}
        UR = [[None] * m for _ in range(k)]
        for i in range(k):
            for j in range(m):
                acc = None
                for l in range(m):
                    acc = _acc(acc, C[i][l] * Sinv[whS[(l, j)]])
                UR[i][j] = -acc
        out = []
        for i in range(q):
            for j in range(i, q):
                if j < k:                       # UL block
                    acc = Ainv[whA[(i, j)]]
                    for l in range(m):
                        acc = acc - UR[i][l] * C[j][l]
                    out.append(acc * rs)
                elif i < k:                     # UR block
                    out.append(UR[i][j - k] * rs)
                else:                           # LR block
                    out.append(Sinv[whS[(i - k, j - k)]] * rs)
        return out
    raise NotImplementedError("the fused solve supports q <= 5")


def _static_scaled_qconst(prior_weight_raw, dt, q):
    """Entries of the Taylor-scaled transition as Python floats holding
    float32 values, computed in float64 from the raw (unscaled) prior and
    then rounded to float32, as the JAX package does.  None if the
    transition differs across blocks."""
    qw = prior_weight_raw.detach().to("cpu", torch.float64).numpy()
    if not np.all(qw == qw[0]):
        return None
    i = np.arange(q, dtype=np.float64)
    lgam = np.array([math.lgamma(q - k) for k in range(q)])
    tv = np.sqrt(dt) * dt ** (q - 1.0 - i) / np.exp(lgam)
    qs = qw[0] * (tv[None, :] / tv[:, None])
    return [[float(np.float32(qs[i2, j2])) for j2 in range(q)]
            for i2 in range(q)]


def _gain_cols_batched(q, n_tri, q_const, R_cols, mf_cols, pf_cols,
                       mpn_cols, ppn_cols):
    """Smoothing gain ``G``, offset ``g`` and Joseph-form noise ``L`` of the
    transition n-1 -> n, from the filtered moments at n-1 and the predicted
    ones at n, in column arithmetic.

    Returns (G as a list of lists of columns, g columns, L packed columns).
    """
    pairs, where = _tri_idx(q)
    ppinv = _sym_inv(q, ppn_cols)
    # T1 = Pf Q'  (T1[i][l] = sum_j Pf(i,j) Q[l][j])
    T1 = [[None] * q for _ in range(q)]
    for i in range(q):
        for l in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, _coef_mul(q_const[l][j],
                                          pf_cols[where[(i, j)]]))
            T1[i][l] = acc
    G = [[None] * q for _ in range(q)]
    for i in range(q):
        for l in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, T1[i][j] * ppinv[where[(j, l)]])
            G[i][l] = acc
    g = []
    for i in range(q):
        acc = mf_cols[i]
        for j in range(q):
            acc = acc - G[i][j] * mpn_cols[j]
        g.append(acc)
    # Joseph offset: L = (I - G Q) Pf (I - G Q)' + G R G'
    IGQ = [[None] * q for _ in range(q)]
    for i in range(q):
        for j in range(q):
            s = None
            for k in range(q):
                s = _acc(s, _coef_mul(q_const[k][j], G[i][k]))
            IGQ[i][j] = 1.0 - s if i == j else -s
    L = _sym_quadform(q, IGQ, pf_cols, where)
    GR = _sym_quadform(q, G, R_cols, where)
    L = [L[k] + GR[k] for k in range(n_tri)]
    return G, g, L


def _pack_tri(mat, pairs):
    """(..., q, q) -> packed upper triangle (..., n_tri)."""
    return torch.stack([mat[..., i, j] for (i, j) in pairs], dim=-1)


def unpack_cov(packed):
    """Expand a packed upper-triangular covariance (..., n_tri) into a
    dense symmetric (..., q, q) matrix (for slices of
    :func:`solve_mv_fused_batch` output)."""
    n_tri = packed.shape[-1]
    q = {1: 1, 3: 2, 6: 3, 10: 4, 15: 5}[n_tri]
    _, where = _tri_idx(q)
    rows = [torch.stack([packed[..., where[(i, j)]] for j in range(q)],
                        dim=-1) for i in range(q)]
    return torch.stack(rows, dim=-2)


def resolve_kalman_type(kalman_type):
    """Normalise the fused entry's ``kalman_type``: ``"standard"``, or
    ``"sqrt"`` for any of its spellings."""
    valid = {"standard": "standard", "sqrt": "sqrt",
             "square-root": "sqrt", "square_root": "sqrt"}
    if kalman_type not in valid:
        raise ValueError(
            "kalman_type must be one of 'standard', 'sqrt'/'square-root'; "
            f"got {kalman_type!r}")
    return valid[kalman_type]


def resolve_model(model):
    """The :class:`~rodeo_tpu_torch.models.FusedModel` of ``model``: a
    model name (``"lorenz"``), a model module or a FusedModel."""
    if isinstance(model, str):
        try:
            model = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
        except ModuleNotFoundError:
            raise NotImplementedError(f"unknown model {model!r}") from None
    fused = model if isinstance(model, FusedModel) else \
        getattr(model, "FUSED", None)
    if fused is None or fused.cuda_functor not in _FUNCTORS:
        raise NotImplementedError(
            f"model {model!r} has no CUDA functor; the fused kernels "
            f"support {sorted(_FUNCTORS)}")
    return fused


def _check(name, t, shape, device):
    """Validate one kernel operand: float32, contiguous, on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(device):
    if device.type != "cuda":
        raise NotImplementedError(
            f"the fused kernels run on CUDA tensors (plain PyTorch on CPU "
            f"tensors); got a tensor on {device}")
    return device


def _raise_on_error(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")


# --- K1: forward filter emitting smoothing gains ------------------------------


def _filter_batch_plain(model, n_steps, q_const, prior_var, ode_weight,
                        t_vec, x0_lanes, theta_lanes, tgrid, mode):
    """Plain PyTorch twin of ``csrc/filter_batch.cu``: the same arithmetic
    in the same order on ``(n_block, B)`` columns, one Python iteration per
    step.  Arguments and returns as :func:`fused_filter_batch` (``model``
    resolved)."""
    q, n_block, n_lane = x0_lanes.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]  # (nb, 1) bcast
    W_cols = [ode_weight[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    G_out = x0_lanes.new_empty((n_steps, q * q, n_block, n_lane))
    g_out = x0_lanes.new_empty((n_steps, q, n_block, n_lane))
    L_out = x0_lanes.new_empty((n_steps, n_tri, n_block, n_lane))
    m_cols = list(x0_lanes)
    p_cols = [torch.zeros_like(x0_lanes[0]) for _ in range(n_tri)]
    for n in range(n_steps):
        mp_cols = _matvec(q, q_const, m_cols)
        pp_cols = _sym_quadform(q, q_const, p_cols, where)
        pp_cols = [pp_cols[k] + R_cols[k] for k in range(n_tri)]
        # the gain of the transition n-1 -> n needs only the carry
        # (filtered n-1) and the fresh prediction (n)
        G, g, L = _gain_cols_batched(q, n_tri, q_const, R_cols, m_cols,
                                     p_cols, mp_cols, pp_cols)
        G_out[n] = torch.stack([G[i][j] for i in range(q)
                                for j in range(q)])
        g_out[n] = torch.stack(g)
        L_out[n] = torch.stack(L)
        x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
        f0 = model.flat(x_cols, theta_lanes, tgrid[n])
        jd_cols = model.jac_flat(x_cols, theta_lanes, tgrid[n]) \
            if mode == "kramer" else [None] * q
        H_cols = [W_cols[j] if jd_cols[j] is None
                  else W_cols[j] - jd_cols[j] * tv_cols[j] for j in range(q)]
        hm = None
        for j in range(q):
            hm = _acc(hm, H_cols[j] * mp_cols[j])
        mm = -f0
        for j in range(q):
            if jd_cols[j] is not None:
                mm = mm + jd_cols[j] * x_cols[j]
        z = -(hm + mm)
        PH_cols = []
        for i in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, pp_cols[where[(i, j)]] * H_cols[j])
            PH_cols.append(acc)
        S = None
        for i in range(q):
            S = _acc(S, H_cols[i] * PH_cols[i])
        if mode == "rodeo":
            S = S + S                    # V = W Sigma_p W' doubles S
        inv_S = 1.0 / S
        gain = [PH_cols[i] * inv_S for i in range(q)]
        m_cols = [mp_cols[i] + gain[i] * z for i in range(q)]
        IKW = [[(1.0 if i == j else 0.0) - gain[i] * H_cols[j]
                for j in range(q)] for i in range(q)]
        p_cols = _sym_quadform(q, IKW, pp_cols, where)
        if mode == "rodeo":
            V = S * 0.5
            p_cols = [p_cols[k] + gain[i] * gain[j] * V
                      for k, (i, j) in enumerate(pairs)]
    return G_out, g_out, L_out, torch.stack(m_cols), torch.stack(p_cols)


def fused_filter_batch(model, n_steps, q_const, prior_var, ode_weight,
                       t_vec, x0_lanes, theta_lanes, tgrid, mode="kramer"):
    r"""
    Lane-batched forward filter emitting per-step smoothing gains (kernel
    K1).  All tensors float32, in Taylor-scaled coordinates.

    Args:
        model: Model name, module or
            :class:`~rodeo_tpu_torch.models.FusedModel`.
        n_steps (int): Number of filter steps ``N``.
        q_const (list of lists of float): Scaled transition (shared by all
            blocks), from :func:`_static_scaled_qconst`.
        prior_var (Tensor(n_block, q, q)): Scaled process noise.
        ode_weight (Tensor(n_block, q)): Scaled weight ``W``.
        t_vec (Tensor(q,)): Taylor scales (original = scaled * t_vec).
        x0_lanes (Tensor(q, n_block, B)): Scaled initial states.
        theta_lanes (Tensor(n_theta, B)): Per-lane parameters.
        tgrid (Tensor(N,)): Time of each step.
        mode (str): ``"kramer"`` (EK1) or ``"rodeo"`` (EK0).

    Returns:
        (tuple): ``G (N, q*q, n_block, B)`` row-major gains, ``g (N, q,
        ...)`` offsets, ``L (N, n_tri, ...)`` packed noise, the last
        filtered mean ``(q, n_block, B)`` and packed covariance ``(n_tri,
        n_block, B)``.  Entry ``n`` maps filtered ``n`` onto filtered
        ``n-1``; entry 0 (conditioning on the exact initial state) is
        written but the smoother does not use it.
    """
    model = resolve_model(model)
    if mode not in _MODES:
        raise NotImplementedError(
            f"fused interrogation {mode!r} is not ported; expected one of "
            f"{sorted(_MODES)}")
    q, n_block, n_lane = x0_lanes.shape
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    device = x0_lanes.device
    R_packed = _pack_tri(prior_var, pairs).contiguous()
    for name, t, shape in (
            ("prior_var", R_packed, (n_block, n_tri)),
            ("ode_weight", ode_weight, (n_block, q)),
            ("t_vec", t_vec, (q,)),
            ("x0_lanes", x0_lanes, (q, model.n_block, n_lane)),
            ("theta_lanes", theta_lanes, (model.n_theta, n_lane)),
            ("tgrid", tgrid, (n_steps,))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _filter_batch_plain(model, n_steps, q_const, prior_var,
                                   ode_weight, t_vec, x0_lanes, theta_lanes,
                                   tgrid, mode)
    _cuda_device(device)
    if q != _KERNEL_Q:
        raise NotImplementedError(
            f"the filter kernel is instantiated for q={_KERNEL_Q}, got {q}")
    lib = _build.load()
    G = x0_lanes.new_empty((n_steps, q * q, n_block, n_lane))
    g = x0_lanes.new_empty((n_steps, q, n_block, n_lane))
    L = x0_lanes.new_empty((n_steps, n_tri, n_block, n_lane))
    m_last = torch.empty_like(x0_lanes)
    p_last = x0_lanes.new_empty((n_tri, n_block, n_lane))
    qc = (ctypes.c_float * (q * q))(*[v for row in q_const for v in row])
    with torch.cuda.device(device):
        err = lib.rodeo_filter_batch(
            _FUNCTORS[model.cuda_functor], _MODES[mode], n_steps, n_lane,
            ctypes.addressof(qc), R_packed.data_ptr(), ode_weight.data_ptr(),
            t_vec.data_ptr(), x0_lanes.data_ptr(), theta_lanes.data_ptr(),
            tgrid.data_ptr(), G.data_ptr(), g.data_ptr(), L.data_ptr(),
            m_last.data_ptr(), p_last.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error("filter_batch", err)
    LAUNCHES["filter_batch"] += 1
    return G, g, L, m_last, p_last


# --- K2: reverse affine recursion ------------------------------------------------


def _smoother_batch_plain(g_k, G_k, L_k, mN, pN):
    """Plain PyTorch twin of ``csrc/smoother_batch.cu``.  Arguments and
    returns as :func:`smoother_recursion_batch`."""
    n_len, q = g_k.shape[:2]
    _, where = _tri_idx(q)
    ms = torch.empty_like(g_k)
    ps = torch.empty_like(L_k)
    m_cols, p_cols = list(mN), list(pN)
    for r in range(n_len - 1, -1, -1):
        G = [[G_k[r, i * q + j] for j in range(q)] for i in range(q)]
        m_out = []
        for i in range(q):
            acc = g_k[r, i]
            for j in range(q):
                acc = acc + G[i][j] * m_cols[j]
            m_out.append(acc)
        gpg = _sym_quadform(q, G, p_cols, where)
        p_cols = [L_k[r, k] + gpg[k] for k in range(len(gpg))]
        m_cols = m_out
        ms[r] = torch.stack(m_cols)
        ps[r] = torch.stack(p_cols)
    return ms, ps


def smoother_recursion_batch(g_k, G_k, L_k, mN, pN):
    r"""
    Lane-batched backward affine recursion (kernel K2)
    ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n P_{n+1} G_n'``, from the
    terminal ``(mN, pN)`` down to row 0.

    Args:
        g_k (Tensor(T, q, n_block, B)): Offsets.
        G_k (Tensor(T, q*q, n_block, B)): Gains, row-major.
        L_k (Tensor(T, n_tri, n_block, B)): Packed noise terms.
        mN, pN: Terminal values ``(q, n_block, B)`` / ``(n_tri, n_block,
            B)``.

    Returns:
        (tuple): ``ms (T, q, n_block, B)``, ``ps (T, n_tri, n_block, B)``.
    """
    n_len, q, n_block, n_lane = g_k.shape
    n_tri = q * (q + 1) // 2
    device = g_k.device
    for name, t, shape in (
            ("g_k", g_k, (n_len, q, n_block, n_lane)),
            ("G_k", G_k, (n_len, q * q, n_block, n_lane)),
            ("L_k", L_k, (n_len, n_tri, n_block, n_lane)),
            ("mN", mN, (q, n_block, n_lane)),
            ("pN", pN, (n_tri, n_block, n_lane))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _smoother_batch_plain(g_k, G_k, L_k, mN, pN)
    _cuda_device(device)
    if q != _KERNEL_Q:
        raise NotImplementedError(
            f"the smoother kernel is instantiated for q={_KERNEL_Q}, got {q}")
    lib = _build.load()
    ms = torch.empty_like(g_k)
    ps = torch.empty_like(L_k)
    with torch.cuda.device(device):
        err = lib.rodeo_smoother_batch(
            n_len, n_block * n_lane, g_k.data_ptr(), G_k.data_ptr(),
            L_k.data_ptr(), mN.data_ptr(), pN.data_ptr(), ms.data_ptr(),
            ps.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error("smoother_batch", err)
    LAUNCHES["smoother_batch"] += 1
    return ms, ps


# --- the fused solve ----------------------------------------------------------------


def _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                     prior_pars):
    """The operands of :func:`fused_filter_batch` for a solve, in float32
    Taylor-scaled coordinates on ``thetas``' device (arguments as
    :func:`solve_mv_fused_batch`)."""
    q = ode_weight.shape[-1]
    device = thetas.device
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=torch.float32, device=device)
    _, Rs = scale_prior(prior_pars, t_vec)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "solve_mv_fused_batch requires the same transition for every "
            "block (e.g. ibm_init)")
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = (ode_inits / t_vec).to(torch.float32).permute(2, 1, 0)
    tgrid = t_min + (t_max - t_min) * (
        torch.arange(n_steps, dtype=torch.float64) + 1) / n_steps
    return dict(q_const=q_const, prior_var=Rs.to(torch.float32),
                ode_weight=W_s.to(torch.float32).contiguous(), t_vec=t_vec,
                x0_lanes=x0_lanes.contiguous(),
                theta_lanes=thetas.T.to(torch.float32).contiguous(),
                tgrid=tgrid.to(device, torch.float32))


def solve_mv_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max,
                         n_steps, prior_pars, model, interrogation="kramer",
                         kalman_type="standard"):
    r"""
    Lane-batched fused solve: ``B`` independent solves of one model with
    per-lane parameters and initial states, through kernels K1 and K2 on a
    CUDA device (their plain twins on the CPU).

    Args:
        thetas (Tensor(B, n_theta)): Per-lane parameters.
        ode_weight (Tensor(n_block, 1, q)): Weight matrix ``W``.
        ode_inits (Tensor(B, n_block, q)): Per-lane initial states
            (original coordinates).
        t_min, t_max (float): Time interval.
        n_steps (int): Number of steps ``N``.
        prior_pars (tuple): ``(prior_weight, prior_var)``, each
            ``(n_block, q, q)``; the transition must be the same for every
            block (the IBM prior).
        model: Model name (``"lorenz"``, ``"fitzhugh"``), model module or
            :class:`~rodeo_tpu_torch.models.FusedModel`; it names both the
            plain right-hand side and the CUDA functor.
        interrogation (str): ``"kramer"`` (EK1) or ``"rodeo"`` (EK0).
        kalman_type (str): ``"standard"`` (packed covariances).

    Returns:
        (tuple): float32 **mean** ``(N+1, n_block, q, B)`` and packed
        covariance **var_packed** ``(N+1, n_block, n_tri, B)`` in original
        coordinates, upper triangles in :func:`_tri_idx` order (expand a
        lane with :func:`unpack_cov`).
    """
    fused = resolve_model(model)
    n_block, n_bmeas, q = ode_weight.shape
    if resolve_kalman_type(kalman_type) == "sqrt":
        raise NotImplementedError(
            "kalman_type='sqrt' is not ported to the fused solve yet")
    if n_bmeas != 1:
        raise NotImplementedError("the fused kernels require n_bmeas == 1")
    if q != _KERNEL_Q:
        raise NotImplementedError(
            f"the fused kernels are instantiated for q={_KERNEL_Q}, got {q}")
    n_lane = thetas.shape[0]
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    A_k, b_k, C_k, m_last, p_last = fused_filter_batch(
        fused, n_steps, **ops, mode=interrogation)
    # entry 0 of the gains conditions on the exact initial state, which
    # the smoother does not need: its seed is the last filtered state
    ms, ps = smoother_recursion_batch(b_k[1:], A_k[1:], C_k[1:], m_last,
                                      p_last)
    del A_k, b_k, C_k
    # assemble (N+1, nb, q | n_tri, B) in original coordinates, lanes last;
    # scaled in place to save one buffer of the output's size
    t_vec = ops["t_vec"]
    mean_rows = torch.cat([ops["x0_lanes"].permute(1, 0, 2)[None],
                           ms.permute(0, 2, 1, 3),
                           m_last.permute(1, 0, 2)[None]])
    mean_rows *= t_vec[:, None]
    packed_rows = torch.cat([
        ps.new_zeros((1, n_block, n_tri, n_lane)),
        ps.permute(0, 2, 1, 3),
        p_last.permute(1, 0, 2)[None]])
    tri_scale = torch.stack([t_vec[i] * t_vec[j] for (i, j) in pairs])
    packed_rows *= tri_scale[:, None]
    return mean_rows, packed_rows
