r"""
Fused solve on the GPU (port of :mod:`rodeo_tpu.ops.pallas_kalman`): the
lane-batched path (``fused_filter_batch(emit="gains")``,
``smoother_recursion_batch_rows``, ``solve_mv_fused_batch`` and
``basic_fused_batch``, and their gradients ``solve_mv_fused_batch_grad``
and ``basic_fused_batch_grad``), the single-solve path (``fused_filter``,
``fused_smoother``, ``fused_smoother_composed`` and ``solve_mv_fused``),
its stationary-gain form ``solve_mv_fused_stationary``, and the column
algebra that the likelihood and sampling modules beside it share.

``B`` independent solves (parameter candidates, MCMC chains) ride one pair
of kernels, batched along a trailing lane axis:

- **K1** ``csrc/filter_batch.cuh`` replaces ``_filter_kernel_batch``: the
  whole forward filter under the interrogations kramer (EK1), rodeo (EK0),
  schober and chkrebtii, the ODE right-hand side evaluated inside the
  kernel, emitting the per-step smoothing gains ``(G, g, L)``; one thread
  per (lane, block), the blocks of a lane meeting once a step in shared
  memory (``csrc/block_step.cuh``); its C entry points are
  ``csrc/filter_batch.cu``, its instances compiled one translation unit
  per (model, q), ``csrc/filter_instances_*.cu``, with K3's;
- **K2r** ``csrc/smoother_batch_rows.cu`` replaces
  ``_smoother_kernel_batch`` and ``_smoother_kernel_batch_rows``: the
  reverse affine recursion ``m_n = g_n + G_n m_{n+1}``,
  ``P_n = L_n + G_n P_{n+1} G_n'``, writing the public rows, scaled, with
  the boundary rows as synthetic elements.  The JAX package runs the bare
  recursion and assembles the rows in XLA, because its rows kernel does
  not lower well on the TPU; on the card one kernel does both;
- **K11a** ``csrc/filter_batch_tan.cuh`` replaces
  ``pallas_fenrir._filter_kernel_batch_tan`` (``emit="gains"``): K1 carrying
  the tangents of its state along each theta direction (forward mode);
- **K11e** ``csrc/smoother_mean_batch_tan.cu`` replaces
  ``_smoother_mean_kernel_batch_tan``: the mean recursion with tangents.

One solve (the latency path) runs two kernels in the JAX package's
``(N, n_block, d)`` layout:

- **K3** ``csrc/filter_single.cuh`` replaces ``_filter_kernel``: K1's
  step on one solve, storing the filtered and predicted moments of every
  step (C entry points ``csrc/filter_single.cu``);
- **K4** ``csrc/smoother_single.cu`` replaces
  ``_smoother_recursion_kernel``: the reverse recursion over gains computed
  in batched torch, over every step (``fused_smoother``) or over the
  boundary steps of exact k-step compositions
  (``fused_smoother_composed``).

Where the measurement row is constant in time, the stationary-gain solve
runs K3 on an exact prefix only and the mean chain beyond it, in
``csrc/mean_chain_single.cu``:

- **K5a** ``mean_gain_chain`` replaces ``_mean_gain_kernel``: the chain
  with a gain per step;
- **K5b** ``mean_boundary_chain`` replaces ``_mean_boundary_kernel``: the
  chain with the frozen gain, storing each 64-step group's entry state;
- **K5c** ``mean_recovery_chain`` replaces ``_mean_recovery_kernel``: the
  groups re-run from their entry states in parallel.

The TPU entry points' ``chunk=`` and ``unroll=`` set the size of the TPU's
grid steps and its loop unrolling; a CUDA kernel loops over all steps
inside a thread, so the port does not take them.

Each kernel has a plain PyTorch twin here (``_filter_batch_plain``,
``_smoother_batch_rows_plain``, ``_filter_batch_tan_plain``,
``_smoother_mean_tan_plain``, ``_filter_single_plain``,
``_smoother_single_plain``, ``_mean_gain_plain``, ``_mean_boundary_plain``,
``_mean_recovery_plain``): the same algebra,
operation for operation, on ``(n_block, B)`` columns with a Python loop
over steps.  K11a's twin is K1's run on
:class:`~rodeo_tpu_torch.ops.dual.Dual` numbers, whose rules the kernel
applies in the same order (``csrc/dual.cuh``).  A wrapper takes the twin
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts the kernel launches.

The kernels work in float32 in the Taylor-scaled coordinates of
:mod:`rodeo_tpu_torch.ops.precond`, with the Joseph-form update, as the
TPU kernels did.  Covariances are packed upper triangles in
:func:`_tri_idx` order.  Each kernel is instantiated for the (model
functor, interrogation, q) listed in ``_INSTANCES``: K1 and K3 for every
interrogation on the first-order models at q = 3, on FitzHugh-Nagumo also
at q = 4 and 5 (its weight and initial state padded with zeros past the
third derivative) and on Chkrebtii's second-order ODE at q = 4 and 5, K11a
for kramer and rodeo on the same (model, q), K2r, K4 and the tangent
recursions K11e and K11b for q = 3, 4 and 5 (the tangent ones at 1 to
``_MAX_TAN`` = 7 directions, Hes1's 7 parameters), the others as
``_INSTANCES`` lists them.
"""
import ctypes
import importlib
import itertools
import math

import numpy as np
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.models import FusedModel
from rodeo_tpu_torch.ops import _build
from rodeo_tpu_torch.ops.dual import Dual, constant, primal, seed_directions
from rodeo_tpu_torch.ops.dual import stack as dual_stack
from rodeo_tpu_torch.ops.linalg import (chol_small, full_matmul_precision,
                                        inv_small)
from rodeo_tpu_torch.ops.obs_grid import obs_indices
from rodeo_tpu_torch.ops.precond import taylor_scale, scale_prior

__all__ = ["fused_filter_batch", "smoother_recursion_batch_rows",
           "fused_filter_batch_tan", "smoother_mean_recursion_batch_tan",
           "solve_mv_fused_batch",
           "basic_fused_batch", "solve_mv_fused_batch_grad",
           "basic_fused_batch_grad", "fused_filter", "smoother_recursion",
           "fused_smoother", "fused_smoother_composed", "solve_mv_fused",
           "mean_gain_chain", "mean_boundary_chain", "mean_recovery_chain",
           "solve_mv_fused_stationary", "resolve_kalman_type", "unpack_cov",
           "chol_packed", "unpack_chol", "normalize_prior_pars",
           "normalize_meas_var", "LAUNCHES"]

# kernel launches since the last reset, by kernel
LAUNCHES = {"filter_batch": 0, "smoother_batch_rows": 0,
            "filter_batch_tan": 0, "smoother_mean_batch_tan": 0,
            "filter_single": 0, "smoother_single": 0,
            "mean_gain_single": 0, "mean_boundary_single": 0,
            "mean_recovery_single": 0}

# interrogation modes and model functors, numbered as the C entry points
# number them (kKramer .. kChkrebtii of csrc/filter_step.cuh, kNumber of
# csrc/models.cuh's functors)
_MODES = {"kramer": 0, "rodeo": 1, "schober": 2, "chkrebtii": 3}
_FUNCTORS = {"Lorenz63": 0, "FitzHughNagumo": 1, "Chkrebtii": 2, "Hes1": 3,
             "Seirah": 4}
_LOG2PI = 1.8378770664093453


def _product(models, modes, qs):
    return frozenset(itertools.product(models, modes, qs))


# The instances each kernel holds, as (model functor, mode, q): None where
# the kernel takes no model or no mode.  The C entry points dispatch over
# the same lists (csrc/dispatch.cuh) and return an error for any other;
# _launch and the geometry queries refuse them first.  The tangent
# recursions K11b and K11e also take 1 to _MAX_TAN directions
# (_check_n_tan).
_EK_MODES = ("kramer", "rodeo")
_MAX_TAN = 7


def _filter_models(modes):
    """The first-order models at q = 3, FitzHugh-Nagumo also at q = 4 and
    5, and the second-order Chkrebtii at q = 4 and 5, under ``modes`` (the
    instances of K1, K3, K11a, K8, K11c, K9 and K11d, csrc/dispatch.cuh's
    with_filter_instance)."""
    return _product(("Lorenz63", "FitzHughNagumo", "Hes1", "Seirah"), modes,
                    (3,)) | _product(("FitzHughNagumo", "Chkrebtii"), modes,
                                     (4, 5))


_EVERY_MODE = _filter_models(tuple(_MODES))
_Q3 = _product((None,), (None,), (3,))
_Q345 = _product((None,), (None,), (3, 4, 5))
_MEAN = _product(("Lorenz63", "FitzHughNagumo"), (None,), (3,))
_INSTANCES = {
    "filter_batch": _EVERY_MODE, "filter_single": _EVERY_MODE,
    "smoother_batch_rows": _Q345, "smoother_single": _Q345,
    "filter_batch_tan": _filter_models(_EK_MODES),
    "dalton_filter_batch": _filter_models(_EK_MODES),
    "dalton_filter_batch_tan": _filter_models(_EK_MODES),
    "filter_nn_batch": _filter_models(_EK_MODES),
    "filter_nn_batch_tan": _filter_models(_EK_MODES),
    "smoother_mean_batch_tan": _Q345,
    "sampler_batch": _Q345, "fenrir_backward_batch": _Q345,
    "fenrir_backward_batch_tan": _Q345, "fenrir_backward_single": _Q345,
    "magi_batch": _Q3, "magi_adjoint_batch": _Q3,
    "mean_gain_single": _MEAN, "mean_boundary_single": _MEAN,
    "mean_recovery_single": _MEAN}


def _check_instance(kernel, q, model=None, mode=None):
    """Raise NotImplementedError unless ``kernel`` holds an instance for
    (model functor, mode, q), naming the instances it holds; the model and
    mode count only for a kernel that takes them."""
    held = _INSTANCES[kernel]
    key = (model if any(k[0] is not None for k in held) else None,
           mode if any(k[1] is not None for k in held) else None, q)
    if key not in held:
        names = ("model", "mode", "q")
        asked = ", ".join(f"{n}={v!r}" for n, v in zip(names, key)
                          if v is not None or n == "q")
        holds = "; ".join(
            ", ".join(f"{n}={v!r}" for n, v in zip(names, k) if v is not None)
            for k in sorted(held, key=lambda k: (k[2], str(k[0]), str(k[1]))))
        raise NotImplementedError(
            f"the {kernel} kernel holds no instance for {asked}; it holds "
            f"({holds})")


def _check_n_tan(kernel, n_tan):
    """Raise NotImplementedError unless the tangent recursion ``kernel``
    (K11b, K11e) holds ``n_tan`` directions: 1 to ``_MAX_TAN``."""
    if not 1 <= n_tan <= _MAX_TAN:
        raise NotImplementedError(
            f"the {kernel} kernel holds 1 to {_MAX_TAN} tangent directions; "
            f"got {n_tan}")


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
        # the inverse does not depend on the scale rs: on Duals it is a
        # constant (zero tangent), as in the kernels
        s = torch.maximum(torch.abs(primal(a)),
                          torch.maximum(torch.abs(primal(d)),
                                        torch.abs(primal(f))))
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
        diag = [primal(p_cols[where[(i, i)]]) for i in range(q)]
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


def _chol_cols(q, p_cols, where, floor=1e-12):
    """Closed-form lower Cholesky factor of a packed symmetric matrix in
    column layout: returns ``L[i][j]`` for ``j <= i``.

    Float32-stable as in the JAX package: normalised to correlation form
    (unit diagonal), factored with a *relative* pivot floor, rows scaled
    back.  A floored pivot marks a numerically null direction, and the
    entries below it are set to zero rather than divided by the floor,
    which would blow the remaining columns up by ~1/floor."""
    d = [torch.sqrt(torch.clamp(p_cols[where[(i, i)]], min=1e-38))
         for i in range(q)]
    rd = [1.0 / di for di in d]
    L = [[None] * (i + 1) for i in range(q)]
    ok = [None] * q     # pivot genuinely positive (not floored)?
    for i in range(q):
        for j in range(i + 1):
            s = p_cols[where[(i, j)]] * (rd[i] * rd[j])
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = torch.sqrt(torch.clamp(s, min=floor))
            else:
                L[i][j] = torch.where(ok[j], s / L[j][j],
                                      torch.zeros_like(s))
    return [[L[i][j] * d[i] for j in range(i + 1)] for i in range(q)]


def _chol_matvec(q, L, eps_cols):
    """Columns of ``L @ eps`` for a lower-triangular column factor."""
    return [sum(L[i][j] * eps_cols[j] for j in range(i + 1))
            for i in range(q)]


def _block_sum(x):
    """Sum of the rows of ``x (n_block, ...)`` in block order, as the
    kernels add them."""
    acc = x[0]
    for b in range(1, x.shape[0]):
        acc = acc + x[b]
    return acc


def _masked_obs_update_cols(q, pairs, where, m_cols, p_cols, D, y, om, mask):
    """
    Masked scalar observation update of every block in column arithmetic
    (``masked_obs_update`` of ``csrc/kalman_cols.cuh``):
    ``S = om + D P D'``, ``z = y - D m``, ``K = P D' / S * mask``, then
    ``m + K z`` and the Joseph form ``(I - K D) P (I - K D)' + K K' om``.

    Args:
        m_cols, p_cols: Mean and packed covariance columns ``(n_block,
            B)``.
        D: ``q`` weight columns; ``y``, ``om``: data and variance; each
            ``(n_block, 1)``.  ``mask``: 0-d, 1.0 where the step has data.

    Returns:
        (tuple): The updated mean and covariance columns, and each block's
        log-density term ``z^2 / S + log S + log 2 pi`` ``(n_block, B)``.
    """
    PD = []
    for i in range(q):
        acc = p_cols[where[(i, 0)]] * D[0]
        for j in range(1, q):
            acc = acc + p_cols[where[(i, j)]] * D[j]
        PD.append(acc)
    S = om
    for i in range(q):
        S = S + D[i] * PD[i]
    z = y
    for i in range(q):
        z = z - D[i] * m_cols[i]
    inv_S = 1.0 / S
    term = z * z * inv_S + torch.log(S) + _LOG2PI
    K = [PD[i] * inv_S * mask for i in range(q)]
    m_out = [m_cols[i] + K[i] * z for i in range(q)]
    IKD = [[(1.0 if i == j else 0.0) - K[i] * D[j] for j in range(q)]
           for i in range(q)]
    pj = _sym_quadform(q, IKD, p_cols, where)
    p_out = [pj[k] + K[i] * K[j] * om for k, (i, j) in enumerate(pairs)]
    return m_out, p_out, term


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


def chol_packed(packed, q, floor=1e-12, axis=-1):
    r"""
    Closed-form lower Cholesky factor of packed symmetric covariances, in
    the packed layout (``chol_packed`` of the JAX package's
    ``pallas_kalman``, formula for formula).

    ``packed`` holds the upper-triangle pairs ``(i, j), i <= j`` of
    :func:`_tri_idx` along ``axis``; the result has the same shape, entry
    ``k = (i, j)`` holding the lower factor's ``L[j, i]``.  Normalised to
    correlation form with a relative pivot floor; entries below a floored
    pivot are zero, and an all-zero covariance factors to ~0.
    """
    pairs, where = _tri_idx(q)
    cols = packed.unbind(axis)
    tiny = torch.finfo(packed.dtype).tiny
    d = [torch.sqrt(torch.clamp(cols[where[(i, i)]], min=tiny))
         for i in range(q)]
    L = [[None] * (i + 1) for i in range(q)]
    ok = [None] * q
    for i in range(q):
        for j in range(i + 1):
            s = cols[where[(j, i)]] / (d[i] * d[j])
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = torch.sqrt(torch.clamp(s, min=floor))
            else:
                L[i][j] = torch.where(ok[j], s / L[j][j],
                                      torch.zeros_like(s))
    return torch.stack([L[j][i] * d[j] for (i, j) in pairs], dim=axis)


def unpack_chol(packed):
    """Expand a packed lower Cholesky factor ``(..., n_tri)`` from
    :func:`chol_packed` into a dense lower-triangular ``(..., q, q)``
    matrix (for lane slices of the square-root form's
    :func:`solve_mv_fused_batch` output)."""
    n_tri = packed.shape[-1]
    q = {1: 1, 3: 2, 6: 3, 10: 4, 15: 5}[n_tri]
    _, where = _tri_idx(q)
    zero = torch.zeros_like(packed[..., 0])
    rows = [torch.stack([packed[..., where[(j, i)]] if j <= i else zero
                         for j in range(q)], dim=-1) for i in range(q)]
    return torch.stack(rows, dim=-2)


@full_matmul_precision
def _gram(v):
    """``v v'`` over the trailing dims, in full float32 precision."""
    return v @ v.transpose(-1, -2)


def normalize_prior_pars(kalman_type, prior_pars):
    """The covariance form of ``(prior_weight, prior_var)``: the
    square-root form passes the variance as a factor, which is squared
    here, since the fused kernels carry covariances.  ``kalman_type`` as
    :func:`resolve_kalman_type` returns it."""
    if kalman_type == "sqrt" and prior_pars is not None:
        w, v = prior_pars
        return (w, _gram(torch.as_tensor(v)))
    return prior_pars


def normalize_meas_var(kalman_type, var_meas):
    """The covariance form of a Gaussian observation variance, which the
    square-root form passes as a factor (see
    :func:`normalize_prior_pars`)."""
    if kalman_type == "sqrt" and var_meas is not None:
        return _gram(torch.as_tensor(var_meas))
    return var_meas


def resolve_kalman_type(kalman_type):
    """Normalise the fused entry's ``kalman_type``: ``"standard"``, or
    ``"sqrt"`` for any of its spellings.  Both ride the same kernels: the
    square-root form's variances are factors, squared at entry
    (:func:`normalize_prior_pars`), and a solve returns Cholesky factors
    of its covariances."""
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


# the kernels whose C entry points take q (after the model's and the mode's
# numbers)
_TAKES_Q = frozenset({"filter_batch", "filter_single", "smoother_batch_rows",
                      "smoother_single", "sampler_batch",
                      "fenrir_backward_batch", "fenrir_backward_single",
                      "dalton_filter_batch", "filter_batch_tan",
                      "dalton_filter_batch_tan", "fenrir_backward_batch_tan",
                      "smoother_mean_batch_tan", "filter_nn_batch",
                      "filter_nn_batch_tan"})


def _instance_args(kernel, q, model, mode, obs):
    """Refuse (``model`` functor, ``mode``, ``q``) unless ``kernel`` holds
    it (:func:`_check_instance`); else the leading integers of its C entry
    point and geometry query: the model's number (``_FUNCTORS``), the
    observation model's number ``obs`` (K9, K11d), the mode's (``_MODES``)
    and q, each where the kernel takes it."""
    _check_instance(kernel, q, model, mode)
    return ([] if model is None else [_FUNCTORS[model]]) \
        + ([] if obs is None else [obs]) \
        + ([] if mode is None else [_MODES[mode]]) \
        + ([q] if kernel in _TAKES_Q else [])


def _launch(counts, kernel, q, device, *args, model=None, mode=None,
            obs=None):
    """Launch the C entry point ``rodeo_<kernel>`` on ``device``'s current
    stream: the instance's numbers first (:func:`_instance_args`, which
    refuses an instance the kernel does not hold), then ``args``, a tensor
    passed as its data pointer (``None`` as a null pointer); raise if the
    launch failed, else add one to ``counts[kernel]``."""
    lead = _instance_args(kernel, q, model, mode, obs)
    if device.type != "cuda":
        raise NotImplementedError(
            f"the fused kernels run on CUDA tensors (plain PyTorch on CPU "
            f"tensors); got a tensor on {device}")
    lib = _build.load()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, f"rodeo_{kernel}")(
            *lead, *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")
    counts[kernel] += 1


_GEOMETRY = ("cta_x", "cta_y", "grid_x", "grid_y", "registers",
             "local_bytes", "shared_bytes", "ctas_per_sm", "sms")


def _launch_geometry(kernel, device, *args, extra=(), q=3, model=None,
                     mode=None, obs=None):
    """The launch of ``rodeo_<kernel>`` for these leading arguments, as its
    C query ``rodeo_<kernel>_geometry`` reports it on ``device``: the CTA
    shape and grid, registers and local memory bytes per thread, shared
    memory bytes per CTA (static, and dynamic where the launch asks for
    it), the CTAs an SM can hold, and the card's SMs, then the kernel's own
    fields named in ``extra``; with the CTAs, threads per CTA, and whether
    the CTAs are at least the SMs and all resident at once.  The instance's
    numbers lead, as :func:`_launch` passes them, and an instance the kernel
    does not hold is refused before the query."""
    lead = _instance_args(kernel, q, model, mode, obs)
    device = resolve_device(device)
    if device.type != "cuda":
        raise NotImplementedError(f"{kernel} runs on the CUDA card only")
    names = _GEOMETRY + tuple(extra)
    out = (ctypes.c_int * len(names))()
    with torch.cuda.device(device):
        err = getattr(_build.load(), f"rodeo_{kernel}_geometry")(
            *lead, *args, out)
    if err != 0:
        raise RuntimeError(f"{kernel} geometry query failed: "
                           f"{_build.error_string(err)} (code {err})")
    geo = dict(zip(names, out))
    geo["ctas"] = geo["grid_x"] * geo["grid_y"]
    geo["threads_per_cta"] = geo["cta_x"] * geo["cta_y"]
    geo["ctas_at_least_sms"] = geo["ctas"] >= geo["sms"]
    geo["all_resident"] = geo["ctas"] <= geo["ctas_per_sm"] * geo["sms"]
    return geo


def _filter_batch_geometry(model, n_lane, mode="kramer", q=3, device=None):
    """The launch of kernel K1 (:func:`fused_filter_batch`) at ``n_lane``
    lanes on the card, for the model, mode and q of one of its instances,
    as :func:`_launch_geometry` reports it."""
    return _launch_geometry("filter_batch", device, n_lane, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode)


def _filter_batch_tan_geometry(model, n_lane, mode="kramer", q=3,
                              device=None):
    """The launch of kernel K11a (:func:`fused_filter_batch_tan`) at
    ``n_lane`` lanes on the card, for the model, mode and q of one of its
    instances, as :func:`_launch_geometry` reports it."""
    return _launch_geometry("filter_batch_tan", device, n_lane, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode)


def _smoother_mean_batch_tan_geometry(n_col, n_tan, q=3, device=None):
    """The launch of kernel K11e (:func:`smoother_mean_recursion_batch_tan`)
    at ``q`` over ``n_col`` (block, lane) columns and ``n_tan`` directions
    on the card, as :func:`_launch_geometry` reports it."""
    _check_n_tan("smoother_mean_batch_tan", n_tan)
    return _launch_geometry("smoother_mean_batch_tan", device, n_col, n_tan,
                            q=q)


def _filter_single_geometry(model, mode="kramer", q=3, device=None):
    """The launch of kernel K3 (:func:`fused_filter`) on the card, one CTA
    of a thread per block, for the model, mode and q of one of its
    instances, as :func:`_launch_geometry` reports it."""
    return _launch_geometry("filter_single", device, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode)


def _smoother_batch_rows_geometry(n_block, n_lane, q=3, device=None):
    """The launch of kernel K2r (:func:`smoother_recursion_batch_rows`) at
    ``q`` over ``n_block x n_lane`` columns with aligned operands on the
    card, as :func:`_launch_geometry` reports it (its shared memory
    dynamic), with the stages of its shared-memory ring and the steps a
    stage holds."""
    return _launch_geometry("smoother_batch_rows", device, n_block, n_lane,
                            extra=("stages", "steps_per_stage"), q=q)


def _smoother_single_geometry(n_block, q=3, device=None):
    """The launch of kernel K4 (:func:`smoother_recursion`) at ``q`` over
    ``n_block`` blocks with aligned operands on the card, as
    :func:`_launch_geometry` reports it (its shared memory dynamic), with
    the stages of its shared-memory ring, the rows a stage holds, the
    blocks a CTA holds and the lanes of a block's row."""
    return _launch_geometry("smoother_single", device, n_block,
                            extra=("stages", "rows_per_stage",
                                   "blocks_per_cta", "lanes_per_block"),
                            q=q)


def _check_mode(mode):
    if mode not in _MODES:
        raise NotImplementedError(
            f"fused interrogation {mode!r} is not ported; expected one of "
            f"{sorted(_MODES)}")


# --- K1: forward filter emitting smoothing gains ------------------------------


def _predict_cols(q, where, q_const, R_cols, m_cols, p_cols):
    """Prediction of every block: ``mp = Q m``, ``pp = Q P Q' + R``
    (``predict_block`` of ``csrc/filter_step.cuh``)."""
    mp_cols = _matvec(q, q_const, m_cols)
    pp_cols = _sym_quadform(q, q_const, p_cols, where)
    return mp_cols, [pp_cols[k] + R_cols[k] for k in range(len(pp_cols))]


def _interrogate_update_cols(model, q, pairs, where, W_cols, tv_cols,
                             mp_cols, pp_cols, theta_lanes, t, mode,
                             eps_cols=None):
    """Interrogate the ODE and do the scalar-innovation Joseph update of
    every block (``interrogate_update_block`` of ``csrc/block_step.cuh``,
    which the kernels K1, K3, K8 and K9 run per block).  The ODE is
    evaluated at the predicted mean, or under chkrebtii at the draw ``mp +
    L eps`` (``draw_point``), ``L`` the Cholesky factor of the predicted
    covariance and ``eps_cols`` the step's ``q`` columns of standard
    normals.  kramer linearises the ODE (EK1); rodeo and chkrebtii add the
    noise ``W Pp W'`` (S doubled and ``K V K'``); schober adds none.

    Returns the updated mean and packed covariance columns, and the
    innovation ``z``, its variance ``S`` and ``1 / S``, each ``(n_block,
    B)``."""
    if mode == "chkrebtii":
        eta = _chol_matvec(q, _chol_cols(q, pp_cols, where), eps_cols)
        x_cols = [(mp_cols[j] + eta[j]) * tv_cols[j] for j in range(q)]
    else:
        x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
    f0 = model.flat(x_cols, theta_lanes, t)
    jd_cols = model.jac_flat(x_cols, theta_lanes, t) \
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
    noise = mode in ("rodeo", "chkrebtii")
    if noise:
        S = S + S                    # V = W Sigma_p W' doubles S
    inv_S = 1.0 / S
    gain = [PH_cols[i] * inv_S for i in range(q)]
    m_cols = [mp_cols[i] + gain[i] * z for i in range(q)]
    IKW = [[(1.0 if i == j else 0.0) - gain[i] * H_cols[j]
            for j in range(q)] for i in range(q)]
    p_cols = _sym_quadform(q, IKW, pp_cols, where)
    if noise:
        V = S * 0.5
        p_cols = [p_cols[k] + gain[i] * gain[j] * V
                  for k, (i, j) in enumerate(pairs)]
    return m_cols, p_cols, z, S, inv_S


def _filter_batch_plain(model, n_steps, q_const, prior_var, ode_weight,
                        t_vec, x0_lanes, theta_lanes, tgrid, mode, eps=None):
    """Plain PyTorch twin of ``csrc/filter_batch.cuh``: the same arithmetic
    in the same order on ``(n_block, B)`` columns, one Python iteration per
    step.  Arguments and returns as :func:`fused_filter_batch` (``model``
    resolved).  With ``x0_lanes`` and ``theta_lanes`` as Duals it is the
    twin of K11a, and returns its augmented outputs."""
    q, n_block, n_lane = x0_lanes.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]  # (nb, 1) bcast
    W_cols = [ode_weight[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    n_aug = 1 + theta_lanes.n_dir if isinstance(theta_lanes, Dual) else 1
    new = primal(x0_lanes).new_empty
    G_out = new((n_steps, n_aug * q * q, n_block, n_lane))
    g_out = new((n_steps, n_aug * q, n_block, n_lane))
    L_out = new((n_steps, n_aug * n_tri, n_block, n_lane))
    m_cols = list(x0_lanes)
    p_cols = [torch.zeros_like(x0_lanes[0]) for _ in range(n_tri)]
    for n in range(n_steps):
        mp_cols, pp_cols = _predict_cols(q, where, q_const, R_cols, m_cols,
                                         p_cols)
        # the gain of the transition n-1 -> n needs only the carry
        # (filtered n-1) and the fresh prediction (n)
        G, g, L = _gain_cols_batched(q, n_tri, q_const, R_cols, m_cols,
                                     p_cols, mp_cols, pp_cols)
        G_out[n] = dual_stack([G[i][j] for i in range(q)
                               for j in range(q)])
        g_out[n] = dual_stack(g)
        L_out[n] = dual_stack(L)
        m_cols, p_cols, _, _, _ = _interrogate_update_cols(
            model, q, pairs, where, W_cols, tv_cols, mp_cols, pp_cols,
            theta_lanes, tgrid[n], mode,
            None if eps is None else list(eps[n]))
    return G_out, g_out, L_out, dual_stack(m_cols), dual_stack(p_cols)


def _filter_batch_tan_plain(model, n_steps, q_const, prior_var, ode_weight,
                            t_vec, x0_lanes, theta_lanes, tgrid, mode):
    """Plain PyTorch twin of ``csrc/filter_batch_tan.cuh``: K1's twin on
    Duals, theta seeded along its ``n_theta`` basis directions and the
    initial state exact.  Arguments as :func:`fused_filter_batch`; returns
    as :func:`fused_filter_batch_tan`."""
    theta = seed_directions(theta_lanes)
    return _filter_batch_plain(model, n_steps, q_const, prior_var,
                               ode_weight, t_vec,
                               constant(x0_lanes, theta.n_dir), theta, tgrid,
                               mode)


def fused_filter_batch(model, n_steps, q_const, prior_var, ode_weight,
                       t_vec, x0_lanes, theta_lanes, tgrid, mode="kramer",
                       eps=None):
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
        mode (str): The interrogation: ``"kramer"`` (EK1), ``"rodeo"``
            (EK0 with the noise ``W Pp W'``), ``"schober"`` (EK0 without
            noise) or ``"chkrebtii"`` (rodeo's noise, the ODE at a draw
            from the predictive distribution).
        eps (Tensor(N, q, n_block, B)): The standard normals of the
            chkrebtii draws (the JAX package's layout); other modes take
            none.

    The kernel holds the first-order models at q = 3, FitzHugh-Nagumo also
    at q = 4 and 5, and Chkrebtii at q = 4 and 5, each in every mode
    (``_INSTANCES``).

    Returns:
        (tuple): ``G (N, q*q, n_block, B)`` row-major gains, ``g (N, q,
        ...)`` offsets, ``L (N, n_tri, ...)`` packed noise, the last
        filtered mean ``(q, n_block, B)`` and packed covariance ``(n_tri,
        n_block, B)``.  Entry ``n`` maps filtered ``n`` onto filtered
        ``n-1``; entry 0 (conditioning on the exact initial state) is
        written but the smoother does not use it.
    """
    return _filter(False, model, n_steps, q_const, prior_var, ode_weight,
                   t_vec, x0_lanes, theta_lanes, tgrid, mode, eps)


def fused_filter_batch_tan(model, n_steps, q_const, prior_var, ode_weight,
                           t_vec, x0_lanes, theta_lanes, tgrid,
                           mode="kramer"):
    r"""
    Tangent-augmented lane-batched forward filter (kernel K11a): K1 and the
    derivative of everything it emits along each of the ``n_theta`` theta
    basis directions, the initial state held fixed.  Arguments as
    :func:`fused_filter_batch`; the kernel holds K1's models and q under
    kramer and rodeo (``_INSTANCES``), Hes1's and SEIRAH's Jacobian under
    kramer on nested Duals.

    Returns:
        (tuple): As :func:`fused_filter_batch`, each output with its
        tangents stacked on the ``d`` axis (``n_aug = 1 + n_theta``):
        ``A (N, n_aug*q*q, n_block, B)``, ``b (N, n_aug*q, ...)``,
        ``C (N, n_aug*n_tri, ...)``, ``m_last (n_aug*q, n_block, B)``,
        ``p_last (n_aug*n_tri, n_block, B)``; entries ``0..K-1`` of an
        output of ``K`` entries are the values, entries ``(1+k)K ..`` the
        tangents along direction ``k``.
    """
    return _filter(True, model, n_steps, q_const, prior_var, ode_weight,
                   t_vec, x0_lanes, theta_lanes, tgrid, mode)


def _filter(tangent, model, n_steps, q_const, prior_var, ode_weight, t_vec,
            x0_lanes, theta_lanes, tgrid, mode, eps=None):
    """K1 (``tangent`` False) or K11a: check the operands, take the twin
    for CPU tensors, else launch the kernel."""
    model = resolve_model(model)
    _check_mode(mode)
    q, n_block, n_lane = x0_lanes.shape
    kernel = "filter_batch_tan" if tangent else "filter_batch"
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
            ("tgrid", tgrid, (n_steps,)),
            *_eps_operand(mode, eps, (n_steps, q, n_block, n_lane))):
        _check(name, t, shape, device)
    args = (model, n_steps, q_const, prior_var, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, mode)
    if device.type == "cpu":
        return _filter_batch_tan_plain(*args) if tangent \
            else _filter_batch_plain(*args, eps=eps)
    n_aug = 1 + model.n_theta if tangent else 1
    G = x0_lanes.new_empty((n_steps, n_aug * q * q, n_block, n_lane))
    g = x0_lanes.new_empty((n_steps, n_aug * q, n_block, n_lane))
    L = x0_lanes.new_empty((n_steps, n_aug * n_tri, n_block, n_lane))
    m_last = x0_lanes.new_empty((n_aug * q, n_block, n_lane))
    p_last = x0_lanes.new_empty((n_aug * n_tri, n_block, n_lane))
    qc = _host_qconst(q_const)
    # K1 reads the chkrebtii normals, K11a takes none
    eps_arg = () if tangent else (eps if mode == "chkrebtii" else None,)
    _launch(LAUNCHES, kernel, q, device, n_steps, n_lane,
            ctypes.addressof(qc), R_packed, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, *eps_arg, G, g, L, m_last, p_last,
            model=model.cuda_functor, mode=mode)
    return G, g, L, m_last, p_last


def _eps_operand(mode, eps, shape):
    """The chkrebtii normals as an operand to check, ``(name, tensor,
    shape)``, or none for another mode; raises where chkrebtii has none."""
    if mode != "chkrebtii":
        return ()
    if eps is None:
        raise ValueError("interrogation='chkrebtii' requires eps, the "
                         "standard normals of its draws")
    return (("eps", eps, shape),)


def _host_qconst(q_const):
    """The scaled transition as a row-major float32 array in host memory,
    as the filter kernels take it."""
    flat = [v for row in q_const for v in row]
    return (ctypes.c_float * len(flat))(*flat)


# --- the reverse recursion in columns --------------------------------------------


def _smoother_batch_plain(g_k, G_k, L_k, mN, pN):
    """The reverse recursion ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n
    P_{n+1} G_n'`` on lane-batched columns, from the terminal ``(mN, pN)``
    down to row 0, one Python iteration per row: the arithmetic of
    ``csrc/chain_step.cuh``'s loop, which the twins of K2r and K4 run.

    Args:
        g_k (Tensor(T, q, n_block, B)): Offsets.
        G_k (Tensor(T, q*q, n_block, B)): Gains, row-major.
        L_k (Tensor(T, n_tri, n_block, B)): Packed noise terms.
        mN, pN: Terminal values ``(q, n_block, B)`` / ``(n_tri, n_block,
            B)``.

    Returns:
        (tuple): ``ms (T, q, n_block, B)``, ``ps (T, n_tri, n_block, B)``.
    """
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


# --- K2r: the reverse recursion writing the public rows ------------------------------


def _smoother_batch_rows_plain(g_k, G_k, L_k, mN, pN, m0, m_scales,
                               p_scales):
    """Plain PyTorch twin of ``csrc/smoother_batch_rows.cu``: the recursion
    (:func:`_smoother_batch_plain`) over the gains with the synthetic
    boundary elements, a trailing ``(G=0, g=mN, L=pN)`` and a leading
    ``(G=0, g=m0, L=0)``, from a zero carry; then each row scaled and laid
    out as the public rows.  Arguments and returns as
    :func:`smoother_recursion_batch_rows`."""
    zero_G = G_k.new_zeros((1,) + G_k.shape[1:])
    zero_L = L_k.new_zeros((1,) + L_k.shape[1:])
    ms, ps = _smoother_batch_plain(
        torch.cat([m0[None], g_k, mN[None]]),
        torch.cat([zero_G, G_k, zero_G]),
        torch.cat([zero_L, L_k, pN[None]]),
        torch.zeros_like(mN), torch.zeros_like(pN))
    return ((ms * m_scales[:, None, None]).permute(0, 2, 1, 3).contiguous(),
            (ps * p_scales[:, None, None]).permute(0, 2, 1, 3).contiguous())


def smoother_recursion_batch_rows(g_k, G_k, L_k, mN, pN, m0, m_scales,
                                  p_scales):
    r"""
    Lane-batched backward affine recursion emitting the public rows of the
    solve (kernel K2r): rows ``0 .. N`` of ``solve_mv_fused_batch``'s
    output in one pass, scaled to original coordinates.  The terminal row
    is ``(mN, pN)``, the initial one ``(m0, 0)``; the rows between are the
    reverse recursion ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n P_{n+1}
    G_n'`` over the gains, each multiplied by its scale.

    Args:
        g_k (Tensor(T, q, n_block, B)), G_k (Tensor(T, q*q, n_block, B)),
            L_k (Tensor(T, n_tri, n_block, B)): The offsets, row-major gains
            and packed noise terms of rows ``1 .. N-1`` (``T = N - 1``).
        mN (Tensor(q, n_block, B)), pN (Tensor(n_tri, n_block, B)): The
            last filtered state.
        m0 (Tensor(q, n_block, B)): The initial state.
        m_scales (Tensor(q,)): Mean scale of each derivative (``t_vec``).
        p_scales (Tensor(n_tri,)): Scale of each packed covariance entry
            (``t_vec[i] * t_vec[j]``).

    Returns:
        (tuple): **mean** ``(T+2, n_block, q, B)`` and packed **cov**
        ``(T+2, n_block, n_tri, B)``, lanes innermost.
    """
    n_len, q, n_block, n_lane = g_k.shape
    n_tri = q * (q + 1) // 2
    device = g_k.device
    for name, t, shape in (
            ("g_k", g_k, (n_len, q, n_block, n_lane)),
            ("G_k", G_k, (n_len, q * q, n_block, n_lane)),
            ("L_k", L_k, (n_len, n_tri, n_block, n_lane)),
            ("mN", mN, (q, n_block, n_lane)),
            ("pN", pN, (n_tri, n_block, n_lane)),
            ("m0", m0, (q, n_block, n_lane)),
            ("m_scales", m_scales, (q,)),
            ("p_scales", p_scales, (n_tri,))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _smoother_batch_rows_plain(g_k, G_k, L_k, mN, pN, m0,
                                          m_scales, p_scales)
    mean = g_k.new_empty((n_len + 2, n_block, q, n_lane))
    cov = g_k.new_empty((n_len + 2, n_block, n_tri, n_lane))
    _launch(LAUNCHES, "smoother_batch_rows", q, device, n_len, n_block,
            n_lane, g_k, G_k, L_k, mN, pN, m0,
            torch.cat([m_scales, p_scales]), mean, cov)
    return mean, cov


# --- K11e: the mean recursion with tangents ------------------------------------------


def _smoother_mean_tan_plain(g_aug, G_aug, mN_aug, n_tan):
    """Plain PyTorch twin of ``csrc/smoother_mean_batch_tan.cu``: the value
    as in K2r, each tangent ``dg + dG m + G dm`` in the kernel's order, all
    directions at once along a leading axis.  Arguments and returns as
    :func:`smoother_mean_recursion_batch_tan`."""
    n_len, d_aug, n_block, n_lane = g_aug.shape
    q = d_aug // (1 + n_tan)
    ms = torch.empty_like(g_aug)
    m = list(mN_aug[:q])
    dm = mN_aug[q:].reshape(n_tan, q, n_block, n_lane)
    for r in range(n_len - 1, -1, -1):
        G = [[G_aug[r, i * q + j] for j in range(q)] for i in range(q)]
        dG = G_aug[r, q * q:].reshape(n_tan, q * q, n_block, n_lane)
        dg = g_aug[r, q:].reshape(n_tan, q, n_block, n_lane)
        m_out, dm_out = [], []
        for i in range(q):
            acc = g_aug[r, i]
            for j in range(q):
                acc = acc + G[i][j] * m[j]
            m_out.append(acc)
        for i in range(q):
            acc = dg[:, i]
            for j in range(q):
                acc = acc + dG[:, i * q + j] * m[j] + G[i][j] * dm[:, j]
            dm_out.append(acc)
        m, dm = m_out, torch.stack(dm_out, dim=1)
        ms[r, :q] = torch.stack(m)
        ms[r, q:] = dm.reshape(n_tan * q, n_block, n_lane)
    return ms


def smoother_mean_recursion_batch_tan(g_aug, G_aug, mN_aug, n_tan):
    r"""
    Tangent-augmented lane-batched backward mean recursion (kernel K11e):
    ``m = g + G m+`` and, along each of ``n_tan`` directions,
    ``dm = dg + dG m+ + G dm+``, from the terminal values down to row 0.

    Args:
        g_aug (Tensor(T, n_aug*q, n_block, B)): Offsets and their tangents
            (``n_aug = 1 + n_tan``, the layout of
            :func:`fused_filter_batch_tan`).
        G_aug (Tensor(T, n_aug*q*q, n_block, B)): Gains, row-major, and
            their tangents.
        mN_aug (Tensor(n_aug*q, n_block, B)): Terminal values and tangents.
        n_tan (int): Number of tangent directions; the kernel holds 1 to
            ``_MAX_TAN`` = 7 at q = 3, 4 and 5.

    Returns:
        (Tensor(T, n_aug*q, n_block, B)): The means and their tangents.
    """
    n_len, d_aug, n_block, n_lane = g_aug.shape
    n_aug = 1 + n_tan
    q = d_aug // n_aug
    device = g_aug.device
    for name, t, shape in (
            ("g_aug", g_aug, (n_len, n_aug * q, n_block, n_lane)),
            ("G_aug", G_aug, (n_len, n_aug * q * q, n_block, n_lane)),
            ("mN_aug", mN_aug, (n_aug * q, n_block, n_lane))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _smoother_mean_tan_plain(g_aug, G_aug, mN_aug, n_tan)
    _check_n_tan("smoother_mean_batch_tan", n_tan)
    ms = torch.empty_like(g_aug)
    _launch(LAUNCHES, "smoother_mean_batch_tan", q, device, n_len,
            n_block * n_lane, n_tan, g_aug, G_aug, mN_aug, ms)
    return ms


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


def _fused_inputs(thetas, ode_weight, ode_inits, prior_pars, model,
                  interrogation, kalman_type, device, kernels):
    """Validate the arguments shared by the fused entry points and move the
    tensor ones to ``device`` (``None``: the CUDA card), the prior's
    variance squared in the square-root form.  Each of ``kernels``, those
    the entry runs, must hold the instance of (model, interrogation, q),
    on the CPU too, where their twins run.  Returns ``(fused model,
    device, thetas, ode_weight, ode_inits, prior_pars)``."""
    fused = resolve_model(model)
    n_block, n_bmeas, q = ode_weight.shape
    kalman_type = resolve_kalman_type(kalman_type)
    _check_mode(interrogation)
    if n_bmeas != 1:
        raise NotImplementedError("the fused kernels require n_bmeas == 1")
    for kernel in kernels:
        _check_instance(kernel, q, fused.cuda_functor, interrogation)
    device = resolve_device(device)
    move = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (fused, device, move(thetas), move(ode_weight), move(ode_inits),
            normalize_prior_pars(kalman_type,
                                 tuple(move(p) for p in prior_pars)))


def _interrogation_normals(interrogation, shape, generator, eps, device):
    """The standard normals of the chkrebtii draws: ``eps`` as given (as
    float32 on ``device``), or drawn from ``generator`` (``None``: PyTorch's
    default generator) in ``shape``; ``None`` for another interrogation,
    which draws nothing."""
    if interrogation != "chkrebtii":
        return None
    if eps is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                         f"{tuple(shape)}")
    return eps.contiguous()


def solve_mv_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max,
                         n_steps, prior_pars, model, interrogation="kramer",
                         kalman_type="standard", device=None, generator=None,
                         eps=None):
    r"""
    Lane-batched fused solve: ``B`` independent solves of one model with
    per-lane parameters and initial states, through kernels K1 and K2r on
    the CUDA card (their plain twins with ``device="cpu"``).

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
        model: Model name (``"lorenz"``, ``"fitzhugh"``, ``"hes1"``,
            ``"seirah"`` at q = 3; ``"chkrebtii"`` at q = 4 or 5), model
            module or :class:`~rodeo_tpu_torch.models.FusedModel`; it names
            both the plain right-hand side and the CUDA functor.
        interrogation (str): ``"kramer"`` (EK1), ``"rodeo"`` (EK0),
            ``"schober"`` (EK0 without measurement noise) or
            ``"chkrebtii"`` (rodeo's noise, the ODE at a draw from the
            predictive distribution).
        kalman_type (str): ``"standard"`` (packed covariances) or
            ``"sqrt"`` (the prior's variance given as a factor; packed
            Cholesky factors out, expand a lane with :func:`unpack_chol`);
            see :func:`resolve_kalman_type`.
        device: Where to run; ``None`` is the CUDA card, and raises without
            one.  The tensor arguments are moved there.
        generator (torch.Generator): Source of the chkrebtii normals, on
            ``device``; ``None`` takes PyTorch's default generator.
        eps (Tensor(N, q, n_block, B)): The chkrebtii normals in place of
            the generator's, in the JAX package's layout (its
            ``jax.random.normal(key, (N, q, n_block, B))``).  The other
            interrogations draw nothing and ignore both.

    Returns:
        (tuple): float32 **mean** ``(N+1, n_block, q, B)`` and packed
        covariance **var_packed** ``(N+1, n_block, n_tri, B)`` in original
        coordinates, upper triangles in :func:`_tri_idx` order (expand a
        lane with :func:`unpack_cov`); in the square-root form the lower
        factors of the covariances, in the same layout.

    The JAX package's entry takes ``key`` for chkrebtii's draws; the port's
    takes ``generator`` or ``eps``.
    """
    fused, device, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_batch", "smoother_batch_rows"))
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    eps = _interrogation_normals(interrogation,
                                (n_steps,) + ops["x0_lanes"].shape,
                                generator, eps, device)
    A_k, b_k, C_k, m_last, p_last = fused_filter_batch(
        fused, n_steps, **ops, mode=interrogation, eps=eps)
    # entry 0 of the gains conditions on the exact initial state, which
    # the smoother does not need: its seed is the last filtered state
    t_vec = ops["t_vec"]
    if resolve_kalman_type(kalman_type) == "standard":
        return smoother_recursion_batch_rows(
            b_k[1:], A_k[1:], C_k[1:], m_last, p_last, ops["x0_lanes"], t_vec,
            _tri_scale(t_vec))
    # the square-root form, as the JAX package forms it: the covariances
    # factored in scaled coordinates (K2r's rows at unit scale), then the
    # factor's rows scaled (entry k = (i, j) is row j)
    mean_rows, packed_rows = smoother_recursion_batch_rows(
        b_k[1:], A_k[1:], C_k[1:], m_last, p_last, ops["x0_lanes"], t_vec,
        torch.ones_like(_tri_scale(t_vec)))
    pairs, _ = _tri_idx(t_vec.shape[0])
    row_scale = torch.stack([t_vec[j] for (_, j) in pairs])
    return mean_rows, chol_packed(packed_rows, t_vec.shape[0],
                                  axis=-2) * row_scale[:, None]


def _tri_scale(t_vec):
    """The scale of each packed covariance entry (i, j): the float32
    product ``t_vec[i] * t_vec[j]``."""
    pairs, _ = _tri_idx(t_vec.shape[0])
    return torch.stack([t_vec[i] * t_vec[j] for (i, j) in pairs])


def basic_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                      prior_pars, obs_data, obs_times, obs_loglik, model,
                      interrogation="kramer", kalman_type="standard",
                      device=None, generator=None, eps=None, **params):
    r"""
    Lane-batched basic likelihood: the fused solve
    (:func:`solve_mv_fused_batch`, kernels K1 and K2r), then the user's
    ``obs_loglik`` at the posterior mean of the observed grid steps, mapped
    over the lane axis.

    Args:
        obs_data (Tensor(n_obs, ...)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_loglik (Callable): ``obs_loglik(obs_data, ode_data, **params)``
            with ``ode_data (n_obs, n_block, q)`` one lane's posterior mean
            at the observation times; it must be vmappable.
        (other args as :func:`solve_mv_fused_batch`, ``generator`` and
        ``eps`` those of chkrebtii's draws)

    Returns:
        (tuple): **loglik** ``(B,)`` and **mean** ``(N+1, n_block, q, B)``.
    """
    # squared once, here: the solve runs in the standard form
    prior_pars = normalize_prior_pars(resolve_kalman_type(kalman_type),
                                      prior_pars)
    mean_rows, _ = solve_mv_fused_batch(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        model, interrogation=interrogation, device=device,
        generator=generator, eps=eps)
    lls_of = _lane_loglik(t_min, t_max, n_steps, obs_data, obs_times,
                          obs_loglik, params, mean_rows.device)
    return lls_of(mean_rows), mean_rows


def _lane_loglik(t_min, t_max, n_steps, obs_data, obs_times, obs_loglik,
                 params, device):
    """``mean (N+1, n_block, q, B) -> loglik (B,)``: the user's
    ``obs_loglik`` at the observed grid steps, mapped over the lanes."""
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times).to(device)
    obs_data = torch.as_tensor(obs_data, device=device)

    def lls_of(mean_rows):
        ode_obs = mean_rows[obs_ind]                # (n_obs, nb, q, B)
        return torch.vmap(lambda od: obs_loglik(obs_data, od, **params),
                          in_dims=-1)(ode_obs)

    return lls_of


# --- the gradients (forward mode) ---------------------------------------------------


def solve_mv_fused_batch_grad(thetas, ode_weight, ode_inits, t_min, t_max,
                              n_steps, prior_pars, model,
                              interrogation="kramer",
                              kalman_type="standard", device=None):
    r"""
    Lane-batched fused solve's posterior mean and its derivatives in each
    parameter, through the tangent kernels K11a (the filter and its gains)
    and K11e (the mean recursion) on the CUDA card (their plain twins with
    ``device="cpu"``).  ``ode_inits`` must not depend on theta: its tangents
    are zero.

    Args as :func:`solve_mv_fused_batch`.

    Returns:
        (tuple): **mean** ``(N+1, n_block, q, B)``, equal to
        :func:`solve_mv_fused_batch`'s bitwise, and **dmean** ``(n_theta,
        N+1, n_block, q, B)``, its derivative along each parameter.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_batch_tan", "smoother_mean_batch_tan"))
    n_block, _, q = ode_weight.shape
    n_lane, n_tan = thetas.shape
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    A_aug, b_aug, _, m_last, _ = fused_filter_batch_tan(
        fused, n_steps, **ops, mode=interrogation)
    # entry 0 of the gains conditions on the exact initial state: unused
    ms = smoother_mean_recursion_batch_tan(b_aug[1:], A_aug[1:], m_last,
                                           n_tan)
    del A_aug, b_aug
    t_vec = ops["t_vec"]
    # the values, scaled as K2r scales solve_mv_fused_batch's rows
    mean_rows = torch.cat([ops["x0_lanes"].permute(1, 0, 2)[None],
                           ms[:, :q].permute(0, 2, 1, 3),
                           m_last[:q].permute(1, 0, 2)[None]])
    mean_rows *= t_vec[:, None]
    # the tangents: row 0 (the initial state) has none
    n_len = ms.shape[0]
    dmean = torch.cat([
        ms.new_zeros((n_tan, 1, n_block, q, n_lane)),
        ms[:, q:].reshape(n_len, n_tan, q, n_block, n_lane)
        .permute(1, 0, 3, 2, 4),
        m_last[q:].reshape(n_tan, q, n_block, n_lane)
        .permute(0, 2, 1, 3)[:, None]], dim=1)
    dmean *= t_vec[:, None]
    return mean_rows, dmean


def basic_fused_batch_grad(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars, obs_data, obs_times,
                           obs_loglik, model, interrogation="kramer",
                           kalman_type="standard", device=None, **params):
    r"""
    Lane-batched basic likelihood and its gradient: the tangent solve
    (:func:`solve_mv_fused_batch_grad`, kernels K11a and K11e), then
    ``torch.func.jvp`` of the lane-mapped ``obs_loglik`` along each
    parameter's ``dmean``.  Args as :func:`basic_fused_batch`.

    Returns:
        (tuple): **loglik** ``(B,)`` and **mean** ``(N+1, n_block, q, B)``,
        equal to :func:`basic_fused_batch`'s bitwise, between them **grad**
        ``(B, n_theta)``.
    """
    # squared once, here: the solve runs in the standard form
    prior_pars = normalize_prior_pars(resolve_kalman_type(kalman_type),
                                      prior_pars)
    mean_rows, dmean = solve_mv_fused_batch_grad(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        model, interrogation=interrogation, device=device)
    lls_of = _lane_loglik(t_min, t_max, n_steps, obs_data, obs_times,
                          obs_loglik, params, mean_rows.device)
    grads = [torch.func.jvp(lls_of, (mean_rows,), (dmean[k],))[1]
             for k in range(dmean.shape[0])]
    return lls_of(mean_rows), torch.stack(grads, dim=-1), mean_rows


# --- the single-solve path: K3, K4, the smoothers and solve_mv_fused -------------------


def _filter_single_plain(model, n_steps, q_const, prior_var, ode_weight,
                         t_vec, x0, theta, tgrid, mode, eps=None):
    """Plain PyTorch twin of ``csrc/filter_single.cuh``: K1's twin step
    (:func:`_predict_cols`, :func:`_interrogate_update_cols`) on ``(n_block,
    1)`` columns, one Python iteration per step.  Arguments and returns as
    :func:`fused_filter` (``model`` resolved)."""
    n_block, q = x0.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]
    W_cols = [ode_weight[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    theta_col = theta[:, None]
    mf, mp = (x0.new_empty((n_steps, n_block, q)) for _ in range(2))
    pf, pp = (x0.new_empty((n_steps, n_block, n_tri)) for _ in range(2))
    m_cols = [x0[:, j:j + 1] for j in range(q)]
    p_cols = [torch.zeros_like(m_cols[0]) for _ in range(n_tri)]
    for n in range(n_steps):
        mp_cols, pp_cols = _predict_cols(q, where, q_const, R_cols, m_cols,
                                         p_cols)
        m_cols, p_cols, _, _, _ = _interrogate_update_cols(
            model, q, pairs, where, W_cols, tv_cols, mp_cols, pp_cols,
            theta_col, tgrid[n], mode,
            None if eps is None else [eps[n, :, j:j + 1] for j in range(q)])
        mp[n] = torch.cat(mp_cols, dim=1)
        pp[n] = torch.cat(pp_cols, dim=1)
        mf[n] = torch.cat(m_cols, dim=1)
        pf[n] = torch.cat(p_cols, dim=1)
    return mf, pf, mp, pp


def fused_filter(model, n_steps, q_const, prior_var, ode_weight, t_vec, x0,
                 theta, tgrid, mode="kramer", eps=None):
    r"""
    Single-solve forward filter (kernel K3): the filtered and predicted
    moments of steps ``1..N``.  All tensors float32, in Taylor-scaled
    coordinates.

    Args:
        model, n_steps, q_const, prior_var, ode_weight, t_vec, tgrid, mode:
            As :func:`fused_filter_batch`.
        x0 (Tensor(n_block, q)): Scaled initial state.
        theta (Tensor(n_theta,)): Parameters.
        eps (Tensor(N, n_block, q)): The standard normals of the chkrebtii
            draws (the JAX package's layout); other modes take none.

    The kernel holds the instances of K1 (:func:`fused_filter_batch`).

    Returns:
        (tuple): ``mf (N, n_block, q)``, packed ``pf (N, n_block, n_tri)``,
        ``mp``, ``pp`` likewise: row ``n`` holds step ``n + 1``.
    """
    model = resolve_model(model)
    _check_mode(mode)
    n_block, q = x0.shape
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    device = x0.device
    R_packed = _pack_tri(prior_var, pairs).contiguous()
    for name, t, shape in (
            ("prior_var", R_packed, (n_block, n_tri)),
            ("ode_weight", ode_weight, (n_block, q)),
            ("t_vec", t_vec, (q,)),
            ("x0", x0, (model.n_block, q)),
            ("theta", theta, (model.n_theta,)),
            ("tgrid", tgrid, (n_steps,)),
            *_eps_operand(mode, eps, (n_steps, n_block, q))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _filter_single_plain(model, n_steps, q_const, prior_var,
                                    ode_weight, t_vec, x0, theta, tgrid, mode,
                                    eps)
    mf, mp = (x0.new_empty((n_steps, n_block, q)) for _ in range(2))
    pf, pp = (x0.new_empty((n_steps, n_block, n_tri)) for _ in range(2))
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, "filter_single", q, device, n_steps,
            ctypes.addressof(qc), R_packed, ode_weight, t_vec, x0, theta,
            tgrid, eps if mode == "chkrebtii" else None, mf, pf, mp, pp,
            model=model.cuda_functor, mode=mode)
    return mf, pf, mp, pp


def _smoother_single_plain(g, G, L, mN, pN):
    """Plain PyTorch twin of ``csrc/smoother_single.cu``: the recursion
    (:func:`_smoother_batch_plain`) with each block a column, on transposed
    views.  Arguments and returns as
    :func:`smoother_recursion`."""
    ms, ps = _smoother_batch_plain(
        *(a.permute(0, 2, 1)[..., None] for a in (g, G, L)),
        mN.T[..., None], pN.T[..., None])
    return (ms[..., 0].permute(0, 2, 1).contiguous(),
            ps[..., 0].permute(0, 2, 1).contiguous())


def smoother_recursion(g, G, L, mN, pN):
    r"""
    Single-solve backward affine recursion (kernel K4)
    ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n P_{n+1} G_n'``, from the
    terminal ``(mN, pN)`` down to row 0, in the JAX package's layout.

    Args:
        g (Tensor(T, n_block, q)): Offsets.
        G (Tensor(T, n_block, q*q)): Gains, row-major.
        L (Tensor(T, n_block, n_tri)): Packed noise terms.
        mN, pN: Terminal values ``(n_block, q)`` / ``(n_block, n_tri)``.

    Returns:
        (tuple): ``ms (T, n_block, q)``, ``ps (T, n_block, n_tri)``.
    """
    n_len, n_block, q = g.shape
    n_tri = q * (q + 1) // 2
    device = g.device
    for name, t, shape in (
            ("g", g, (n_len, n_block, q)),
            ("G", G, (n_len, n_block, q * q)),
            ("L", L, (n_len, n_block, n_tri)),
            ("mN", mN, (n_block, q)),
            ("pN", pN, (n_block, n_tri))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _smoother_single_plain(g, G, L, mN, pN)
    ms = torch.empty_like(g)
    ps = torch.empty_like(L)
    _launch(LAUNCHES, "smoother_single", q, device, n_len, n_block, g, G, L,
            mN, pN, ms, ps)
    return ms, ps


def fused_smoother(prior_weight, prior_var, mf, pf, mp, pp, mfN, pfN):
    r"""
    Single-solve smoother over every step (kernel K4): the gains in dense
    batched torch, ``G = (Pf Q') Pp^{-1}`` (:func:`inv_small`),
    ``g = mf - G mp`` and the Joseph-form ``L = (I - G Q) Pf (I - G Q)' +
    G R G'``, symmetrised, then the recursion.  TF32 stays off.

    Args:
        prior_weight, prior_var (Tensor(n_block, q, q)): Scaled transition
            ``Q`` and noise ``R``, float32.
        mf, pf: Filtered moments of steps ``1..N-1`` (``(T, n_block, q)``,
            packed ``(T, n_block, n_tri)``).
        mp, pp: Predicted moments of steps ``2..N`` (same shapes).
        mfN, pfN: The last filtered state, the seed.

    Returns:
        (tuple): Smoothed ``ms (T, n_block, q)``, packed ``ps (T, n_block,
        n_tri)`` of steps ``1..N-1``.
    """
    return smoother_recursion(
        *_smoother_gains(prior_weight, prior_var, mf, pf, mp, pp), mfN, pfN)


@full_matmul_precision
def _smoother_gains(prior_weight, prior_var, mf, pf, mp, pp):
    """K4's operands ``(g, G, L)`` in :func:`fused_smoother`: the gains in
    dense batched torch, TF32 off."""
    n_len, n_block, q = mf.shape
    pairs, _ = _tri_idx(q)
    Pf, Pp = unpack_cov(pf), unpack_cov(pp)
    G = (Pf @ prior_weight.mT) @ inv_small(Pp)
    g = mf - torch.einsum("...ij,...j->...i", G, mp)
    IGQ = torch.eye(q, dtype=Pf.dtype, device=Pf.device) - G @ prior_weight
    L = IGQ @ Pf @ IGQ.mT + G @ prior_var @ G.mT
    L = 0.5 * (L + L.mT)
    return (g.contiguous(), G.reshape(n_len, n_block, q * q).contiguous(),
            _pack_tri(L, pairs).contiguous())


def _affine_cov_compose(q, n_tri, where, early, late):
    """Compose two elements ``(G, g, L)`` of the recursion in column
    layout, ``early`` then ``late`` (to its right in time):
    ``(G_e G_l, g_e + G_e g_l, L_e + G_e L_l G_e')``."""
    G_i, g_i, L_i = early
    G_j, g_j, L_j = late
    G = [[None] * q for _ in range(q)]
    for i in range(q):
        for j in range(q):
            acc = None
            for k in range(q):
                acc = _acc(acc, G_i[i][k] * G_j[k][j])
            G[i][j] = acc
    g = [g_i[i] + sum(G_i[i][k] * g_j[k] for k in range(q))
         for i in range(q)]
    GLG = _sym_quadform(q, G_i, L_j, where)
    L = [L_i[k] + GLG[k] for k in range(n_tri)]
    return G, g, L


def _composed_groups(n_len, k):
    """The JAX package's grouping of ``n_len`` rows into k-row groups: the
    number of groups (rounded up to a multiple of 8 once there are 16 or
    more) and the number of identity rows padded in front.  It decides at
    which rows the composed smoother rounds, so it is kept as it is."""
    n_groups = -(-n_len // k)
    if n_groups >= 16:
        n_groups = -(-n_groups // 8) * 8
    return n_groups, n_groups * k - n_len


def _composed_suffixes(q_const, prior_var, mf, pf, mp, pp, k_compose):
    """The per-step gains in column arithmetic, identity-padded in front
    and grouped by ``k_compose`` rows as the JAX package groups them, and
    the suffix composites within each group: ``comp[i]`` composes offsets
    ``i .. k-1`` (each entry ``(n_groups, n_block)``), ``comp[0]`` the whole
    group.  Returns ``comp`` and the number of padded rows."""
    n_len, n_block, q = mf.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    G, g, L = _gain_cols_batched(
        q, n_tri, q_const, [R_packed[None, :, k] for k in range(n_tri)],
        [mf[:, :, j] for j in range(q)], [pf[:, :, k] for k in range(n_tri)],
        [mp[:, :, j] for j in range(q)], [pp[:, :, k] for k in range(n_tri)])
    k = max(1, int(k_compose))
    n_groups, pad = _composed_groups(n_len, k)

    def grouped(col, fill):
        """Identity-padded in front, then ``(n_groups, k, n_block)``."""
        col = torch.cat([col.new_full((pad, n_block), fill), col])
        return col.reshape(n_groups, k, n_block)

    Gg = [[grouped(G[i][j], float(i == j)) for j in range(q)]
          for i in range(q)]
    gg = [grouped(g[i], 0.0) for i in range(q)]
    Lg = [grouped(L[kk], 0.0) for kk in range(n_tri)]

    def element(i):
        return ([[Gg[a][b][:, i] for b in range(q)] for a in range(q)],
                [gg[a][:, i] for a in range(q)],
                [Lg[kk][:, i] for kk in range(n_tri)])

    comp = [None] * k
    comp[k - 1] = element(k - 1)
    for i in range(k - 2, -1, -1):
        comp[i] = _affine_cov_compose(q, n_tri, where, element(i),
                                      comp[i + 1])
    return comp, pad


def _boundary_operands(comp):
    """K4's operands ``(g, G, L)`` over the groups' boundary steps in
    :func:`fused_smoother_composed`: the whole groups' composites."""
    Gc, gc, Lc = comp[0]
    q = len(gc)
    return (torch.stack(gc, dim=-1),
            torch.stack([Gc[i][j] for i in range(q) for j in range(q)],
                        dim=-1),
            torch.stack(Lc, dim=-1))


def fused_smoother_composed(q_const, prior_var, mf, pf, mp, pp, mfN, pfN,
                            k_compose=8):
    r"""
    As :func:`fused_smoother`, with the sequential recursion shortened
    ``k_compose``-fold by exact k-step composition: the per-step gains in
    column arithmetic (:func:`_gain_cols_batched`), the suffix composites
    within each group, kernel K4 over the groups' boundary steps, and the
    interior rows of every group in one batched pass.  Exact in exact
    arithmetic; in float32 the recursion's rounding enters at ``N/k``
    boundary steps instead of ``N`` (the JAX package's guard against its
    plain recursion's drift over long horizons on the TPU).

    Args:
        q_const (list of lists of float): Scaled transition, from
            :func:`_static_scaled_qconst`.
        prior_var (Tensor(n_block, q, q)): Scaled noise ``R``.
        mf, pf, mp, pp, mfN, pfN: As :func:`fused_smoother`.
        k_compose (int): Steps per group.

    Returns:
        (tuple): As :func:`fused_smoother`.
    """
    n_block, q = mfN.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    comp, pad = _composed_suffixes(q_const, prior_var, mf, pf, mp, pp,
                                   k_compose)
    k = len(comp)
    # the boundary recursion over the groups (K4): mb[g] is the smoothed
    # state at offset 0 of group g
    mb, pb = smoother_recursion(*_boundary_operands(comp), mfN, pfN)
    # each group's right boundary: the next group's offset 0, or the seed
    mb_right = torch.cat([mb[1:], mfN[None]])
    pb_right = torch.cat([pb[1:], pfN[None]])
    m_r = [mb_right[:, :, j] for j in range(q)]
    p_r = [pb_right[:, :, kk] for kk in range(n_tri)]
    rows_m, rows_p = [mb], [pb]
    for i in range(1, k):
        Gi, gi, Li = comp[i]
        m_i = []
        for a in range(q):
            acc = gi[a]
            for b in range(q):
                acc = acc + Gi[a][b] * m_r[b]
            m_i.append(acc)
        GP = _sym_quadform(q, Gi, p_r, where)
        rows_m.append(torch.stack(m_i, dim=-1))
        rows_p.append(torch.stack([Li[kk] + GP[kk] for kk in range(n_tri)],
                                  dim=-1))
    # interleave the offsets back into the time axis
    ms = torch.stack(rows_m, dim=1).reshape(-1, n_block, q)
    ps = torch.stack(rows_p, dim=1).reshape(-1, n_block, n_tri)
    return ms[pad:], ps[pad:]


def _single_operands(theta, ode_weight, ode_init, t_min, t_max, n_steps,
                     prior_pars):
    """The operands of :func:`fused_filter` for one solve (those of
    :func:`_kernel_operands` on one lane), and the scaled float32
    transition ``Qs``."""
    ops = _kernel_operands(theta[None], ode_weight, ode_init[None], t_min,
                           t_max, n_steps, prior_pars)
    ops["x0"] = ops.pop("x0_lanes")[..., 0].T.contiguous()
    ops["theta"] = ops.pop("theta_lanes")[:, 0].contiguous()
    Qs, _ = scale_prior(prior_pars, ops["t_vec"])
    return ops, Qs.to(torch.float32)


def solve_mv_fused(theta, ode_weight, ode_init, t_min, t_max, n_steps,
                   prior_pars, model, interrogation="kramer", k_compose=None,
                   kalman_type="standard", device=None, generator=None,
                   eps=None):
    r"""
    Posterior mean and variance of one ODE solve (the latency path),
    through kernels K3 (the filter) and K4 (the smoother) on the CUDA card,
    their plain twins with ``device="cpu"``.

    Args:
        theta (Tensor(n_theta,)): Parameters.
        ode_weight (Tensor(n_block, 1, q)): Weight matrix ``W``.
        ode_init (Tensor(n_block, q)): Initial state (original
            coordinates).
        t_min, t_max (float): Time interval.
        n_steps (int): Number of steps ``N``.
        prior_pars (tuple): ``(prior_weight, prior_var)``, each
            ``(n_block, q, q)``; the transition must be the same for every
            block (the IBM prior).
        model: Model name (as :func:`solve_mv_fused_batch` takes them),
            model module or :class:`~rodeo_tpu_torch.models.FusedModel`.
        interrogation (str): ``"kramer"``, ``"rodeo"``, ``"schober"`` or
            ``"chkrebtii"``, as :func:`solve_mv_fused_batch` takes them.
        k_compose (int or None): Steps per group of the composed smoother
            (:func:`fused_smoother_composed`); ``None`` or 1 runs the plain
            recursion (:func:`fused_smoother`).  The JAX package composes 16
            steps from ``N = 512`` on, against a drift of its plain
            recursion on the TPU.  On the card the plain float32 recursion
            lands as close to a float64 smoother on the same filter states
            as the composed one, up to 50 000 steps
            (``tools/torch_smoother_drift.py``), at a tenth of its time, so
            it is the default here.
        kalman_type (str): ``"standard"``, or ``"sqrt"``: the prior's
            variance given as a factor, and **var** the lower Cholesky
            factors of the covariances (see :func:`resolve_kalman_type`).
        device: Where to run; ``None`` is the CUDA card, and raises without
            one.  The tensor arguments are moved there.
        generator (torch.Generator), eps (Tensor(N, n_block, q)): The
            source of chkrebtii's normals, or the normals in the JAX
            package's layout, as :func:`solve_mv_fused_batch` takes them.

    Returns:
        (tuple): float32 **mean** ``(N+1, n_block, q)`` and dense **var**
        ``(N+1, n_block, q, q)`` in original coordinates: row 0 the exact
        initial state with zero variance, rows ``1..N-1`` smoothed, row
        ``N`` filtered.

    The JAX package's entry takes ``(key, ode_fun, ...)`` and the model as
    the callables ``ode_flat`` / ``jac_flat``; the port's takes ``theta``
    first, names a model with a CUDA functor (``model=``) and takes
    chkrebtii's normals as ``generator`` or ``eps``, departures that stand
    until the fused kernels compile a user's functor.
    """
    fused, device, theta, ode_weight, ode_init, prior_pars = _fused_inputs(
        theta, ode_weight, ode_init, prior_pars, model, interrogation,
        kalman_type, device, ("filter_single", "smoother_single"))
    ops, Qs = _single_operands(theta, ode_weight, ode_init, t_min, t_max,
                               n_steps, prior_pars)
    eps = _interrogation_normals(interrogation,
                                (n_steps,) + ops["x0"].shape, generator, eps,
                                device)
    mf, pf, mp, pp = fused_filter(fused, n_steps, **ops, mode=interrogation,
                                  eps=eps)
    return _smoothed_rows(ops, Qs, mf, pf, mp, pp, k_compose,
                          sqrt=resolve_kalman_type(kalman_type) == "sqrt")


def _smoothed_rows(ops, Qs, mf, pf, mp, pp, k_compose, sqrt=False):
    """Rows ``0..N`` of one solve from the filtered and predicted moments
    of its steps ``1..N``: the exact initial state with zero variance,
    rows ``1..N-1`` smoothed (K4, plain or ``k_compose``-step composed),
    row ``N`` filtered, in original coordinates.  With ``sqrt``, the
    variances are the lower Cholesky factors of the covariances, factored
    in scaled coordinates and their rows scaled, as the JAX package's
    ``solve_mv_fused`` forms them."""
    args = (ops["prior_var"], mf[:-1], pf[:-1], mp[1:], pp[1:], mf[-1],
            pf[-1])
    if k_compose is not None and k_compose > 1:
        ms, ps = fused_smoother_composed(ops["q_const"], *args,
                                         k_compose=k_compose)
    else:
        ms, ps = fused_smoother(Qs, *args)
    t_vec = ops["t_vec"]
    mean = torch.cat([ops["x0"][None], ms, mf[-1:]]) * t_vec
    packed = torch.cat([ps.new_zeros((1,) + ps.shape[1:]), ps, pf[-1:]])
    if sqrt:
        return mean, unpack_chol(chol_packed(packed, t_vec.shape[0])) \
            * t_vec[:, None]
    return mean, unpack_cov(packed) * (t_vec[:, None] * t_vec[None, :])


# --- the stationary-gain single solve: K5a, K5b, K5c -----------------------
#
# Where the measurement row H is constant in time (EK0 always, EK1 when the
# block Jacobian does not depend on the state, as Lorenz63's), the Riccati
# recursion of the covariances is autonomous and its gain converges within
# a few tens of steps.  solve_mv_fused_stationary runs an exact n_warm-step
# prefix through K3, freezes the gain, and runs only the mean chain beyond
# it: K5a on short horizons, otherwise K5b over 64-step groups with K5c
# recovering the groups' interiors.

# steps per group of the two-phase mean chain, the JAX package's
_K_GROUP = 64


def _mean_step_cols(model, q, q_const, W_cols, tv_cols, theta_col, K_cols,
                    m_cols, t):
    """One step of the mean chain on columns ``(n_block, B)`` (``mean_step``
    of ``csrc/mean_chain_single.cu``): ``mp = Q m``, ``z = f(mp tv) - W
    mp``, ``m = mp + K z``.  The Jacobian terms of EK1's innovation cancel,
    so EK0 and EK1 share the step."""
    mp_cols = _matvec(q, q_const, m_cols)
    x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
    f0 = model.flat(x_cols, theta_col, t)
    wm = None
    for j in range(q):
        wm = _acc(wm, W_cols[j] * mp_cols[j])
    z = f0 - wm
    return [mp_cols[i] + K_cols[i] * z for i in range(q)]


def _mean_cols(ode_weight, t_vec, theta):
    """``q`` and the operands of :func:`_mean_step_cols` that every step
    shares, in columns."""
    q = ode_weight.shape[1]
    return (q, [ode_weight[:, j:j + 1] for j in range(q)],
            [t_vec[j] for j in range(q)], theta[:, None])


def _mean_gain_plain(model, q_const, ode_weight, t_vec, x0, theta, tgrid,
                     gains):
    """Plain PyTorch twin of K5a (``mean_gain_single``): one Python
    iteration per step on ``(n_block, 1)`` columns.  Arguments and returns
    as :func:`mean_gain_chain` (``model`` resolved)."""
    q, W_cols, tv_cols, theta_col = _mean_cols(ode_weight, t_vec, theta)
    mf = x0.new_empty((tgrid.shape[0],) + x0.shape)
    m_cols = [x0[:, j:j + 1] for j in range(q)]
    for n in range(tgrid.shape[0]):
        m_cols = _mean_step_cols(
            model, q, q_const, W_cols, tv_cols, theta_col,
            [gains[n, :, i:i + 1] for i in range(q)], m_cols, tgrid[n])
        mf[n] = torch.cat(m_cols, dim=1)
    return mf


def _mean_boundary_plain(model, q_const, ode_weight, t_vec, m0, theta,
                         tgrid, k_star, k_group):
    """Plain PyTorch twin of K5b (``mean_boundary_single``): the chain with
    the frozen gain on ``(n_block, 1)`` columns, storing each group's entry
    state.  Arguments and returns as :func:`mean_boundary_chain`."""
    q, W_cols, tv_cols, theta_col = _mean_cols(ode_weight, t_vec, theta)
    K_cols = [k_star[:, i:i + 1] for i in range(q)]
    n_group = tgrid.shape[0] // k_group
    bnd = m0.new_empty((n_group,) + m0.shape)
    m_cols = [m0[:, j:j + 1] for j in range(q)]
    for g in range(n_group):
        bnd[g] = torch.cat(m_cols, dim=1)
        for r in range(k_group):
            m_cols = _mean_step_cols(model, q, q_const, W_cols, tv_cols,
                                     theta_col, K_cols, m_cols,
                                     tgrid[g * k_group + r])
    return bnd


def _mean_recovery_plain(model, q_const, ode_weight, t_vec, bnd, theta,
                         tgrid, k_star):
    """Plain PyTorch twin of K5c (``mean_recovery_single``): every group's
    chain at once on ``(n_block, n_group)`` columns, one Python iteration
    per step of a group.  Arguments and returns as
    :func:`mean_recovery_chain`."""
    q, W_cols, tv_cols, theta_col = _mean_cols(ode_weight, t_vec, theta)
    n_group, n_block, _ = bnd.shape
    k_group = tgrid.shape[0] // n_group
    t_rows = tgrid.reshape(n_group, k_group)
    K_cols = [k_star[:, i:i + 1] for i in range(q)]
    mf = bnd.new_empty((n_group, k_group, n_block, q))
    m_cols = [bnd[:, :, j].T for j in range(q)]
    for r in range(k_group):
        m_cols = _mean_step_cols(model, q, q_const, W_cols, tv_cols,
                                 theta_col, K_cols, m_cols,
                                 t_rows[None, :, r])
        mf[:, r] = torch.stack(m_cols, dim=-1).transpose(0, 1)
    return mf.reshape(n_group * k_group, n_block, q)


def _check_mean_operands(model, ode_weight, t_vec, theta, tgrid, **named):
    """Validate the operands of a mean-chain kernel: those every one takes,
    and ``named`` as ``name=(tensor, shape)``."""
    n_block, q = ode_weight.shape
    device = ode_weight.device
    for name, t, shape in (
            ("ode_weight", ode_weight, (model.n_block, q)),
            ("t_vec", t_vec, (q,)),
            ("theta", theta, (model.n_theta,)),
            ("tgrid", tgrid, (tgrid.shape[0],)),
            *((k, t, shape) for k, (t, shape) in named.items())):
        _check(name, t, shape, device)
    return n_block, q, device


def mean_gain_chain(model, q_const, ode_weight, t_vec, x0, theta, tgrid,
                    gains):
    r"""
    The mean chain with a gain per step (kernel K5a): from ``x0``, step
    ``n`` at time ``tgrid[n]`` with gain ``gains[n]``.  All tensors float32,
    in Taylor-scaled coordinates.

    Args:
        model: Model name, module or
            :class:`~rodeo_tpu_torch.models.FusedModel`.
        q_const (list of lists of float): Scaled transition, from
            :func:`_static_scaled_qconst`.
        ode_weight (Tensor(n_block, q)): Scaled weight ``W``.
        t_vec (Tensor(q,)): Taylor scales.
        x0 (Tensor(n_block, q)): Scaled initial state.
        theta (Tensor(n_theta,)): Parameters.
        tgrid (Tensor(N,)): Time of each step.
        gains (Tensor(N, n_block, q)): Gain of each step.

    Returns:
        (Tensor(N, n_block, q)): The filtered mean of each step.
    """
    model = resolve_model(model)
    n_steps = tgrid.shape[0]
    n_block, q, device = _check_mean_operands(
        model, ode_weight, t_vec, theta, tgrid,
        x0=(x0, ode_weight.shape), gains=(gains, (n_steps,) + x0.shape))
    if device.type == "cpu":
        return _mean_gain_plain(model, q_const, ode_weight, t_vec, x0, theta,
                                tgrid, gains)
    mf = x0.new_empty((n_steps, n_block, q))
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, "mean_gain_single", q, device, n_steps,
            ctypes.addressof(qc), ode_weight, t_vec, x0, theta, tgrid, gains,
            mf, model=model.cuda_functor)
    return mf


def _whole_groups(n_len, n_group):
    """The steps per group of ``n_len`` steps in ``n_group`` groups."""
    if n_group < 1 or n_len % n_group:
        raise ValueError(f"{n_len} steps do not make {n_group} whole groups")
    return n_len // n_group


def mean_boundary_chain(model, q_const, ode_weight, t_vec, m0, theta, tgrid,
                        k_star):
    r"""
    The mean chain with the frozen gain ``k_star`` over groups of 64 steps
    (kernel K5b), storing only each group's entry state.  Arguments as
    :func:`mean_gain_chain`, with ``m0 (n_block, q)`` the state before the
    first step, ``tgrid`` the times of ``64 n_group`` steps and ``k_star
    (n_block, q)``.  The kernel takes any ``q_const``, the same for every
    block.

    Returns:
        (Tensor(n_group, n_block, q)): Each group's entry state.
    """
    model = resolve_model(model)
    n_group = tgrid.shape[0] // _K_GROUP
    k_group = _whole_groups(tgrid.shape[0], n_group)
    n_block, q, device = _check_mean_operands(
        model, ode_weight, t_vec, theta, tgrid, m0=(m0, ode_weight.shape),
        k_star=(k_star, ode_weight.shape))
    if device.type == "cpu":
        return _mean_boundary_plain(model, q_const, ode_weight, t_vec, m0,
                                    theta, tgrid, k_star, k_group)
    bnd = m0.new_empty((n_group, n_block, q))
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, "mean_boundary_single", q, device, n_group, k_group,
            ctypes.addressof(qc), ode_weight, t_vec, m0, theta, tgrid, k_star,
            bnd, model=model.cuda_functor)
    return bnd


def _mean_gain_geometry(model, device=None):
    """The launch of kernel K5a (:func:`mean_gain_chain`) on the card, a CTA
    of a consumer and a producer warp, as :func:`_launch_geometry` reports
    it, with the ring's stages and the steps a stage holds."""
    model = resolve_model(model)
    return _launch_geometry("mean_gain_single", device,
                            extra=("stages", "rows_per_stage"),
                            model=model.cuda_functor)


def _mean_boundary_geometry(model, device=None):
    """The launch of kernel K5b (:func:`mean_boundary_chain`) on the card,
    one CTA of a thread per block, as :func:`_launch_geometry` reports
    it."""
    model = resolve_model(model)
    return _launch_geometry("mean_boundary_single", device,
                            model=model.cuda_functor)


def _mean_recovery_geometry(model, n_group, device=None):
    """The launch of kernel K5c (:func:`mean_recovery_chain`) over
    ``n_group`` groups on the card, a thread per (group, block), as
    :func:`_launch_geometry` reports it, with the groups a CTA holds and
    the most steps a group may have."""
    model = resolve_model(model)
    return _launch_geometry("mean_recovery_single", device, n_group,
                            extra=("groups_per_cta", "max_group_steps"),
                            model=model.cuda_functor)


def mean_recovery_chain(model, q_const, ode_weight, t_vec, bnd, theta, tgrid,
                        k_star):
    r"""
    Every group's steps re-run from its entry state ``bnd`` with the frozen
    gain, the groups in parallel (kernel K5c).  Arguments as
    :func:`mean_boundary_chain`, with ``bnd (n_group, n_block, q)`` its
    output.  On the card a group holds at most 64 steps, the stationary
    schedule's (``_K_GROUP``); the CPU twin takes any.

    Returns:
        (Tensor(n_group * k_group, n_block, q)): The filtered mean of each
        step of ``tgrid``: :func:`mean_gain_chain` from the same start with
        the gain ``k_star`` at every step, bitwise.
    """
    model = resolve_model(model)
    n_group = bnd.shape[0]
    k_group = _whole_groups(tgrid.shape[0], n_group)
    n_block, q, device = _check_mean_operands(
        model, ode_weight, t_vec, theta, tgrid,
        bnd=(bnd, (n_group,) + ode_weight.shape),
        k_star=(k_star, ode_weight.shape))
    if device.type == "cpu":
        return _mean_recovery_plain(model, q_const, ode_weight, t_vec, bnd,
                                    theta, tgrid, k_star)
    if k_group > _K_GROUP:
        raise ValueError(f"kernel K5c runs groups of at most {_K_GROUP} "
                         f"steps, not {k_group}")
    mf = bnd.new_empty((n_group * k_group, n_block, q))
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, "mean_recovery_single", q, device, n_group, k_group,
            ctypes.addressof(qc), ode_weight, t_vec, bnd, theta, tgrid,
            k_star, mf, model=model.cuda_functor)
    return mf


def _stationary_schedule(n_steps, n_warm, two_phase):
    """The JAX package's schedule: the exact prefix's length and the number
    of ``_K_GROUP``-step groups of the tail (two-phase from 2 groups on,
    the prefix absorbing the remainder)."""
    n_warm = min(n_warm, n_steps)
    n_group = max((n_steps - n_warm) // _K_GROUP, 0) if two_phase else 0
    if n_group >= 2:
        n_warm = n_steps - n_group * _K_GROUP
    return n_warm, n_group


def _stationary_gains(fused, ops, ppw, interrogation, t_min):
    """The gain of each prefix step from its predicted covariance and the
    constant measurement row ``H`` (``W``; under EK1 ``W - J tv``, the
    Jacobian taken at a zero state): ``K = Pp H / (H Pp H)``, the variance
    doubled under EK0.  Returns ``(n_warm, n_block, q)``."""
    W_s, t_vec = ops["ode_weight"], ops["t_vec"]
    n_block, q = W_s.shape
    H = W_s
    if interrogation == "kramer":
        zero = W_s.new_zeros((n_block, 1))
        jd = fused.jac_flat([zero] * q, ops["theta"][:, None],
                            W_s.new_tensor(t_min))
        H = W_s - torch.cat([(zero if c is None else c) * t_vec[j]
                             for j, c in enumerate(jd)], dim=1)
    Pp = unpack_cov(ppw)
    PH = Pp[..., 0] * H[:, None, 0]
    for j in range(1, q):
        PH = PH + Pp[..., j] * H[:, None, j]
    S = H[:, 0] * PH[..., 0]
    for i in range(1, q):
        S = S + H[:, i] * PH[..., i]
    if interrogation == "rodeo":
        S = 2.0 * S
    return PH / S[..., None]


def solve_mv_fused_stationary(theta, ode_weight, ode_init, t_min, t_max,
                              n_steps, prior_pars, model,
                              interrogation="kramer", k_compose=None,
                              n_warm=64, two_phase=True,
                              kalman_type="standard", device=None):
    r"""
    :func:`solve_mv_fused` for a measurement row that is constant in time:
    an exact ``n_warm``-step Riccati prefix (kernel K3), the gain frozen
    beyond it and only the mean chain run there (kernels K5b and K5c, or K5a
    on short horizons), and the smoother (K4) over the prefix's covariances
    followed by their last row.  On the CUDA card; the plain twins with
    ``device="cpu"``.

    Valid for EK0 (``interrogation="rodeo"``) on any model, and for EK1
    (``"kramer"``) only where the Jacobian does not depend on the state, as
    Lorenz63's; the caller asserts this, as with the JAX package.

    Args:
        n_warm (int): Steps of the exact prefix (at most ``N``); from two
            64-step groups of the tail on, the prefix takes the remainder,
            ``N - 64 n_group``.
        two_phase (bool): Run the tail as K5b and K5c (the JAX package's
            two-phase schedule); ``False``, or fewer than two groups, runs
            K5a over all ``N`` steps from the initial state with the
            prefix's gains and then the frozen one, whose means replace the
            prefix's.
        k_compose (int or None): As :func:`solve_mv_fused`: ``None`` runs
            the plain recursion; 64 is the JAX package's composition.
        kalman_type (str): As :func:`solve_mv_fused`; in the square-root
            form the variances are the lower Cholesky factors of the dense
            covariances (:func:`~rodeo_tpu_torch.ops.linalg.chol_small`),
            as the JAX package's.
        (other arguments as :func:`solve_mv_fused`)

    Returns:
        (tuple): As :func:`solve_mv_fused`.

    As :func:`solve_mv_fused`, the entry takes ``theta`` first and
    ``model=`` where the JAX package's takes ``(key, ode_fun, ...)`` and
    the callables ``ode_flat`` / ``jac_flat``; its TPU schedule knobs
    ``chunk=``, ``unroll=`` and ``interpret=`` have no counterpart.
    """
    if interrogation not in ("kramer", "rodeo"):
        raise NotImplementedError(
            "stationary gains require a deterministic time-constant "
            "interrogation (kramer with state-independent Jacobian, or "
            "rodeo)")
    fused, _, theta, ode_weight, ode_init, prior_pars = _fused_inputs(
        theta, ode_weight, ode_init, prior_pars, model, interrogation,
        kalman_type, device, ("filter_single", "mean_gain_single",
                              "mean_boundary_single", "mean_recovery_single",
                              "smoother_single"))
    ops, Qs = _single_operands(theta, ode_weight, ode_init, t_min, t_max,
                               n_steps, prior_pars)
    n_block, q = ops["x0"].shape
    n_warm, n_group = _stationary_schedule(n_steps, n_warm, two_phase)
    # the exact Riccati prefix, on the raw prior's transition constants
    tgrid = ops["tgrid"]
    mfw, pfw, _, ppw = fused_filter(fused, n_warm, **{**ops,
                                                     "tgrid": tgrid[:n_warm]},
                                    mode=interrogation)
    K_pre = _stationary_gains(fused, ops, ppw, interrogation, t_min)
    K_star = K_pre[-1]
    chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
    if n_group >= 2:
        tail = tgrid[n_warm:]
        bnd = mean_boundary_chain(*chain, mfw[-1], ops["theta"], tail, K_star)
        mf = torch.cat([mfw, mean_recovery_chain(*chain, bnd, ops["theta"],
                                                 tail, K_star)])
    else:
        gains = torch.cat([K_pre,
                           K_star.expand(n_steps - n_warm, n_block, q)])
        mf = mean_gain_chain(*chain, ops["x0"], ops["theta"], tgrid, gains)
    # the predicted means mp_n = Q mf_{n-1} (mp_1 = Q x0), and the prefix's
    # covariances followed by their frozen last row
    prev = torch.cat([ops["x0"][None], mf[:-1]])
    mp = torch.stack(_matvec(q, ops["q_const"], list(prev.unbind(-1))),
                     dim=-1)
    frozen = (n_steps - n_warm,) + pfw.shape[1:]
    pf = torch.cat([pfw, pfw[-1].expand(frozen)])
    pp = torch.cat([ppw, ppw[-1].expand(frozen)])
    mean, var = _smoothed_rows(ops, Qs, mf, pf, mp, pp, k_compose)
    if resolve_kalman_type(kalman_type) == "sqrt":
        # the JAX package factors the dense covariances here
        var = chol_small(var)
    return mean, var
