r"""
Lane-batched MAGI log-density and its path gradient on the GPU (port of
:mod:`rodeo_tpu.ops.pallas_magi`: ``magi_fused_batch`` and
``magi_fused_batch_grad``).

The MAGI filter conditions the Gauss-Markov prior on *exact*
pseudo-observations of the first ``n_active`` derivatives of a fixed
expanded path: there is no interrogation and no ODE callback, so each
step predicts through the constant Pascal transition, takes the forecast
log-density of the active block, and collapses the active rows onto the
data (the inactive block conditioned through ``G = P_ia S^{-1}``).  The
covariances never see the data, so the log-density's gradient in the path
is a linear backward recursion with the coefficients the forward pass
stores.

- **K10a** ``csrc/magi_batch.cu`` replaces ``_magi_kernel_batch``: the
  filter, a forward stream of one thread per (block, lane) fed by a producer
  warp, summing each block's log-density; with ``emit="adjoint"`` it also
  streams out each step's innovation ``z``, packed ``S^{-1}`` and gain
  ``G``;
- **K10b** ``csrc/magi_adjoint_batch.cu`` replaces
  ``_magi_adjoint_kernel_batch``: the exact reverse adjoint over those
  streams, a reverse stream of one thread per (block, lane) fed by a
  producer warp, giving the gradient in the active rows of steps 1..N and
  in the whole seed row.

:class:`MagiLogdens` is the ``torch.autograd.Function`` over the expanded
paths whose forward launches K10a and whose backward launches K10b;
:func:`magi_fused_batch` and :func:`magi_fused_batch_grad` put the user's
``ode_expand`` (under ``torch.vmap``) in front of it, so the chain rule
through it is PyTorch's.

The TPU wrapper's lane fold (``_lane_fold_factor``, ``_fold_lanes``), its
chunk picking and ``chunk=`` / ``interpret=`` lay the data out for VMEM
tiles and the TPU's grid steps; a CUDA thread loops over all steps, so the
port takes none of them.

The plain PyTorch twins are :func:`_magi_batch_plain` and
:func:`_magi_adjoint_batch_plain`: the kernels' float32 operations in the
same order.  The wrappers take them only for CPU tensors; for a CUDA
tensor they launch the kernel or raise.  ``LAUNCHES`` counts the launches.
Every step works in float32 in the Taylor-scaled coordinates of
:mod:`rodeo_tpu_torch.ops.precond`, the covariances packed in
:func:`~rodeo_tpu_torch.ops.fused_kalman._tri_idx` order.
"""
import ctypes
import math

import torch
from torch.autograd.function import once_differentiable
from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.ops.fused_kalman import (
    _LOG2PI, _acc, _block_sum, _check, _host_qconst, _launch,
    _launch_geometry, _matvec, _pack_tri, _static_scaled_qconst, _sym_inv,
    _sym_quadform, _tri_idx)
from rodeo_tpu_torch.ops.precond import scale_prior, taylor_scale
from rodeo_tpu_torch.pytree import tree_flatten, tree_unflatten

__all__ = ["magi_fused_batch", "magi_fused_batch_grad", "MagiLogdens",
           "magi_filter_batch", "magi_adjoint_batch", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"magi_batch": 0, "magi_adjoint_batch": 0}

_EMITS = {"ld": 0, "adjoint": 1}


def _sym_det(a, S_cols):
    """Determinant of a packed-symmetric column matrix, ``a <= 3``; not
    scale-normalised, as in the JAX package (the scaled coordinates keep
    the entries O(1))."""
    if a == 1:
        return S_cols[0]
    if a == 2:
        s00, s01, s11 = S_cols
        return s00 * s11 - s01 * s01
    if a == 3:
        s00, s01, s02, s11, s12, s22 = S_cols
        return (s00 * (s11 * s22 - s12 * s12)
                - s01 * (s01 * s22 - s12 * s02)
                + s02 * (s01 * s12 - s11 * s02))
    raise NotImplementedError("magi_fused_batch supports n_active <= 3")


# --- K10a: the filter on exact pseudo-observations ----------------------------------


def _magi_batch_plain(x, R, m0, q_const, emit):
    """Plain PyTorch twin of ``csrc/magi_batch.cu``: the same float32
    operations in the same order, one Python iteration per step.  Arguments
    as :func:`magi_filter_batch`.  Returns each block's log-density sum
    ``(n_block, B)`` and, with ``emit="adjoint"``, the streams ``z``,
    ``s_inv`` and ``G`` (``None`` when ``q == act``)."""
    n_steps, act, n_block, n_lane = x.shape
    q = m0.shape[0]
    pairs, where = _tri_idx(q)
    pairs_a, where_a = _tri_idx(act)
    n_tri = len(pairs)
    R_cols = list(R)
    m_cols = list(m0)
    zero = torch.zeros_like(m0[0])
    p_cols = [zero] * n_tri
    ld = zero
    if emit == "adjoint":
        z_out = torch.empty_like(x)
        s_out = x.new_empty((n_steps, len(pairs_a), n_block, n_lane))
        g_out = x.new_empty((n_steps, (q - act) * act, n_block, n_lane)) \
            if q > act else None
    for r in range(n_steps):
        mp = _matvec(q, q_const, m_cols)
        app = _sym_quadform(q, q_const, p_cols, where)
        pp = [app[k] + R_cols[k] for k in range(n_tri)]
        # forecast log-density of the active block
        S_cols = [pp[where[(i, j)]] for (i, j) in pairs_a]
        z = [x[r, j] - mp[j] for j in range(act)]
        inv_S = _sym_inv(act, S_cols)
        quad = None
        for i in range(act):
            for j in range(act):
                quad = _acc(quad, z[i] * inv_S[where_a[(i, j)]] * z[j])
        det = _sym_det(act, S_cols)
        ld = ld + -0.5 * (quad + torch.log(det) + act * _LOG2PI)
        # exact-observation update: the active rows collapse onto the data,
        # the inactive block is conditioned through G = P_ia S^{-1}
        G = [[None] * act for _ in range(q)]
        for i in range(act, q):
            for a in range(act):
                acc = None
                for b in range(act):
                    acc = _acc(acc, pp[where[(i, b)]] * inv_S[where_a[(b, a)]])
                G[i][a] = acc
        m_cols = [x[r, j] for j in range(act)]
        for i in range(act, q):
            acc = mp[i]
            for a in range(act):
                acc = acc + G[i][a] * z[a]
            m_cols.append(acc)
        p_new = []
        for kk, (i, j) in enumerate(pairs):
            if i < act or j < act:
                p_new.append(zero)
                continue
            acc = pp[kk]
            for a in range(act):
                acc = acc - G[i][a] * pp[where[(a, j)]]
            p_new.append(acc)
        p_cols = p_new
        if emit == "adjoint":
            z_out[r] = torch.stack(z)
            s_out[r] = torch.stack(inv_S)
            if g_out is not None:
                g_out[r] = torch.stack([G[i][a] for i in range(act, q)
                                        for a in range(act)])
    if emit == "adjoint":
        return ld, z_out, s_out, g_out
    return ld


def _magi_batch_geometry(n_block, n_lane, n_active=2, emit="ld",
                         device=None):
    """The launch of kernel K10a (:func:`magi_filter_batch`) for
    ``n_active`` and ``emit`` over ``n_block x n_lane`` columns with aligned
    operands on the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it,
    with the stages of the emit's shared-memory ring, the steps a stage
    holds and the columns a CTA holds."""
    if emit not in _EMITS:
        raise ValueError(f"emit must be 'ld' or 'adjoint', got {emit!r}")
    return _launch_geometry("magi_batch", device, n_active, _EMITS[emit],
                            n_block, n_lane,
                            extra=("stages", "steps_per_stage",
                                   "columns_per_cta"))


def magi_filter_batch(x, R, m0, q_const, emit="ld"):
    r"""
    Lane-batched MAGI filter (kernel K10a): from the seed state ``(m0, 0)``,
    for each step predict through the constant transition, add the
    forecast log-density of the active block's exact data ``x``, and
    condition on it.  All tensors float32, in Taylor-scaled coordinates.

    Args:
        x (Tensor(N, act, n_block, B)): The active derivatives of steps
            1..N (``act = n_active <= 3``).
        R (Tensor(n_tri, n_block, 1 or B)): The packed scaled process noise,
            shared by the lanes or one per lane.
        m0 (Tensor(q, n_block, B)): The seed state (step 0).
        q_const (list): The scaled transition as Python floats
            (:func:`~rodeo_tpu_torch.ops.fused_kalman._static_scaled_qconst`).
        emit (str): ``"ld"`` for the log-density only; ``"adjoint"`` also
            for the streams of :func:`magi_adjoint_batch`.

    Returns:
        With ``emit="ld"``, **ld** ``(B,)``: the blocks' sums added in block
        order.  With ``emit="adjoint"``, ``(ld, z, s_inv, G)``: also the
        innovations ``z (N, act, n_block, B)``, the packed inverse forecast
        variances ``s_inv (N, n_tri_act, n_block, B)`` and the gains ``G
        (N, (q-act)*act, n_block, B)``, left out when ``q == act``.
    """
    if emit not in _EMITS:
        raise ValueError(f"emit must be 'ld' or 'adjoint', got {emit!r}")
    n_steps, act, n_block, n_lane = x.shape
    q = m0.shape[0]
    if act > min(3, q):
        raise NotImplementedError(
            "magi_fused_batch supports n_active <= 3 (and <= n_deriv)")
    n_tri = q * (q + 1) // 2
    n_tri_a = act * (act + 1) // 2
    device = x.device
    r_lanes = R.shape[-1]
    if r_lanes not in (1, n_lane):
        raise ValueError(f"R has {r_lanes} lanes, expected 1 or {n_lane}")
    for name, t, shape in (
            ("x", x, (n_steps, act, n_block, n_lane)),
            ("R", R, (n_tri, n_block, r_lanes)),
            ("m0", m0, (q, n_block, n_lane))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        out = _magi_batch_plain(x, R, m0, q_const, emit)
        ld_blocks, streams = (out, ()) if emit == "ld" else (out[0], out[1:])
    else:
        ld_blocks = x.new_empty((n_block, n_lane))
        streams = ()
        if emit == "adjoint":
            G = x.new_empty((n_steps, (q - act) * act, n_block, n_lane)) \
                if q > act else None
            streams = (torch.empty_like(x),
                       x.new_empty((n_steps, n_tri_a, n_block, n_lane)), G)
        qc = _host_qconst(q_const)
        _launch(LAUNCHES, "magi_batch", q, device, act, _EMITS[emit],
                n_steps, n_block, n_lane, int(r_lanes > 1),
                ctypes.addressof(qc), x, R, m0, ld_blocks,
                *(streams or (None, None, None)))
    # one thread per (block, lane) sums its block; the blocks are added here,
    # in block order
    ld = _block_sum(ld_blocks)
    if emit == "ld":
        return ld
    return (ld,) + tuple(t for t in streams if t is not None)


# --- K10b: the exact reverse adjoint ------------------------------------------------


def _magi_adjoint_batch_plain(z, s_inv, G, q_const):
    """Plain PyTorch twin of ``csrc/magi_adjoint_batch.cu``: the same
    float32 operations in the same order, one Python iteration per step,
    last step first.  Arguments and returns as :func:`magi_adjoint_batch`."""
    n_steps, act = z.shape[:2]
    q = len(q_const)
    _, where_a = _tri_idx(act)
    q_t = [[q_const[i][j] for i in range(q)] for j in range(q)]
    zero = torch.zeros_like(z[0, 0])
    lam = [zero] * q
    gx = torch.empty_like(z)
    for r in range(n_steps - 1, -1, -1):
        v = []
        for a in range(act):
            acc = None
            for b in range(act):
                acc = _acc(acc, s_inv[r, where_a[(a, b)]] * z[r, b])
            v.append(acc)
        t = [zero] * act
        if G is not None:
            for a in range(act):
                acc = None
                for i in range(act, q):
                    acc = _acc(acc, G[r, (i - act) * act + a] * lam[i])
                t[a] = acc
        gx[r] = torch.stack([lam[a] + t[a] - v[a] for a in range(act)])
        u = [v[a] - t[a] for a in range(act)] + lam[act:]
        lam = [zero if c is None else c for c in _matvec(q, q_t, u)]
    return gx, torch.stack(lam)


def _magi_adjoint_batch_geometry(n_block, n_lane, n_active=2, device=None):
    """The launch of kernel K10b (:func:`magi_adjoint_batch`) for
    ``n_active`` over ``n_block x n_lane`` columns with aligned operands on
    the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it
    (its shared memory dynamic), with the stages of its shared-memory ring,
    the steps a stage holds and the columns a CTA holds."""
    return _launch_geometry("magi_adjoint_batch", device, n_active, n_block,
                            n_lane, extra=("stages", "steps_per_stage",
                                           "columns_per_cta"))


def magi_adjoint_batch(z, s_inv, G, q_const):
    r"""
    Exact reverse adjoint of K10a's log-density in the scaled path (kernel
    K10b).  With ``lam`` the gradient in the state, seeded zero after step
    N, each step ``r = N..1``:

    .. code-block:: text

        v = S^{-1} z
        t_a = sum_{i >= act} G[i][a] lam[i]
        dL/dx_r = lam[:act] + t - v
        lam <- Q' [v - t ; lam[act:]]

    and the gradient in the seed state is the final ``lam``.

    Args:
        z, s_inv, G: The streams of :func:`magi_filter_batch` with
            ``emit="adjoint"`` (``G`` is ``None`` when ``q == act``).
        q_const (list): The scaled transition, as for K10a.

    Returns:
        (tuple): **gx** ``(N, act, n_block, B)``, the gradient in the
        active rows of steps 1..N, and **lam0** ``(q, n_block, B)``, that
        in the seed row.
    """
    n_steps, act, n_block, n_lane = z.shape
    q = len(q_const)
    n_tri_a = act * (act + 1) // 2
    device = z.device
    checks = [("z", z, (n_steps, act, n_block, n_lane)),
              ("s_inv", s_inv, (n_steps, n_tri_a, n_block, n_lane))]
    if q > act:
        if G is None:
            raise ValueError("G is needed when q > n_active")
        checks.append(("G", G, (n_steps, (q - act) * act, n_block, n_lane)))
    elif G is not None:
        raise ValueError("G must be None when q == n_active")
    for name, t, shape in checks:
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _magi_adjoint_batch_plain(z, s_inv, G, q_const)
    gx = torch.empty_like(z)
    lam0 = z.new_empty((q, n_block, n_lane))
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, "magi_adjoint_batch", q, device, act, n_steps,
            n_block, n_lane, ctypes.addressof(qc), z, s_inv, G, gx, lam0)
    return gx, lam0


# --- the log-density over expanded paths ---------------------------------------------


def _magi_jacobian(dt, n_steps, n_block, q, act):
    """The change-of-variables constant back from scaled coordinates, in
    float64 Python arithmetic, rounded once to float32 (as the JAX package
    does for a concrete ``dt``)."""
    qd = q - 1
    dt = float(dt)
    tv = [math.sqrt(dt) * dt ** (qd - i) / math.factorial(qd - i)
          for i in range(q)]
    return torch.tensor(n_steps * n_block * sum(math.log(t) for t in tv[:act]),
                        dtype=torch.float32).item()


def _magi_operands(paths, act, prior_pars, dt, sig2_lanes):
    """K10a's operands for expanded paths ``(B, N+1, n_block, q)``, in
    float32 Taylor-scaled coordinates on the paths' device: ``(q_const,
    t_vec, R, x, m0)``."""
    n_lane, _, n_block, q = paths.shape
    if act > min(3, q):
        raise NotImplementedError(
            "magi_fused_batch supports n_active <= 3 (and <= n_deriv)")
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "magi_fused_batch requires the same transition for every block "
            "(a block-constant prior, e.g. ibm_init)")
    device = paths.device
    t_vec = taylor_scale(dt, q, dtype=torch.float32, device=device)
    _, Rs = scale_prior(tuple(torch.as_tensor(p).to(device, torch.float32)
                              for p in prior_pars), t_vec)
    pairs, _ = _tri_idx(q)
    R = _pack_tri(Rs, pairs).T[..., None]                 # (n_tri, nb, 1)
    if sig2_lanes is not None:
        R = R * torch.as_tensor(sig2_lanes).to(device, torch.float32)
    # tensor by tensor: on the card a division by a Python scalar goes
    # through its reciprocal
    paths_s = (paths.detach() / t_vec.to(paths.dtype)).to(torch.float32)
    x = paths_s[:, 1:, :, :act].permute(1, 3, 2, 0).contiguous()
    m0 = paths_s[:, 0].permute(2, 1, 0).contiguous()
    return q_const, t_vec, R.contiguous(), x, m0


class MagiLogdens(torch.autograd.Function):
    """The MAGI log-density ``(B,)`` of expanded paths ``(B, N+1, n_block,
    q)``: forward K10a (``emit="adjoint"`` when the paths need a gradient,
    else ``"ld"``), backward K10b, each lane's gradient scaled by its
    ``grad_output``.  No gradient flows to ``prior_pars``, ``dt`` or
    ``sig2_lanes``."""

    @staticmethod
    def forward(ctx, paths, n_active, prior_pars, dt, sig2_lanes):
        n_steps = paths.shape[1] - 1
        n_block, q = paths.shape[2:]
        q_const, t_vec, R, x, m0 = _magi_operands(paths, n_active,
                                                  prior_pars, dt, sig2_lanes)
        jacobian = _magi_jacobian(dt, n_steps, n_block, q, n_active)
        if not ctx.needs_input_grad[0]:
            return magi_filter_batch(x, R, m0, q_const, emit="ld") - jacobian
        ld, *streams = magi_filter_batch(x, R, m0, q_const, emit="adjoint")
        ctx.save_for_backward(t_vec, *streams)
        ctx.q_const = q_const
        ctx.paths_like = (paths.shape, paths.dtype)
        return ld - jacobian

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_output):
        t_vec, z, s_inv, *G = ctx.saved_tensors
        (n_lane, n_tot, n_block, q), dtype = ctx.paths_like
        act = z.shape[1]
        gx, lam0 = magi_adjoint_batch(z, s_inv, G[0] if G else None,
                                      ctx.q_const)
        # d ld / d paths in original coordinates: paths_s = paths / t_vec
        g_s = gx.new_zeros((n_lane, n_tot, n_block, q))
        g_s[:, 1:, :, :act] = gx.permute(3, 0, 2, 1)
        g_s[:, 0] = lam0.permute(2, 1, 0)
        g_paths = (g_s / t_vec).to(dtype) * \
            grad_output.to(dtype)[:, None, None, None]
        return g_paths, None, None, None, None


def _lane_inputs(ode_data_subsets, prior_pars, sig2_lanes, device):
    device = resolve_device(device)
    move = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (move(ode_data_subsets), tuple(move(p) for p in prior_pars),
            None if sig2_lanes is None else move(sig2_lanes), device)


def magi_fused_batch(ode_data_subsets, ode_expand, n_active, prior_pars, dt,
                     sig2_lanes=None, device=None, **params):
    r"""
    Lane-batched MAGI log-density: ``B`` independent paths through kernel
    K10a on the CUDA card (its plain twin with ``device="cpu"``).  The same
    value per lane as :func:`rodeo_tpu_torch.ops.precond.magi_logdens` up to
    float32 rounding; differentiable in the subsets (through
    :class:`MagiLogdens`, whose backward is kernel K10b).

    Args:
        ode_data_subsets (Tensor(B, n_steps+1, n_block, n_sub)): Per-lane
            path subsets.
        ode_expand (Callable): ``ode_expand(subset, **params)`` mapping one
            subset to the full ``(n_steps+1, n_block, q)`` state, run under
            ``torch.vmap`` over the lanes (``params`` shared).
        n_active (int): Number of exactly-observed derivatives (``<= 3``).
        prior_pars (tuple): Unscaled ``(prior_weight, prior_var)`` with the
            same transition for every block (``ibm_init``).
        dt (float): Solver step size (builds the Taylor scaling).
        sig2_lanes (Tensor(B,) | None): Optional per-lane multiplier on the
            process-noise variance.
        device: Where to run; ``None`` is the CUDA card, and raises without
            one.  The tensor arguments are moved there.

    Returns:
        (Tensor(B,)): float32 log-density values.
    """
    U, prior_pars, sig2, _ = _lane_inputs(ode_data_subsets, prior_pars,
                                          sig2_lanes, device)
    paths = torch.vmap(lambda u: ode_expand(u, **params))(U)
    return MagiLogdens.apply(paths, int(n_active), prior_pars, float(dt),
                             sig2)


def magi_fused_batch_grad(ode_data_subsets, ode_expand, n_active, prior_pars,
                          dt, theta_lanes=None, sig2_lanes=None, device=None,
                          **params):
    r"""
    Lane-batched MAGI log-density **and its exact gradient in the path**
    (and in per-lane parameters), reverse mode: K10a with the adjoint
    streams, then K10b, on the CUDA card (their twins with
    ``device="cpu"``); the chain rule through ``ode_expand`` is
    ``torch.autograd``'s.

    Args:
        theta_lanes (Tensor(B, ...) | pytree | None): Optional per-lane
            parameters: a tensor, or a pytree (dicts, lists, tuples) of
            tensors, each with leading dimension ``B``.  When given,
            ``ode_expand`` is called as ``ode_expand(subset,
            theta=theta_lane, **params)``, ``theta_lane`` of the same
            structure, and the gradient in ``theta_lanes`` is returned as
            well, in that structure.
        sig2_lanes: As in :func:`magi_fused_batch`; it scales the value and
            the gradients, but no gradient in ``sig2_lanes`` is returned.
        (other arguments as :func:`magi_fused_batch`)

    Returns:
        (tuple): ``(ld (B,), grad_subsets)``, plus ``grad_theta`` (the
        structure of ``theta_lanes``) when ``theta_lanes`` is given; ``ld``
        equals :func:`magi_fused_batch`'s bitwise.
    """
    U, prior_pars, sig2, device = _lane_inputs(ode_data_subsets, prior_pars,
                                               sig2_lanes, device)
    inputs = [U.detach().requires_grad_(True)]
    if theta_lanes is not None:
        leaves, spec = tree_flatten(theta_lanes)
        inputs += [torch.as_tensor(leaf, device=device).detach()
                   .requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        if theta_lanes is None:
            paths = torch.vmap(lambda u: ode_expand(u, **params))(*inputs)
        else:
            paths = torch.vmap(lambda u, th: ode_expand(u, theta=th,
                                                        **params))(
                inputs[0], tree_unflatten(spec, inputs[1:]))
        ld = MagiLogdens.apply(paths, int(n_active), prior_pars, float(dt),
                               sig2)
        grads = torch.autograd.grad(ld, inputs,
                                    grad_outputs=torch.ones_like(ld),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, inputs)]
    if theta_lanes is None:
        return ld.detach(), grads[0]
    return ld.detach(), grads[0], tree_unflatten(spec, grads[1:])
