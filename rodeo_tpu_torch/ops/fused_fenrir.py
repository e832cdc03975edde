r"""
Fenrir likelihood on the GPU (port of :mod:`rodeo_tpu.ops.pallas_fenrir`:
the lane-batched ``fenrir_fused_batch`` and ``fenrir_fused_batch_grad``, and
the single evaluation ``fenrir_fused``).

Fenrir's log-likelihood is a Kalman filter run backwards in time over the
affine Markov chain that the forward filter leaves behind, with a masked
scalar observation update at every grid step.  The chain's parameters
``(A_n, b_n, C_n)`` are the smoothing gains ``(G, g, L)`` that kernel K1
(``csrc/filter_batch.cu``) already emits, entry 0 included: it conditions
step 0 on step 1 with zero gain and zero noise (the initial state is
exact), and fenrir's chain ends there with the observation at t_min.

- K1 runs the forward filter;
- the masked observation update at the last step N is done here in torch,
  with the column algebra of the kernel;
- **K7b** ``csrc/fenrir_backward_batch.cu`` replaces
  ``_fenrir_backward_kernel_batch``: the reverse recursion over steps
  N-1..0, predict through ``(A, b, C)``, masked update, log-density sum; it
  skips the update at steps without data, an exact identity there.

The gradient runs the same stages forward-mode: K11a
(:func:`~rodeo_tpu_torch.ops.fused_kalman.fused_filter_batch_tan`) emits
the chain with its tangents along each parameter, the terminal update runs
on :class:`~rodeo_tpu_torch.ops.dual.Dual` numbers in torch, and **K11b**
``csrc/fenrir_backward_batch_tan.cuh`` (replacing
``_fenrir_backward_kernel_batch_tan``) is K7b carrying the tangents, with
the same skip.

One evaluation (:func:`fenrir_fused`) follows the JAX package's
single-solve path: the filter K3
(:func:`~rodeo_tpu_torch.ops.fused_kalman.fused_filter`), the chain and the
terminal update in dense batched torch, and **K7a**
``csrc/fenrir_backward_single.cu`` (replacing
``_backward_kernel_global_mask``), K7b's step on one solve, with the same
skip.

The plain PyTorch twin of K7b is :func:`_fenrir_backward_plain` with
``skip_unobserved``; run on Duals it is K11b's
(:func:`_fenrir_backward_tan_plain`), and on the single-solve layout K7a's
(:func:`_fenrir_backward_single_plain`); the wrappers take them only for
CPU tensors.  ``LAUNCHES`` counts the launches.
"""
import numpy as np
import torch

from rodeo_tpu_torch.ops.dual import rows, split
from rodeo_tpu_torch.ops.dual import stack as dual_stack
from rodeo_tpu_torch.ops.fused_kalman import (
    _LOG2PI, _block_sum, _check, _check_n_tan, _fused_inputs,
    _interrogation_normals,
    _kernel_operands, _launch, _launch_geometry, _masked_obs_update_cols,
    _pack_tri, _single_operands, _sym_quadform, _tri_idx, fused_filter,
    fused_filter_batch, fused_filter_batch_tan,
    normalize_meas_var, resolve_kalman_type, unpack_cov)
from rodeo_tpu_torch.ops.linalg import full_matmul_precision, inv_small
from rodeo_tpu_torch.ops.obs_grid import dense_obs_grid, obs_indices

__all__ = ["fenrir_fused_batch", "fenrir_fused_batch_grad", "fenrir_fused",
           "fenrir_backward_batch", "fenrir_backward_batch_tan",
           "fenrir_backward_single", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"fenrir_backward_batch": 0, "fenrir_backward_batch_tan": 0,
            "fenrir_backward_single": 0}


# --- K7b: reverse filter over the backward chain ------------------------------------


def _fenrir_backward_plain(A, b, C, d, y, om, mask, m_seed, p_seed,
                           skip_unobserved=False):
    """Plain PyTorch twin of ``csrc/fenrir_backward_batch.cu``: the same
    float32 operations in the same order, one Python iteration per step.
    Returns each block's log-density sum ``(n_block, B)``; on a chain and
    seeds of Duals, a Dual.

    With ``skip_unobserved`` it skips the observation update and its term at
    a step without data, where they are an exact identity, as K7b, K11b and
    K7a do (a test holds the two to each other bitwise)."""
    n_steps, q, n_block, n_lane = b.shape
    pairs, where = _tri_idx(q)
    m_cols, p_cols = list(m_seed), list(p_seed)
    ld = torch.zeros_like(m_seed[0])
    masks = mask.tolist()
    for r in range(n_steps - 1, -1, -1):
        Ar = [[A[r, i * q + j] for j in range(q)] for i in range(q)]
        mp = []
        for i in range(q):
            acc = b[r, i]
            for j in range(q):
                acc = acc + Ar[i][j] * m_cols[j]
            mp.append(acc)
        app = _sym_quadform(q, Ar, p_cols, where)
        pp = [C[r, k] + app[k] for k in range(len(pairs))]
        if skip_unobserved and masks[r] == 0.0:
            m_cols, p_cols = mp, pp
            continue
        D = [d[r, j][:, None] for j in range(q)]
        m_cols, p_cols, term = _masked_obs_update_cols(
            q, pairs, where, mp, pp, D, y[r][:, None], om[r][:, None],
            mask[r])
        ld = ld + mask[r] * (-0.5 * term)
    return ld


def _fenrir_backward_tan_plain(A, b, C, d, y, om, mask, m_seed, p_seed,
                               n_tan, skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/fenrir_backward_batch_tan.cuh``: K7b's
    twin on the augmented chain and seeds read as Duals, skipping the
    observation update at steps without data as K11b does (unless
    ``skip_unobserved=False``).  Returns each block's log-density sum and
    its tangents ``(n_aug, n_block, B)``."""
    n_aug = 1 + n_tan
    q = b.shape[1] // n_aug
    n_tri = C.shape[1] // n_aug
    ld = _fenrir_backward_plain(
        split(A, q * q, axis=1), split(b, q, axis=1), split(C, n_tri, axis=1),
        d, y, om, mask, split(m_seed, q), split(p_seed, n_tri),
        skip_unobserved)
    return rows(ld)


def _fenrir_backward_batch_geometry(n_block, n_lane, q=3, device=None):
    """The launch of kernel K7b (:func:`fenrir_backward_batch`) at ``q`` over
    ``n_block x n_lane`` columns with aligned operands on the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it,
    with the stages of its shared-memory ring and the steps a stage
    holds."""
    return _launch_geometry("fenrir_backward_batch", device, n_block, n_lane,
                            extra=("stages", "steps_per_stage"), q=q)


def _fenrir_backward_batch_tan_geometry(n_block, n_lane, n_tan, q=3,
                                        device=None):
    """The launch of kernel K11b (:func:`fenrir_backward_batch_tan`) at
    ``q`` over ``n_block x n_lane`` columns and ``n_tan`` directions with
    aligned operands on the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it
    (its shared memory dynamic), with the stages of its shared-memory ring
    and the steps a stage holds."""
    _check_n_tan("fenrir_backward_batch_tan", n_tan)
    return _launch_geometry("fenrir_backward_batch_tan", device, n_block,
                            n_lane, n_tan,
                            extra=("stages", "steps_per_stage"), q=q)


def fenrir_backward_batch(A, b, C, d, y, om, mask, m_seed, p_seed, ld0):
    r"""
    Lane-batched backward filter of fenrir (kernel K7b): from the seed at
    step N, for n = N-1 down to 0, predict ``m = A_n m + b_n``,
    ``P = A_n P A_n' + C_n``, then the masked scalar observation update
    with ``(d_n, y_n, om_n, mask_n)``, summing the observations'
    log-densities.

    Args:
        A (Tensor(N, q*q, n_block, B)), b (Tensor(N, q, n_block, B)),
            C (Tensor(N, n_tri, n_block, B)): The backward chain (K1's
            gains ``G, g, L``).
        d (Tensor(N, q, n_block)), y (Tensor(N, n_block)),
            om (Tensor(N, n_block)), mask (Tensor(N,)): The observation
            grid of steps 0..N-1, shared by all lanes.
        m_seed (Tensor(q, n_block, B)), p_seed (Tensor(n_tri, n_block,
            B)): The state at step N after its observation update.
        ld0 (Tensor(B,)): The log-density of step N's observation.

    Returns:
        (Tensor(B,)): ``ld0`` plus the log-density of steps 0..N-1.
    """
    return _fenrir_backward(0, A, b, C, d, y, om, mask, m_seed, p_seed, ld0)


def fenrir_backward_batch_tan(A, b, C, d, y, om, mask, m_seed, p_seed, ld0):
    r"""
    Tangent-augmented backward filter of fenrir (kernel K11b): K7b on the
    chain that :func:`~rodeo_tpu_torch.ops.fused_kalman.fused_filter_batch_tan`
    emits, carrying the tangents of the state and the log-density along
    each of its ``n_tan`` directions.

    Args:
        A (Tensor(N, n_aug*q*q, n_block, B)), b (Tensor(N, n_aug*q, ...)),
            C (Tensor(N, n_aug*n_tri, ...)): The chain and its tangents
            (``n_aug = 1 + n_tan``, the layout of ``fused_filter_batch_tan``).
        d, y, om, mask: As :func:`fenrir_backward_batch` (constants).
        m_seed (Tensor(n_aug*q, n_block, B)), p_seed (Tensor(n_aug*n_tri,
            n_block, B)): The state at step N and its tangents.
        ld0 (Tensor(n_aug, B)): The log-density of step N's observation
            and its tangents.

    The kernel holds q = 3, 4 and 5 at 1 to 7 directions.

    Returns:
        (Tensor(n_aug, B)): ``ld0`` plus the log-density of steps 0..N-1,
        and its tangents.
    """
    return _fenrir_backward(ld0.shape[0] - 1, A, b, C, d, y, om, mask,
                            m_seed, p_seed, ld0)


def _fenrir_backward(n_tan, A, b, C, d, y, om, mask, m_seed, p_seed, ld0):
    """K7b (``n_tan`` 0) or K11b: check the operands, take the twin for
    CPU tensors, else launch the kernel; add the blocks' sums to ld0."""
    n_aug = 1 + n_tan
    n_steps, d_aug, n_block, n_lane = b.shape
    q = d_aug // n_aug
    n_tri = q * (q + 1) // 2
    device = b.device
    for name, t, shape in (
            ("A", A, (n_steps, n_aug * q * q, n_block, n_lane)),
            ("b", b, (n_steps, n_aug * q, n_block, n_lane)),
            ("C", C, (n_steps, n_aug * n_tri, n_block, n_lane)),
            ("d", d, (n_steps, q, n_block)),
            ("y", y, (n_steps, n_block)),
            ("om", om, (n_steps, n_block)),
            ("mask", mask, (n_steps,)),
            ("m_seed", m_seed, (n_aug * q, n_block, n_lane)),
            ("p_seed", p_seed, (n_aug * n_tri, n_block, n_lane)),
            ("ld0", ld0, (n_aug, n_lane) if n_tan else (n_lane,))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        if n_tan:
            ld_blocks = _fenrir_backward_tan_plain(A, b, C, d, y, om, mask,
                                                   m_seed, p_seed, n_tan)
        else:
            ld_blocks = _fenrir_backward_plain(A, b, C, d, y, om, mask,
                                               m_seed, p_seed,
                                               skip_unobserved=True)
    else:
        if n_tan:
            _check_n_tan("fenrir_backward_batch_tan", n_tan)
        ld_blocks = m_seed.new_empty(
            (n_aug, n_block, n_lane) if n_tan else (n_block, n_lane))
        sizes = (n_steps, n_block, n_lane) + ((n_tan,) if n_tan else ())
        _launch(LAUNCHES, "fenrir_backward_batch_tan" if n_tan
                else "fenrir_backward_batch", q, device, *sizes, A, b, C, d,
                y, om, mask, m_seed, p_seed, ld_blocks)
    # one thread per (block, lane) column sums its block; the blocks are
    # added here, in block order
    return ld0 + _block_sum(ld_blocks.movedim(-2, 0))


# --- K7a: the single-solve reverse filter ------------------------------------------


def _fenrir_backward_single_plain(A, b, C, d, y, om, mask, m_seed, p_seed,
                                  skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/fenrir_backward_single.cu``: K7b's twin
    with each block a column, on transposed views, skipping the observation
    update at steps without data as K7a does (unless
    ``skip_unobserved=False``).  Returns each block's log-density sum
    ``(n_block,)``."""
    def lanes(a):
        return a.permute(0, 2, 1)[..., None]

    return _fenrir_backward_plain(lanes(A), lanes(b), lanes(C), d, y, om,
                                  mask, m_seed.T[..., None],
                                  p_seed.T[..., None],
                                  skip_unobserved)[:, 0]


def _fenrir_backward_single_geometry(n_block, q=3, device=None):
    """The launch of kernel K7a (:func:`fenrir_backward_single`) at ``q``
    over ``n_block`` blocks with aligned operands on the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it
    (its shared memory dynamic), with the stages of its shared-memory ring,
    the steps a stage holds and the blocks a CTA holds (a consumer thread
    each)."""
    return _launch_geometry("fenrir_backward_single", device, n_block,
                            extra=("stages", "rows_per_stage",
                                   "blocks_per_cta"), q=q)


def fenrir_backward_single(A, b, C, d, y, om, mask, m_seed, p_seed, ld0):
    r"""
    Single-solve backward filter of fenrir (kernel K7a): as
    :func:`fenrir_backward_batch` on one solve, the chain in the JAX
    package's layout.

    Args:
        A (Tensor(N, n_block, q*q)), b (Tensor(N, n_block, q)),
            C (Tensor(N, n_block, n_tri)): The backward chain of steps
            0..N-1.
        d (Tensor(N, q, n_block)), y (Tensor(N, n_block)),
            om (Tensor(N, n_block)), mask (Tensor(N,)): The observation
            grid of steps 0..N-1.
        m_seed (Tensor(n_block, q)), p_seed (Tensor(n_block, n_tri)): The
            state at step N after its observation update.
        ld0 (Tensor()): The log-density of step N's observation.

    Returns:
        (Tensor()): ``ld0`` plus the log-density of steps 0..N-1, each
        block summed over the steps, then the blocks added in block order.
    """
    n_steps, n_block, q = b.shape
    n_tri = q * (q + 1) // 2
    device = b.device
    for name, t, shape in (
            ("A", A, (n_steps, n_block, q * q)),
            ("b", b, (n_steps, n_block, q)),
            ("C", C, (n_steps, n_block, n_tri)),
            ("d", d, (n_steps, q, n_block)),
            ("y", y, (n_steps, n_block)),
            ("om", om, (n_steps, n_block)),
            ("mask", mask, (n_steps,)),
            ("m_seed", m_seed, (n_block, q)),
            ("p_seed", p_seed, (n_block, n_tri)),
            ("ld0", ld0, ())):
        _check(name, t, shape, device)
    if device.type == "cpu":
        ld_blocks = _fenrir_backward_single_plain(A, b, C, d, y, om, mask,
                                                  m_seed, p_seed)
    else:
        ld_blocks = m_seed.new_empty((n_block,))
        _launch(LAUNCHES, "fenrir_backward_single", q, device, n_steps,
                n_block, A, b, C, d, y, om, mask, m_seed, p_seed, ld_blocks)
    return ld0 + _block_sum(ld_blocks)


# --- the likelihood -----------------------------------------------------------------


def _fenrir_operands(fused, n_steps, t_min, t_max, ops, obs_data, obs_times,
                     obs_weight, obs_var, mode, tangent=False, eps=None):
    """The operands of K7b for one evaluation: the forward filter (K1, with
    chkrebtii's normals ``eps``) on ``ops``
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._kernel_operands`), the
    observation grid of steps 0..N-1, and the masked observation update at
    step N that seeds the chain.  Returns the arguments of
    :func:`fenrir_backward_batch` in order; with ``tangent``, those of
    :func:`fenrir_backward_batch_tan`, through K11a and the update on
    Duals."""
    q = ops["x0_lanes"].shape[0]
    pairs, where = _tri_idx(q)
    # all N gains: entry 0 is the zero-gain, zero-noise step onto x0
    if tangent:
        A, b, C, m_last, p_last = fused_filter_batch_tan(fused, n_steps,
                                                         **ops, mode=mode)
        m_last, p_last = split(m_last, q), split(p_last, len(pairs))
    else:
        A, b, C, m_last, p_last = fused_filter_batch(fused, n_steps, **ops,
                                                     mode=mode, eps=eps)
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times)
    d, y, om, mask = dense_obs_grid(
        obs_ind, n_steps, ops["t_vec"], torch.as_tensor(obs_data),
        torch.as_tensor(obs_weight), torch.as_tensor(obs_var))
    D = [d[n_steps, j][:, None] for j in range(q)]
    m_seed, p_seed, term = _masked_obs_update_cols(
        q, pairs, where, list(m_last), list(p_last), D,
        y[n_steps][:, None], om[n_steps][:, None], mask[n_steps])
    ld0 = mask[n_steps] * (-0.5 * _block_sum(term))
    # fenrir's mask covers steps 0..N-1; step N was the update above
    return (A, b, C, d[:n_steps].contiguous(), y[:n_steps].contiguous(),
            om[:n_steps].contiguous(), mask[:n_steps].contiguous(),
            dual_stack(m_seed), dual_stack(p_seed), rows(ld0).contiguous())


def fenrir_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                       prior_pars, obs_data, obs_times, obs_weight, obs_var,
                       model, interrogation="kramer", kalman_type="standard",
                       device=None, generator=None, eps=None):
    r"""
    Lane-batched fenrir log-likelihood: ``B`` evaluations (parameter
    candidates against the same observations) through kernels K1 and K7b
    on the CUDA card (their plain twins with ``device="cpu"``).

    Args:
        obs_data (Tensor(n_obs, n_block, 1)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_weight (Tensor(n_obs, n_block, 1, q)): Observation weights.
        obs_var (Tensor(n_obs, n_block, 1, 1)): Observation variances
            (their factors where ``kalman_type`` is ``"sqrt"``, squared at
            entry with the prior's; the value does not depend on the form).
        (other args as
        :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`: its
        models and q, its four interrogations, ``generator`` and ``eps (N,
        q, n_block, B)`` those of chkrebtii's draws in the key's place)

    Returns:
        (Tensor(B,)): Log-likelihood of each lane, float32.
    """
    fused, device, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_batch", "fenrir_backward_batch"))
    obs_var = normalize_meas_var(resolve_kalman_type(kalman_type), obs_var)
    if obs_weight.shape[2] != 1:
        raise NotImplementedError("fenrir_fused_batch requires n_bobs == 1")
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    eps = _interrogation_normals(interrogation,
                                 (n_steps,) + ops["x0_lanes"].shape,
                                 generator, eps, device)
    return fenrir_backward_batch(*_fenrir_operands(
        fused, n_steps, t_min, t_max, ops, obs_data, obs_times, obs_weight,
        obs_var, interrogation, eps=eps))


def fenrir_fused_batch_grad(thetas, ode_weight, ode_inits, t_min, t_max,
                            n_steps, prior_pars, obs_data, obs_times,
                            obs_weight, obs_var, model,
                            interrogation="kramer", kalman_type="standard",
                            device=None):
    r"""
    Lane-batched fenrir log-likelihood and its gradient in theta, forward
    mode: kernels K11a and K11b on the CUDA card (their plain twins with
    ``device="cpu"``), the terminal update on Duals in between.
    ``ode_inits`` must not depend on theta: its tangents are zero.

    Args as :func:`fenrir_fused_batch`.

    Returns:
        (tuple): **loglik** ``(B,)``, equal to :func:`fenrir_fused_batch`'s
        bitwise, and **grad** ``(B, n_theta)``.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_batch_tan",
                              "fenrir_backward_batch_tan"))
    obs_var = normalize_meas_var(resolve_kalman_type(kalman_type), obs_var)
    if obs_weight.shape[2] != 1:
        raise NotImplementedError(
            "fenrir_fused_batch_grad requires n_bobs == 1")
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    ld = fenrir_backward_batch_tan(*_fenrir_operands(
        fused, n_steps, t_min, t_max, ops, obs_data, obs_times, obs_weight,
        obs_var, interrogation, tangent=True))
    return ld[0], ld[1:].T.contiguous()


# --- one evaluation ---------------------------------------------------------------


def _const_coefs(prior_weight):
    """The entries of a transition that is the same for every block, as
    Python floats holding its float32 values; None otherwise."""
    qw = prior_weight.detach().cpu().numpy()
    if not np.all(qw == qw[0]):
        return None
    q = qw.shape[-1]
    return [[float(qw[0, i, j]) for j in range(q)] for i in range(q)]


@full_matmul_precision
def _fenrir_single_operands(fused, n_steps, t_min, t_max, ops, Qs, obs_data,
                            obs_times, obs_weight, obs_var, mode, eps=None):
    """The operands of K7a for one evaluation, as ``pallas_fenrir.
    fenrir_fused`` builds them: the forward filter (K3) on ``ops``
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._single_operands`); the chain
    of steps 0..N-1 in dense torch, ``A = Pf Q' Pp^{-1}``, ``b = mf - A mp``
    and the Joseph-form ``C``, symmetrised, step 0 from the exact initial
    state; the observation grid; and the masked update at step N.  TF32
    stays off.  Returns the arguments of :func:`fenrir_backward_single` in
    order."""
    mf, pf, mp, pp = fused_filter(fused, n_steps, **ops, mode=mode, eps=eps)
    n_block, q = ops["x0"].shape
    pairs, _ = _tri_idx(q)
    Rs = ops["prior_var"]
    eye = torch.eye(q, dtype=mf.dtype, device=mf.device)
    mf_full = torch.cat([ops["x0"][None], mf[:-1]])        # steps 0..N-1
    Pf = unpack_cov(torch.cat([pf.new_zeros((1,) + pf.shape[1:]), pf[:-1]]))
    Pp = unpack_cov(pp)                                     # steps 1..N
    A = (Pf @ Qs.mT) @ inv_small(Pp)
    b = mf_full - torch.einsum("...ij,...j->...i", A, mp)
    IAQ = eye - A @ Qs
    C = IAQ @ Pf @ IAQ.mT + A @ Rs @ A.mT
    C = 0.5 * (C + C.mT)
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times)
    d, y, om, mask = dense_obs_grid(
        obs_ind, n_steps, ops["t_vec"], torch.as_tensor(obs_data),
        torch.as_tensor(obs_weight), torch.as_tensor(obs_var))
    # the masked update at step N, whose result seeds the chain
    mN, PN = mf[-1], unpack_cov(pf[-1])
    DN, omN, maskN = d[n_steps].T, om[n_steps][:, None], mask[n_steps]
    PD = (PN @ DN[..., None])[..., 0]
    SN = torch.sum(DN * PD, dim=-1, keepdim=True) + omN
    zN = y[n_steps][:, None] - torch.sum(DN * mN, dim=-1, keepdim=True)
    ld0 = maskN * (-0.5) * torch.sum(zN * zN / SN + torch.log(SN) + _LOG2PI)
    KN = PD / SN * maskN
    IKD = eye - KN[..., None] * DN[:, None, :]
    P_seed = IKD @ PN @ IKD.mT + (KN[..., None] * omN[..., None]) \
        * KN[:, None, :]
    return (A.reshape(n_steps, n_block, q * q).contiguous(), b.contiguous(),
            _pack_tri(C, pairs).contiguous(), d[:n_steps].contiguous(),
            y[:n_steps].contiguous(), om[:n_steps].contiguous(),
            mask[:n_steps].contiguous(), (mN + KN * zN).contiguous(),
            _pack_tri(0.5 * (P_seed + P_seed.mT), pairs).contiguous(), ld0)


def fenrir_fused(theta, ode_weight, ode_init, t_min, t_max, n_steps,
                 prior_pars, obs_data, obs_times, obs_weight, obs_var, model,
                 interrogation="kramer", kalman_type="standard", device=None,
                 generator=None, eps=None):
    r"""
    Fenrir log-likelihood of one parameter vector (the latency path),
    through kernels K3 (the filter) and K7a (the backward filter) on the
    CUDA card, their plain twins with ``device="cpu"``.  As the JAX
    package's ``fenrir_fused``, the filter takes its transition from the
    float32 scaled prior.

    Args:
        theta (Tensor(n_theta,)): Parameters.
        ode_init (Tensor(n_block, q)): Initial state (original
            coordinates).
        obs_data, obs_times, obs_weight, obs_var: As
            :func:`fenrir_fused_batch`.
        (other args as
        :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused`: its models
        and q, its four interrogations, ``generator`` and ``eps (N,
        n_block, q)`` those of chkrebtii's draws in the key's place)

    Returns:
        (Tensor()): The log-likelihood, float32.
    """
    fused, device, theta, ode_weight, ode_init, prior_pars = _fused_inputs(
        theta, ode_weight, ode_init, prior_pars, model, interrogation,
        kalman_type, device, ("filter_single", "fenrir_backward_single"))
    obs_var = normalize_meas_var(resolve_kalman_type(kalman_type), obs_var)
    if obs_weight.shape[2] != 1:
        raise NotImplementedError("fenrir_fused requires n_bobs == 1")
    ops, Qs = _single_operands(theta, ode_weight, ode_init, t_min, t_max,
                               n_steps, prior_pars)
    ops["q_const"] = _const_coefs(Qs)
    if ops["q_const"] is None:
        raise NotImplementedError(
            "fenrir_fused requires the same transition for every block "
            "(e.g. ibm_init)")
    eps = _interrogation_normals(interrogation,
                                 (n_steps,) + ops["x0"].shape, generator,
                                 eps, device)
    return fenrir_backward_single(*_fenrir_single_operands(
        fused, n_steps, t_min, t_max, ops, Qs, obs_data, obs_times,
        obs_weight, obs_var, interrogation, eps))
