r"""
Lane-batched fenrir likelihood on the GPU (port of the batch path of
:mod:`rodeo_tpu.ops.pallas_fenrir`: ``fenrir_fused_batch``).

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
  N-1..0, predict through ``(A, b, C)``, masked update, log-density sum.

The plain PyTorch twin of K7b is :func:`_fenrir_backward_plain`; the
wrapper :func:`fenrir_backward_batch` takes it only for CPU tensors.
``LAUNCHES`` counts K7b's launches.
"""
import torch

from rodeo_tpu_torch.ops import _build
from rodeo_tpu_torch.ops.fused_kalman import (
    _KERNEL_Q, _block_sum, _check, _cuda_device, _fused_inputs,
    _kernel_operands, _masked_obs_update_cols, _raise_on_error, _sym_quadform,
    _tri_idx, fused_filter_batch)
from rodeo_tpu_torch.ops.obs_grid import dense_obs_grid, obs_indices

__all__ = ["fenrir_fused_batch", "fenrir_backward_batch", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"fenrir_backward_batch": 0}


# --- K7b: reverse filter over the backward chain ------------------------------------


def _fenrir_backward_plain(A, b, C, d, y, om, mask, m_seed, p_seed):
    """Plain PyTorch twin of ``csrc/fenrir_backward_batch.cu``: the same
    float32 operations in the same order, one Python iteration per step.
    Returns each block's log-density sum ``(n_block, B)``."""
    n_steps, q, n_block, n_lane = b.shape
    pairs, where = _tri_idx(q)
    m_cols, p_cols = list(m_seed), list(p_seed)
    ld = torch.zeros_like(m_seed[0])
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
        D = [d[r, j][:, None] for j in range(q)]
        m_cols, p_cols, term = _masked_obs_update_cols(
            q, pairs, where, mp, pp, D, y[r][:, None], om[r][:, None],
            mask[r])
        ld = ld + mask[r] * (-0.5 * term)
    return ld


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
    n_steps, q, n_block, n_lane = b.shape
    n_tri = q * (q + 1) // 2
    device = b.device
    for name, t, shape in (
            ("A", A, (n_steps, q * q, n_block, n_lane)),
            ("b", b, (n_steps, q, n_block, n_lane)),
            ("C", C, (n_steps, n_tri, n_block, n_lane)),
            ("d", d, (n_steps, q, n_block)),
            ("y", y, (n_steps, n_block)),
            ("om", om, (n_steps, n_block)),
            ("mask", mask, (n_steps,)),
            ("m_seed", m_seed, (q, n_block, n_lane)),
            ("p_seed", p_seed, (n_tri, n_block, n_lane)),
            ("ld0", ld0, (n_lane,))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        ld_blocks = _fenrir_backward_plain(A, b, C, d, y, om, mask, m_seed,
                                           p_seed)
    else:
        _cuda_device(device)
        if q != _KERNEL_Q:
            raise NotImplementedError(
                f"the fenrir kernel is instantiated for q={_KERNEL_Q}, "
                f"got {q}")
        lib = _build.load()
        ld_blocks = torch.empty_like(m_seed[0])
        with torch.cuda.device(device):
            err = lib.rodeo_fenrir_backward_batch(
                n_steps, n_block, n_lane, A.data_ptr(), b.data_ptr(),
                C.data_ptr(), d.data_ptr(), y.data_ptr(), om.data_ptr(),
                mask.data_ptr(), m_seed.data_ptr(), p_seed.data_ptr(),
                ld_blocks.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        _raise_on_error("fenrir_backward_batch", err)
        LAUNCHES["fenrir_backward_batch"] += 1
    # one thread per (block, lane) column sums its block; the blocks are
    # added here, in block order
    return ld0 + _block_sum(ld_blocks)


# --- the likelihood -----------------------------------------------------------------


def _fenrir_operands(fused, n_steps, t_min, t_max, ops, obs_data, obs_times,
                     obs_weight, obs_var, mode):
    """The operands of K7b for one evaluation: the forward filter (K1) on
    ``ops`` (:func:`~rodeo_tpu_torch.ops.fused_kalman._kernel_operands`),
    the observation grid of steps 0..N-1, and the masked observation update
    at step N that seeds the chain.  Returns the arguments of
    :func:`fenrir_backward_batch` in order."""
    q = ops["x0_lanes"].shape[0]
    pairs, where = _tri_idx(q)
    # all N gains: entry 0 is the zero-gain, zero-noise step onto x0
    A, b, C, m_last, p_last = fused_filter_batch(fused, n_steps, **ops,
                                                 mode=mode)
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
            torch.stack(m_seed), torch.stack(p_seed), ld0.contiguous())


def fenrir_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                       prior_pars, obs_data, obs_times, obs_weight, obs_var,
                       model, interrogation="kramer", kalman_type="standard",
                       device=None):
    r"""
    Lane-batched fenrir log-likelihood: ``B`` evaluations (parameter
    candidates against the same observations) through kernels K1 and K7b
    on the CUDA card (their plain twins with ``device="cpu"``).

    Args:
        obs_data (Tensor(n_obs, n_block, 1)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_weight (Tensor(n_obs, n_block, 1, q)): Observation weights.
        obs_var (Tensor(n_obs, n_block, 1, 1)): Observation variances.
        (other args as
        :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`)

    Returns:
        (Tensor(B,)): Log-likelihood of each lane, float32.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device)
    if obs_weight.shape[2] != 1:
        raise NotImplementedError("fenrir_fused_batch requires n_bobs == 1")
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    return fenrir_backward_batch(*_fenrir_operands(
        fused, n_steps, t_min, t_max, ops, obs_data, obs_times, obs_weight,
        obs_var, interrogation))
