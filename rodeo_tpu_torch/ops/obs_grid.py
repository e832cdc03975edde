r"""
Observations on the solver grid, shared by the fused likelihoods (port of
the observation set-up that :mod:`rodeo_tpu.ops.pallas_fenrir`,
:mod:`rodeo_tpu.ops.pallas_dalton` and ``basic_fused_batch`` each repeat).

The likelihood kernels never branch on whether a step carries data: the
observations are scattered onto dense per-step arrays, with zero weight,
zero data, unit variance and a zero mask at steps without data, so that the
masked update there is an exact identity and its log-density term is
multiplied by 0.

The grid index of an observation time is its ``searchsorted`` (side left)
position on ``linspace(t_min, t_max, N+1)``.  ``torch.linspace`` rounds
differently from ``jnp.linspace``, and a time that sits on a grid point can
then land one step off, so :func:`obs_indices` builds the grid as
``jnp.linspace`` computes it, in float64 as the JAX package does with
64-bit floats enabled (its tests and its float64 reference runs).
"""
import numpy as np
import torch

__all__ = ["obs_indices", "dense_obs_grid"]


def _solver_grid(t_min, t_max, n_steps):
    """``jnp.linspace(t_min, t_max, n_steps + 1)`` in float64 as XLA
    evaluates it after its simplifier: the division by ``n_steps`` becomes a
    product with ``r = 1 / n_steps``, and ``t_max * (i r)`` becomes
    ``i (t_max r)``; the end point is exact.  For ``t_min = 0``, as in every
    configuration of the repository, this is JAX's grid to the bit on the
    CPU; otherwise XLA's fused code may round an entry differently."""
    i = np.arange(n_steps, dtype=np.float64)
    r = 1.0 / np.float64(n_steps)
    start, stop = np.float64(t_min), np.float64(t_max)
    return np.concatenate([start * (1 - i * r) + i * (stop * r), [stop]])


def obs_indices(t_min, t_max, n_steps, obs_times):
    """Grid index ``(n_obs,)`` (int64, on the CPU) of each observation time:
    ``searchsorted`` (side left) of ``obs_times``, promoted to float64, on
    the solver grid."""
    if isinstance(obs_times, torch.Tensor):
        obs_times = obs_times.detach().to("cpu", torch.float64).numpy()
    times = np.asarray(obs_times, dtype=np.float64)
    idx = np.searchsorted(_solver_grid(t_min, t_max, n_steps), times,
                          side="left")
    return torch.from_numpy(idx.astype(np.int64))


def dense_obs_grid(obs_ind, n_steps, t_vec, obs_data, obs_weight, obs_var):
    """
    The observation model on every grid step, in float32 on ``t_vec``'s
    device.

    Args:
        obs_ind (Tensor(n_obs,)): Grid index of each observation
            (:func:`obs_indices`).
        n_steps (int): Number of steps ``N``.
        t_vec (Tensor(q,)): Taylor scales; the weight acts on original
            coordinates, so its scaled form is ``D * t_vec``.
        obs_data (Tensor(n_obs, n_block, 1)): Observations.
        obs_weight (Tensor(n_obs, n_block, 1, q)): Observation weights.
        obs_var (Tensor(n_obs, n_block, 1, 1)): Observation variances.

    Returns:
        (tuple): ``d (N+1, q, n_block)`` scaled weights, ``y (N+1,
        n_block)`` data, ``om (N+1, n_block)`` variances and ``mask
        (N+1,)``, 1.0 at steps that carry data.
    """
    device = t_vec.device
    f32 = dict(dtype=torch.float32, device=device)
    n_block, q = obs_weight.shape[1], obs_weight.shape[-1]
    idx = obs_ind.to(device)
    D_scaled = (obs_weight[:, :, 0, :].to(device)
                * t_vec.to(obs_weight.dtype)).to(torch.float32)
    d = torch.zeros((n_steps + 1, q, n_block), **f32)
    d[idx] = D_scaled.transpose(1, 2)
    y = torch.zeros((n_steps + 1, n_block), **f32)
    y[idx] = obs_data[:, :, 0].to(**f32)
    om = torch.ones((n_steps + 1, n_block), **f32)
    om[idx] = obs_var[:, :, 0, 0].to(**f32)
    mask = torch.zeros((n_steps + 1,), **f32)
    mask[idx] = 1.0
    return d, y, om, mask
