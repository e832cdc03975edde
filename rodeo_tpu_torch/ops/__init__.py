r"""
The GPU compute path: Taylor preconditioning (:mod:`.precond`), the TF32
guard (:mod:`.linalg`), the observation grid (:mod:`.obs_grid`) and the
lane-batched fused paths with their CUDA kernels (sources in ``csrc/``,
built by :mod:`._build`):

- :mod:`.fused_kalman`: the solve and the basic likelihood (K1, K2);
- :mod:`.fused_fenrir`: the fenrir likelihood (K1, K7b);
- :mod:`.fused_dalton`: the DALTON likelihood (K8);
- :mod:`.fused_sim`: posterior path sampling (K1, K6).
"""
from rodeo_tpu_torch.ops.fused_dalton import dalton_fused_batch
from rodeo_tpu_torch.ops.fused_fenrir import fenrir_fused_batch
from rodeo_tpu_torch.ops.fused_kalman import (basic_fused_batch,
                                              solve_mv_fused_batch)
from rodeo_tpu_torch.ops.fused_sim import solve_sim_fused_batch

__all__ = ["basic_fused_batch", "dalton_fused_batch", "fenrir_fused_batch",
           "solve_mv_fused_batch", "solve_sim_fused_batch"]
