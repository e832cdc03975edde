r"""
The GPU compute path: Taylor preconditioning (:mod:`.precond`), the TF32
guard (:mod:`.linalg`), the observation grid (:mod:`.obs_grid`) and the
lane-batched fused paths with their CUDA kernels (sources in ``csrc/``,
built by :mod:`._build`):

- :mod:`.fused_kalman`: the solve and the basic likelihood (K1, K2r, which
  writes the solve's rows in one pass), their gradients (K11a, K11e), and
  the single solve (K3, K4) and its stationary-gain form (K3, the mean
  chain K5a or K5b and K5c, K4);
- :mod:`.fused_fenrir`: the fenrir likelihood (K1, K7b) and its gradient
  (K11a, K11b), and one evaluation of it (K3, K7a);
- :mod:`.fused_dalton`: the DALTON likelihood (K8) and its gradient (K11c);
- :mod:`.fused_daltonng`: non-Gaussian DALTON (K9, K2r, K1) and its gradient
  (K11d, K11e, K11a);
- :mod:`.fused_sim`: posterior path sampling (K1, K6);
- :mod:`.fused_magi`: the MAGI log-density (K10a) and its reverse-mode path
  gradient (K10b);
- :mod:`.dual`: the forward-mode numbers of the tangent kernels' twins, and
  the second-order number of the Laplace derivatives;
- :mod:`.autograd`: the likelihoods as ``torch.autograd.Function``\ s.
"""
from rodeo_tpu_torch.ops.autograd import fused_loglik
from rodeo_tpu_torch.ops.fused_dalton import (dalton_fused_batch,
                                              dalton_fused_batch_grad)
from rodeo_tpu_torch.ops.fused_daltonng import (daltonng_fused_batch,
                                                daltonng_fused_batch_grad)
from rodeo_tpu_torch.ops.fused_fenrir import (fenrir_fused,
                                              fenrir_fused_batch,
                                              fenrir_fused_batch_grad)
from rodeo_tpu_torch.ops.fused_kalman import (basic_fused_batch,
                                              basic_fused_batch_grad,
                                              smoother_recursion_batch_rows,
                                              solve_mv_fused,
                                              solve_mv_fused_batch,
                                              solve_mv_fused_batch_grad,
                                              solve_mv_fused_stationary)
from rodeo_tpu_torch.ops.fused_magi import (magi_fused_batch,
                                            magi_fused_batch_grad)
from rodeo_tpu_torch.ops.fused_sim import solve_sim_fused_batch

__all__ = ["basic_fused_batch", "dalton_fused_batch", "fenrir_fused_batch",
           "solve_mv_fused_batch", "solve_sim_fused_batch",
           "basic_fused_batch_grad", "dalton_fused_batch_grad",
           "fenrir_fused_batch_grad", "solve_mv_fused_batch_grad",
           "fused_loglik", "solve_mv_fused", "solve_mv_fused_stationary",
           "fenrir_fused",
           "smoother_recursion_batch_rows", "magi_fused_batch",
           "magi_fused_batch_grad", "daltonng_fused_batch",
           "daltonng_fused_batch_grad"]
