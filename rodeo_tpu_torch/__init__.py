r"""
rodeo-tpu-torch: the PyTorch / CUDA port of :mod:`rodeo_tpu` for one NVIDIA
Hopper GPU (H100).

The JAX package ``rodeo_tpu`` stays the reference; this package mirrors its
module names so that every function has an obvious counterpart, and holds
itself to the JAX package's numbers in ``tests/test_torch_*.py``.  It imports
``torch`` and never ``jax``.

Ported so far (the ``solve_mv`` slice, the lane-batched inference
path and its gradients, the single-solve fused path, MAGI, non-Gaussian
DALTON, the torch-op surface and the MCMC layer):

- the torch-ops, plain PyTorch on the tensors' device and differentiable
  by ``torch.autograd``: :func:`rodeo_tpu_torch.solve_mv` and
  :func:`rodeo_tpu_torch.solve_sim`, the likelihoods
  :func:`rodeo_tpu_torch.inference.basic`, :func:`~rodeo_tpu_torch.
  inference.fenrir` and :func:`~rodeo_tpu_torch.inference.dalton` with
  their data-conditioned posteriors, :mod:`rodeo_tpu_torch.prior`
  (``indep_init`` included), :mod:`rodeo_tpu_torch.interrogate`,
  :mod:`rodeo_tpu_torch.kalmantv` (standard form),
  :mod:`rodeo_tpu_torch.utils`, and :mod:`rodeo_tpu_torch.ops.linalg`'s
  fast-linalg switch and closed forms;
- :mod:`rodeo_tpu_torch.ops.precond` (Taylor preconditioning), every
  wrapper but ``solve_mv_iterated``;
- :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`, the
  lane-batched solve carried by two hand-written CUDA kernels
  (``ops/csrc/filter_batch.cu``, ``ops/csrc/smoother_batch_rows.cu``);
- the lane-batched likelihoods :func:`fenrir_fused_batch` (kernels K1 and
  ``ops/csrc/fenrir_backward_batch.cu``), :func:`dalton_fused_batch`
  (``ops/csrc/dalton_filter_batch.cu``) and :func:`basic_fused_batch`
  (K1, K2r), and posterior path sampling :func:`solve_sim_fused_batch` (K1
  and ``ops/csrc/sampler_batch.cu``);
- their gradients in theta, forward mode through four tangent kernels:
  :func:`fenrir_fused_batch_grad`, :func:`dalton_fused_batch_grad`,
  :func:`basic_fused_batch_grad` and the solve's sensitivities
  :func:`solve_mv_fused_batch_grad`, and :func:`fused_loglik`, which makes
  any of the three likelihoods a ``torch.autograd.Function``;
- the single solve :func:`solve_mv_fused` (``ops/csrc/filter_single.cu``
  and ``ops/csrc/smoother_single.cu``, with the k-step composed smoother)
  and the single fenrir evaluation :func:`fenrir_fused` (the same filter
  and ``ops/csrc/fenrir_backward_single.cu``); the stationary-gain
  single solve :func:`solve_mv_fused_stationary` (an exact prefix on the
  same filter, then the mean chain of ``ops/csrc/mean_chain_single.cu``);
  and
  :func:`smoother_recursion_batch_rows`, the batched solve's smoother,
  which writes its rows in one pass;
- MAGI: the float64 torch-op :func:`rodeo_tpu_torch.inference.magi_logdens`
  (and :func:`rodeo_tpu_torch.ops.precond.magi_logdens`), and the
  lane-batched :func:`magi_fused_batch` (``ops/csrc/magi_batch.cu``) with
  its reverse-mode path gradient :func:`magi_fused_batch_grad` (the same
  filter and ``ops/csrc/magi_adjoint_batch.cu``), whose
  ``torch.autograd.Function`` also serves ``.backward()``;
- non-Gaussian DALTON: the float64 torch-op
  :func:`rodeo_tpu_torch.inference.daltonng` (and
  :func:`rodeo_tpu_torch.ops.precond.daltonng`), and the lane-batched
  :func:`daltonng_fused_batch` (the Laplace-linearised filter
  ``ops/csrc/filter_nn_batch.cu``, K2r and K1) with its forward-mode
  gradient :func:`daltonng_fused_batch_grad` (``ops/csrc/
  filter_nn_batch_tan.cu``, K11e and K11a), for the observation models of
  :mod:`rodeo_tpu_torch.models.obs`;
- MCMC: the pseudo-marginal random-walk kernels
  :mod:`rodeo_tpu_torch.inference.pseudo_marginal` (with
  ``save_state``/``load_state``, the JAX package's checkpoint format), and
  :mod:`rodeo_tpu_torch.parallel`: the chains of any such algorithm
  (:func:`~rodeo_tpu_torch.parallel.run_chains`), the lockstep runners
  over the fused entry points in :mod:`rodeo_tpu_torch.parallel.chains`
  (the random walk over posterior draws, K1 and K6; MALA and HMC over
  fenrir, K11a and K11b, and DALTON, K11c; MAGI's MALA, HMC and Gibbs
  sampler of the path and sigma^2, K10a and K10b; step-size adaptation)
  and :mod:`rodeo_tpu_torch.parallel.nuts` (lockstep NUTS), and the
  diagnostics ``ess`` and ``rhat`` (:mod:`rodeo_tpu_torch.parallel.
  diagnostics`); :mod:`rodeo_tpu_torch.pytree` carries their pytrees.

The fused entry points and the model setups run on the CUDA card unless
they are given ``device="cpu"`` (:mod:`rodeo_tpu_torch.device`).
"""

__version__ = "0.1.0"

from rodeo_tpu_torch import inference
from rodeo_tpu_torch import interrogate
from rodeo_tpu_torch import parallel
from rodeo_tpu_torch import prior
from rodeo_tpu_torch.ops import (basic_fused_batch, basic_fused_batch_grad,
                                 dalton_fused_batch, dalton_fused_batch_grad,
                                 daltonng_fused_batch,
                                 daltonng_fused_batch_grad,
                                 fenrir_fused, fenrir_fused_batch,
                                 fenrir_fused_batch_grad, fused_loglik,
                                 magi_fused_batch, magi_fused_batch_grad,
                                 smoother_recursion_batch_rows,
                                 solve_mv_fused, solve_mv_fused_batch,
                                 solve_mv_fused_batch_grad,
                                 solve_mv_fused_stationary,
                                 solve_sim_fused_batch)
from rodeo_tpu_torch.solve import solve_mv, solve_sim

__all__ = ["inference", "interrogate", "parallel", "prior", "solve_mv", "solve_sim",
           "solve_mv_fused_batch", "basic_fused_batch", "fenrir_fused_batch", "dalton_fused_batch",
           "solve_sim_fused_batch", "solve_mv_fused_batch_grad",
           "basic_fused_batch_grad", "fenrir_fused_batch_grad",
           "dalton_fused_batch_grad", "fused_loglik", "solve_mv_fused",
           "solve_mv_fused_stationary",
           "fenrir_fused", "smoother_recursion_batch_rows",
           "magi_fused_batch", "magi_fused_batch_grad",
           "daltonng_fused_batch", "daltonng_fused_batch_grad"]
