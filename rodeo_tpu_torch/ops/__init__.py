r"""
The GPU compute path: Taylor preconditioning (:mod:`.precond`), the TF32
guard (:mod:`.linalg`) and the lane-batched fused solve with its two CUDA
kernels (:mod:`.fused_kalman`, sources in ``csrc/``, built by
:mod:`._build`).
"""
