#!/usr/bin/env python3
"""
Drive the PyTorch / CUDA port, rodeo_tpu_torch, on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from a checkout: it imports the package beside it and builds the 19
CUDA kernels from the checkout's sources.  Each phase prints JSON lines,
each with its "seconds" (the time since the line before it).  Where a
phase holds a kernel "at its path's shapes" against its twin, the kernel is
timed on the whole path, and it and its twin run on PATH_TWIN_STEPS steps
(or rows) of the path at the path's full width, on the same cut operands:
a forward filter's first steps, whose per-step outputs are then also the
whole path's, bitwise; a reverse recursion's last rows, from the path's
own end, whose per-row outputs are then the whole path's last rows,
bitwise.  The phases:

1. device    the card, its power limit, TF32 off;
2. build     nvcc of rodeo_tpu_torch/ops/csrc/*.cu: seconds, and ptxas'
             registers and spills per kernel;
3. k1_twin   kernel K1 (filter_batch) against its plain PyTorch twin on the
             same CUDA inputs: Lorenz63 EK1 and FitzHugh-Nagumo EK0, 1000
             steps x 256 lanes, bitwise;
4. k2r_twin  kernel K2r (smoother_batch_rows) against its twin, bitwise,
             on seeded inputs and on the gains of phase 3;
5. main      the main path: Lorenz63 EK1, 10 000 steps x 2048 lanes through
             solve_mv_fused_batch (K1, then K2r writing the rows).  It must
             launch each kernel once, stay finite, and pass the t <= 4 audit
             of lane 0 against the cached float64 truth; then its per-solve
             time and peak memory, and each kernel timed and checked against
             its twin at these shapes, both bitwise, with its launch as the
             card reports it and ptxas' registers and spills (K2r's
             achieved bytes/s beside them);
6. fitzhugh  the kernel path (800 steps x 128 lanes) and the torch-op
             solve_mv in float64, against the cached FitzHugh-Nagumo truth;
7. k6_twin, k7_twin, k8_twin
             kernels K6 (sampler_batch), K7b (fenrir_backward_batch) and K8
             (dalton_filter_batch) against their twins on the same CUDA
             inputs, 1000 steps x 256 lanes: Lorenz63 EK1, and for K8 also
             FitzHugh-Nagumo EK0, with and without data, all three
             bitwise;
8. k11_twin  the tangent kernels K11a (filter_batch_tan), K11b
             (fenrir_backward_batch_tan), K11c (dalton_filter_batch_tan) and
             K11e (smoother_mean_batch_tan) against their twins on the same
             CUDA inputs, 1000 steps x 256 lanes: Lorenz63 EK1 for all four,
             FitzHugh-Nagumo EK0 for K11a and K11c; the scaled error of each
             output's values and of each tangent direction, and whether the
             two agree bitwise, which K11a and K11c (one thread per lane,
             direction and block) and K11b (a stream with a consumer warp
             per direction) must, the values of K11a and K11c also with
             K1's and K8's;
9. likelihood  bench.py's likelihood fixture at full width: Lorenz63 EK1,
             4000 steps x 2048 lanes, 21 observations, through
             fenrir_fused_batch, dalton_fused_batch and basic_fused_batch.
             Each must launch exactly its kernels, stay finite, and pass the
             audit of lane 0 against the cached float64 truth, DALTON's two
             K8 launches counted by with_obs; then its time per call and
             peak memory, and K7b and K8 timed and checked against their
             twins at these shapes, both bitwise, K8's launch with data and
             without each alone, each with its launch as the card reports
             it and ptxas' registers and spills (K7b's achieved bytes/s
             beside them, its operations counted from the skipping twin);
10. grad     the gradients at full width: the likelihood fixture through
             fenrir_fused_batch_grad, dalton_fused_batch_grad and
             basic_fused_batch_grad, and bench.py's FitzHugh-Nagumo fixture
             (200 steps, 21 observations of y_fitz_mcmc) through
             fenrir_fused_batch_grad, 2048 lanes each.  Each must launch
             exactly its tangent kernels, stay finite, return its value
             entry point's values bitwise on every lane, and pass the value
             audit of lane 0; the gradient of lane 0 is audited as bench.py
             does (relative L2 error against the cached float64 gradient,
             pass within 3x the float32-CPU control, or recorded as unusable
             in float32 when that control, or the move of the exact
             gradient under float32 rounding of theta, exceeds 0.1), and
             FitzHugh-Nagumo's within GRAD_FITZ_TOL; then the time per call
             against the value call's, peak memory, and each tangent kernel
             timed and checked against its twin at its path's shapes (K11a
             and K11b on both fixtures, K11c with and without data, each
             launch an entry of the kernels line with its launches on the
             DALTON gradient); K11a, K11b and K11c bitwise against their
             twins, the values of K11a and K11c against K1's and K8's, and
             their launch as the card reports it (split_record) with
             ptxas' registers and spills;
11. sim      solve_sim_fused_batch at the main path's shapes (launches,
             finite, time, K6 against its twin, bitwise, with its launch as
             the card reports it, ptxas' registers and spills and its
             achieved bytes/s), and the draws' lane mean and variance
             against solve_mv_fused_batch's posterior on FitzHugh-Nagumo,
             800 steps x 2048 lanes;
12. k3_twin, k4_twin, k7a_twin
             the single-solve kernels K3 (filter_single), K4 (smoother_single)
             and K7a (fenrir_backward_single) against their twins on the same
             CUDA inputs at 1000 steps: K3 on Lorenz63 EK1 and FitzHugh-Nagumo
             EK0, bitwise, K4 on seeded gains and on K3's, bitwise, K7a on
             K3's chain with observations, bitwise;
13. single   the single-solve path: solve_mv_fused on Lorenz63 EK1, 10 000
             steps, with the default plain smoother (it must launch K3 and K4
             once, stay finite and pass the t <= 4 audit), its time and peak
             memory, and the same with the 16-step composed smoother
             (k_compose=16, the JAX package's default); fenrir_fused on the
             likelihood fixture (K3 and K7a once, the audit against the
             float64 truth); each kernel timed and checked against its twin
             at its path's shapes, K3 bitwise with its time per step, the
             SASS instructions of its step loop (cuobjdump) and its launch
             as the card reports it with ptxas' registers and spills, K4
             bitwise with the same records (its stage loop), also on the
             composed smoother's boundary groups, K7a bitwise with its
             launch and ptxas' report, and K3, K4 and K7a each with its
             dependent-chain bound (CHAIN_OPS at the SM clock's maximum;
             K7a's weighted over its steps with data and without);
14. k5_twin  the stationary solve's mean-chain kernels K5a
             (mean_gain_single), K5b (mean_boundary_single) and K5c
             (mean_recovery_single) against their twins on the same CUDA
             inputs at 1000 steps, Lorenz63 EK1 and FitzHugh-Nagumo EK0, on
             K3's exact prefix and its gains, all three bitwise; and K5b +
             K5c against K5a with the frozen gain from the same start, which
             must agree bitwise; both also on a block-constant prior that is
             not IBM (its last diagonal weight x 0.9);
15. stationary  solve_mv_fused_stationary on the single phase's Lorenz63
             EK1 10 000-step solve: it must launch K3, K5b, K5c and K4 once
             each, stay finite and pass the t <= 4 audit; its time beside
             solve_mv_fused's, in turns on the card, and peak memory; one
             call with the JAX package's 64-step composed smoother; a
             150-step horizon at the same step, which must launch K3, K5a
             and K4 once each and pass the audit on its rows; and the
             square-root form (the prior's variance as a factor): the
             solve's means bitwise the standard form's on the squared
             factor and its factors squaring to its covariances within
             SQRT_GRAM_TOL, and DALTON's value on the likelihood
             fixture's first 64 lanes (its observation variance a factor
             too) bitwise the standard form's;
16. stationary_kernels  K5a, K5b and K5c alone at their paths' shapes,
             timed and checked against their twins there, all bitwise, each
             with its dependent-chain bound, its launch as the card reports
             it, ptxas' report and the SASS instructions of its step loop,
             K5b with its time per step;
17. k10_twin the MAGI kernels K10a (magi_batch, emits "ld" and "adjoint")
             and K10b (magi_adjoint_batch, on K10a's streams) against their
             twins on the same CUDA inputs, 1000 steps x 256 lanes of the
             cached Lorenz63 path plus seeded noise, the prior's process
             noise x 1e-5: n_active 1, 2 and 3, and 2 with a per-lane
             sig2_lanes, all bitwise;
18. magi     bench.py's MAGI fixture at full width: the cached float64
             Lorenz63 path (4000 steps, dt 0.005) plus 1e-4 x lane, 2048
             lanes, n_active 2.  magi_fused_batch must launch K10a once,
             stay finite and pass the audit of lane 0 against the cached
             float64 value (bench.py's rule); magi_fused_batch_grad must
             launch K10a and K10b once each and return the value call's
             values bitwise; lane 1's gradient is audited as bench.py does
             and recorded as unusable in float32 (its float32-CPU control is
             5.06 from the truth); the informative check holds 4 lanes of
             the path plus 0.1 (i + 1) rng(3) normals, at the prior's process
             noise x 1e-5, to the float64 torch-op ops.precond.magi_logdens
             and its torch.autograd gradient (MAGI_F64_TOL); then the time
             per call of each and the gradient's ratio to the value call,
             and peak memory;
19. magi_kernels  K10a (both emits) and K10b alone at the path's shapes,
             timed and checked against their twins there, both bitwise with
             their launch (K10a's in each emit) as the card reports it and
             ptxas' report, each with its dependent-chain bound;
20. k9_twin  non-Gaussian DALTON's kernels K9 (filter_nn_batch) and K11d
             (filter_nn_batch_tan) against their twins on the same CUDA
             inputs, 1000 steps x 256 lanes, 21 observations (every 50th
             step): Lorenz63 EK1 with Gaussian data and FitzHugh-Nagumo EK0
             with Poisson counts; per output and tangent direction, K9 and
             K11d bitwise and K11d's values K9's;
21. daltonng bench.py's non-Gaussian DALTON fixture at full width:
             Lorenz63 EK1, 4000 steps to t = 20, 21 observations of
             rng(1).normal x 5 with Gaussian variance 0.005, 2048 lanes.
             daltonng_fused_batch must launch K9, K2r and K1 once each, stay
             finite and pass the audit of lane 0 against the cached float64
             value (the likelihood rule); daltonng_fused_batch_grad (at 2048
             lanes, or the largest power of two that fits) must launch K11d,
             K11e and K11a once each and return the value call's values
             bitwise; lane 0's gradient is recorded as unusable in float32
             (its float32-CPU control is NaN, and GRAD_THETA_ROUNDING); the
             informative check holds bench.py's FitzHugh-Nagumo gradient
             fixture at 4 lanes to the float64 torch-op
             ops.precond.daltonng and its torch.autograd gradient
             (DALTONNG_FITZ_VALUE_TOL, DALTONNG_FITZ_TOL); then the time per
             call of each, their ratio and peak memory;
22. daltonng_kernels  K9 and K11d alone at the path's shapes, timed and
             checked against their twins there (both bitwise, K11d's values
             K9's, each with its launch as the card reports it, ptxas'
             registers and spills and its achieved bytes/s), and the other
             kernels of
             the two calls (K2r, K1, K11a, K11e) timed there, for the time
             each call spends outside its kernels;
23. torch_op the port's torch-op surface in float64 on the card, each call
             on CUDA tensors and returning CUDA tensors: ops.precond.fenrir,
             dalton and basic on the likelihood fixture, with their
             torch.autograd gradients in theta, and basic on the
             FitzHugh-Nagumo control (800 steps), against the cached float64
             truth within TORCH_OP_TOL (tools/torch_op_reference.py runs the
             same calls); lane 0 of the likelihood phase's fenrir, DALTON
             and basic against these float64 values by the likelihood rule;
             ops.precond.solve_sim on Lorenz63 at 10 000 steps, three draws
             with each method, each finite and starting exactly at x0, and
             SIM_F64_DRAWS eigh draws on FitzHugh-Nagumo at 800 steps, all
             against the float64 posterior of ops.precond.solve_mv (the mean
             of (x - mu)^2 / sigma^2 within SIM_F64_STAT_LORENZ and
             SIM_F64_STAT; Lorenz63's posterior mean held to the cached one
             over t <= 4 by the solve audit's rule); each call's time
             (the median by CUDA events and by the wall clock) and peak
             memory, and the phase's seconds;
24. mcmc     the MCMC layer (rodeo_tpu_torch.parallel) on bench.py's MCMC
             fixture (tools/torch_mcmc_reference.py: FitzHugh-Nagumo, 200
             steps to t = 10, the 21 observations y_fitz_mcmc, sigma 0.2):
             run_chains_fused, 512 chains x 100 random-walk steps at scale
             0.01 (K1 and K6 exactly 101 launches each, finite, mean
             acceptance in (0, 1)); MALA, HMC (5 leapfrog steps) and NUTS
             (max_depth 4, 40 proposals) over fenrir_fused_batch_grad on 128
             lanes, each after a short adapt_step_size (K11a and K11b 101,
             501 and at most 1 + 15 x 40 launches, finite, the carried
             log-density bitwise a fresh fenrir_fused_batch at the final
             positions) and their theta means within AGREE_Z standard
             errors of each other (the port's ess); run_chains_mala_fused
             over DALTON, 128 lanes x 20 steps (K11c 42 launches, bitwise
             against dalton_fused_batch); run_chains_magi_gibbs on phase
             18's fixture, 4 sweeps of 2 MALA steps (K10a 21 and K10b 13
             launches, sigma^2 draws finite and positive, finite
             log-densities); and pseudo_marginal.normal_random_walk
             through run_chains, 32 chains of bench.py's mcmc_xla
             log-density (ops.precond.solve_sim, eigh) for 3 to 10 steps,
             as many as MCMC_XLA_S allows (the reference path, no kernel).
             Each runner's chain steps per second, ESS per second (of
             theta_0; of sigma^2 for Gibbs), mean acceptance and peak
             memory, and the phase's seconds, within MCMC_PHASE_S;
25. coverage the instances K1, K3, K2r and K4 took last: each new K1 and
             K3 instance (schober and chkrebtii; Hes1 and SEIRAH at q = 3;
             Chkrebtii's ODE at q = 4 and 5) bitwise against its twin on
             37 lanes and on lane 0, with its registers and local bytes;
             K2r and K4 at q = 4 and 5 bitwise on seeded rows and on
             Chkrebtii's gains; Lorenz63 10 000 x 2048 under schober and
             chkrebtii (the tool's prior sigma CHKREBTII_SIGMA): one K1 and
             one K2r launch, finite, time per call, K1 and K2r alone, peak
             memory, and K1 and K2r at 2048 lanes bitwise against their
             twins over COVERAGE_TWIN_STEPS steps; the pointwise audits of
             tools/torch_coverage_reference.py's fixtures (Chkrebtii's ODE
             at q = 4 and 5, 1024 steps, 128 lanes, where K1, K2r, K3 and
             K4 are also held bitwise to their twins over
             COVERAGE_TWIN_STEPS steps at 128 lanes and one solve; Hes1
             and SEIRAH at their setups' size, 2048 lanes; schober on
             FitzHugh-Nagumo, 800 steps), one solve and a lane batch, x
             held to the float64 torch-op solve on the card within max(3
             x COVERAGE_F32_CPU_ERR, COVERAGE_FLOOR); chkrebtii's 2048
             lanes on FitzHugh-Nagumo against 16 float64 torch-op
             realizations (CHK_MEAN_TOL, CHK_SPREAD); chkrebtii's draws at
             2048 lanes and a 512-chain x 20-step random walk (K1 and K6 a
             step), and the phase's seconds, within COVERAGE_PHASE_S;
26. coverage_value  the instances K6, K7a, K7b and K8 took last, through
             the public entries at 2048 lanes on tools/
             torch_coverage_reference.py's value fixtures (Chkrebtii's ODE
             at q = 4 and 5, 1024 steps; Hes1, 120 steps; SEIRAH, 80
             steps), each under kramer and rodeo: fenrir_fused_batch (K1,
             K7b), dalton_fused_batch (K8 with and without data),
             solve_sim_fused_batch (K1, K6) and one fenrir_fused (K3, K7a),
             launches exact and finite, and Hes1's DALTON on lanes 1 %
             apart (VALUE_WIDE_LANES), NaN in float32 on some under
             kramer, exactly where K8 and its twin are (VALUE_NAN_LANES);
             lane 0's likelihoods against the float64
             torch-ops on the card (VALUE_F32_CPU_ERR,
             VALUE_F32_UNUSABLE); the draws at the setup's parameters
             against the fused posterior (SIM_SD_REL, SIM_UNRESOLVED), and
             the float64 twins' on the same normals against theirs
             (SIM_F64_WITNESS); each new instance of K8, and of K7b, K7a
             and K6 once a q, alone at these shapes against its twin over
             COVERAGE_VALUE_TWIN_STEPS steps, bitwise,
             with its launch, ptxas' report (no spills) and bound; a
             512-chain x 20-step random walk on Chkrebtii's ODE at q = 4;
             the phase within COVERAGE_VALUE_PHASE_S;
27. coverage_grad  the instances K11a, K11b and K11e took last, through
             the public gradient entries at 2048 lanes on tools/
             torch_coverage_reference.py's gradient fixtures (the value
             fixtures, and FitzHugh-Nagumo at q = 4 and 5 on bench.py's
             200-step gradient fixture), each under kramer and rodeo:
             fenrir_fused_batch_grad (K11a, K11b), basic_fused_batch_grad
             and solve_mv_fused_batch_grad (K11a, K11e), launches exact,
             finite, the values bitwise the value calls' (K1 + K7b, K1 +
             K2r), lane 0's fenrir and basic values and gradients against
             the float64 torch-ops with torch.autograd on the card by
             bench.py's rules (GRAD_F32_CPU_ERR), each call's time beside
             its value call's; each new instance of K11a (and of K1 on
             FitzHugh-Nagumo at q = 4 and 5), and of K11e and K11b once a
             (q, directions), alone at these shapes against its twin over
             COVERAGE_GRAD_TWIN_STEPS steps, bitwise, K11a's values K1's,
             with its launch, ptxas' report (no spills) and bound; MALA over
             fenrir on Hes1, 128 lanes x 20 steps (launches, finite, the
             carried log-density bitwise a fresh value call, chain steps/s,
             acceptance); the phase within COVERAGE_GRAD_PHASE_S;
28. coverage_dalton  DALTON's gradient at every instance of K11a, through
             dalton_fused_batch_grad at 2048 lanes on the gradient
             fixtures of phase 27, each under kramer and rodeo: two K11c
             launches (one with data, one without), finite wherever K8 is,
             the values bitwise dalton_fused_batch's, lane 0's value and
             gradient against the float64 torch-op ops.precond.dalton with
             torch.autograd on the card (GRAD_F32_CPU_ERR's "dalton";
             where float32 does not resolve them, on Chkrebtii's ODE at
             q = 5 and FitzHugh-Nagumo at q = 4 and 5, recorded, and
             K11c's twins in float64 on the same operands, run on the
             host beside the phase, held to that truth instead),
             Chkrebtii's gradient exactly zero, each call's time beside its
             value call's; each new instance of K11c with and without
             data, and of K8 on FitzHugh-Nagumo at q = 4 and 5, alone at
             these shapes against its twin over COVERAGE_GRAD_TWIN_STEPS
             steps (Chkrebtii's cut with data to its first step with
             data, 65), bitwise, K11c's values K8's, with its launch,
             ptxas' report (no spills) and bound; MALA over DALTON on Hes1,
             128 lanes x 20 steps (42 K11c launches, finite, the carried
             log-density bitwise a fresh value call, chain steps/s,
             acceptance); the phase within COVERAGE_DALTON_PHASE_S;
29. coverage_daltonng  non-Gaussian DALTON at every instance of K1 under
             kramer and rodeo, through daltonng_fused_batch and
             daltonng_fused_batch_grad at 2048 lanes on the gradient
             fixtures of phase 27 (Gaussian data in derivative 0): one
             launch each of K9, K2r and K1, and of K11d, K11e and K11a,
             finite (DALTONNG_NAN_LANES), the gradient call's values
             bitwise the value call's, lane 0's value and gradient against
             the float64 torch-op ops.precond.daltonng with torch.autograd
             on the card (DALTONNG_F32_CPU_ERR; where float32 does not
             resolve them, on Chkrebtii's ODE and FitzHugh-Nagumo at q = 4
             and 5, recorded against the torch-op on the host, and the
             entries' code with the kernels' twins in float64 on lane 0's
             operands, run on the host beside the phase, held to that
             truth instead), Chkrebtii's gradient
             exactly zero, each call's time beside its value call's and the
             share of each spent in torch.linalg.eigh; each new instance of
             K9 and K11d under the path's data and, on Chkrebtii's ODE and
             FitzHugh-Nagumo, Poisson counts, alone at these shapes
             against its twin over COVERAGE_GRAD_TWIN_STEPS steps (65 on
             Chkrebtii's ODE, so that the cut holds a step with data),
             bitwise, K11d's values K9's, with its launch, ptxas' report
             (no spills) and bound; the phase within
             COVERAGE_DALTONNG_PHASE_S;

Then one line {"phase": "seconds", "phases": {...}, "total": ...} with
each phase's seconds and the script's, one line {"kernels": [...]} with
each kernel's launches on its path,
error against its twin, time on the device (ms) and of its wrapper's call
(call_ms), its plain twin's time over plain_steps steps (plain_ms) and its
bound (the
larger of its bytes over 3.35 TB/s and its float32 operations, counted
from its twin, over 67 TFLOP/s; K7b's, K8's, K11b's and K11c's from the
steps without and with data of their grid, since the twin skips the
observation update where there is none; K8's and K11c's two launches are
two entries each; K9's and K11d's entries carry the instances of phase 29
under "instances"), and,
last, {"ok": true, "device": {...}}.
Any failure exits non-zero without that last line; so does a host without
CUDA: the port is never run on the CPU here.
"""
import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# A kernel and its twin do the same float32 operations in the same order
# (the kernels are built without multiply-add contraction), the tangent
# kernels' Dual rules included; a library function (PyTorch's CUDA log
# against logf) could still round differently.  Bound on max|kernel - twin|
# / max|twin| per output, and per tangent direction.
TWIN_TOL = 1e-5
# The square-root form: the solve's factors F against the standard form's
# covariances P on the squared prior factor, max|F F' - P| / max|P|, the
# float32 rounding of the factorisation (1.1e-7 on the CPU at 200 steps).
SQRT_GRAM_TOL = 1e-5
# The solve audit of bench.py: max abs error of the solution path against
# the float64 truth <= max(3 x the same error of float32 on the CPU, 0.05).
AUDIT_FLOOR = 0.05
# The float64 torch-op solve against the float64 truth.
F64_ATOL = 1e-8
# The likelihood audit: |lane 0 - float64 truth| <= max(3 x |float32-CPU
# control - truth|, LL_REL_FLOOR x |truth|).  The floor is needed because a
# control can land closer to the truth than float32 resolves a sum of
# ~12 000 terms: DALTON's lands 0.012 from a truth of -1.39e5, where one
# float32 ulp is 0.0156.
LL_REL_FLOOR = 1e-4
# The gradient audit of bench.py (audit_grad): the relative L2 error of lane
# 0's gradient against the float64 truth passes within max(3 x the same
# error of the float32-CPU control, GRAD_FLOOR); a control above
# GRAD_CONTROL_MAX marks the gradient unusable in float32 on any hardware
# (chaotic configurations), recorded and not judged.
GRAD_FLOOR = 1e-6
GRAD_CONTROL_MAX = 0.1
# The float32 condition of a gradient, apart from any float32 arithmetic:
# the exact (float64) gradient at lane 0's theta rounded to float32, against
# the truth at theta, relative L2.  Where it exceeds GRAD_CONTROL_MAX, no
# float32 evaluation can be held to the truth, whatever its control says,
# and the gradient is recorded as unusable too.  Measured by the float64
# tangent twins, which give the truth at theta to 1e-6
# (tests/test_torch_grad.py::test_dalton_gradient_in_float64_is_the_truth
# recomputes it): DALTON on Lorenz63, whose float32-CPU control lands at
# 0.038 by the draw of its rounding.  Non-Gaussian DALTON on Lorenz63: the
# float64 torch-op ops.precond.daltonng gives the truth at theta to 2.4e-7
# and moves 1.18 away from it at theta rounded to float32
# (tools/daltonng_theta_rounding.py).
GRAD_THETA_ROUNDING = {"dalton": 0.1129397, "daltonng": 1.1840516}
# FitzHugh-Nagumo's float32-CPU control (2.54) is not a control: on a
# float32 grid the JAX package places 19 of its 21 observations one step
# late, and its value misses the truth by 11 %.  That gradient is held to
# GRAD_FITZ_TOL instead: the port's float32 twins on the CPU land 1.4e-5
# from the truth (tests/test_torch_grad.py::
# test_fitzhugh_gradient_in_float32_is_the_truth).
GRAD_FITZ_TOL = 1e-4
# The draws' check: the lane mean within SIM_Z standard errors (the
# posterior variance / B) of the posterior mean, and the lane variance
# within SIM_VAR_RATIO of the posterior variance, on entries whose
# posterior variance exceeds SIM_VAR_MIN.  Below it are derivatives that
# the ODE pins to ~3e-6 of their value (variance ~1e-10 at |x'| ~ 3), some
# 40 float32 ulps, where the sampler's and the smoother's float32 rounding
# (~1e-5 apart) decide the comparison, not the draws' distribution.
SIM_Z = 6.0
SIM_VAR_RATIO = (0.8, 1.25)
SIM_VAR_MIN = 1e-8
# MAGI's informative check (phase magi): the kernel path in float32 against
# the float64 torch-op, value relative and gradient by the JAX package's
# rule max|g - g_ref| / (max|g_ref| + 1) (tests/test_pallas_magi.py); the
# twins meet it on the CPU at 4000 steps (tests/test_torch_magi.py).
MAGI_F64_TOL = 2e-4
# Non-Gaussian DALTON's informative check (phase daltonng): bench.py's
# FitzHugh-Nagumo fixture (y_fitz_mcmc, Gaussian data of variance
# DALTONNG_FITZ_VAR = 0.2^2) at the lanes theta x DALTONNG_FITZ_LANES, in
# float32 on the card against the float64 torch-op ops.precond.daltonng.
# Each limit is 3 x the float32 twins' largest error on the CPU
# (tests/test_torch_daltonng.py::
# test_fitzhugh_float32_error_sets_the_card_tolerance): values 1.745e-2
# relative (the float32 value is rounding-bound on this fixture: the JAX
# package's fused path misses by 2.2 %), gradients 2.896e-3 relative L2.
DALTONNG_FITZ_LANES = (1.0, 1.05, 0.95, 1.1)
DALTONNG_FITZ_VAR = 0.04
DALTONNG_FITZ_VALUE_TOL = 5.3e-2
DALTONNG_FITZ_TOL = 8.7e-3
# The torch_op phase: the port's float64 torch-ops on the card against the
# cached float64 truth, relative error of each value and relative L2 error
# of each gradient.  Each limit is 10 x the same error of the port on the
# CPU in float64 (tools/torch_op_reference.py), and at least 1e-10.
TORCH_OP_TOL = {
    "fenrir": {"value": 1e-10, "grad": 8.1e-7},
    "dalton": {"value": 1e-10, "grad": 1.2e-7},
    "basic": {"value": 1.9e-8, "grad": 1.2e-6},
    "basic_fitz": {"value": 1e-10},
}
# Calls of each float64 likelihood in the torch_op phase, timed (and held
# bitwise alike where more than one): one, because its host-bound Python
# loops take 20-46 s a call where the host is slow.  On an NVIDIA H100 80GB
# HBM3 at 700 W the script's total reached 1137 s with three calls and the
# earlier phases alone, and 1291 s with two, the coverage phase and its
# larger build on a host that ran the kernels' plain twins 1.2 x slower
# than another's; one call takes ~97 s off such a run.
TORCH_OP_CALLS = 1
# The mcmc phase: its time limit, and the seconds its reference path
# (run_chains over the torch-op solve_sim, 32 chains) may take, which set
# its number of steps between 3 and 10.
MCMC_PHASE_S = 90.0
MCMC_XLA_S = 20.0
# The coverage phase (the instances of K1, K3, K2r and K4 taken last) stays
# within COVERAGE_PHASE_S seconds.  Its pointwise audits hold x, every step
# and block, of a fused solve to the float64 torch-op solve on the card
# within max(3 x the float32 twin's error on the CPU, COVERAGE_FLOOR),
# bench.py's FitzHugh-Nagumo rule (bench.py:1948-1956); the CPU errors are
# those that tools/torch_coverage_reference.py prints on the CPU.
# chkrebtii's realizations on FitzHugh-Nagumo agree with the float64
# torch-op's in distribution as the JAX package's test holds its own
# (tests/test_pallas_kalman.py:219-253): the largest difference of the
# mean paths under CHK_MEAN_TOL, the ratio of the mean spreads within
# CHK_SPREAD.  Lorenz63 runs chkrebtii at the tool's prior sigma
# CHKREBTII_SIGMA (its INSTANCE_CHECKS say why).
COVERAGE_PHASE_S = 60.0
COVERAGE_FLOOR = 1e-3
# The coverage phase holds K1, K2r, K3 and K4 bitwise to their twins at its
# paths' widths (2048 lanes under schober and chkrebtii, 128 lanes and one
# solve of Chkrebtii's ODE at q = 4 and 5) over their first
# COVERAGE_TWIN_STEPS steps: the twins' Python loops take ~5 ms a step on
# the card for Lorenz63 and ~38 ms for the four at q = 5, so their whole
# 1000-1024 steps took 69 s of the phase's 60 on an NVIDIA H100 80GB HBM3
# at 700 W.
COVERAGE_TWIN_STEPS = 128
COVERAGE_F32_CPU_ERR = {"chkrebtii_q4": 3.60294503021219e-06,
                        "chkrebtii_q5": 7.612751023122755e-06,
                        "hes1": 0.00020639555296497747,
                        "seirah": 25.953269347548485,
                        "fitz_schober": 1.077029389517925e-05}
CHK_MEAN_TOL = 1e-2
CHK_SPREAD = (0.5, 2.0)
# The coverage_value phase (the value path of K6, K7a, K7b and K8 at the
# instances they took last) stays within COVERAGE_VALUE_PHASE_S seconds.
# Lane 0's fenrir (batched and single) and DALTON values are held to the
# float64 torch-ops on the card by the likelihood rule, max(3 x the float32
# twins' error on the CPU, LL_REL_FLOOR x |truth|), the CPU errors those
# that tools/torch_coverage_reference.py prints (its "value"); where that
# CPU error exceeds VALUE_F32_UNUSABLE of the truth, no float32 evaluation
# resolves the value and it is recorded, not judged (the gradient rule's
# GRAD_CONTROL_MAX): DALTON on Chkrebtii's ODE at q = 5, the difference of
# two float32 sums of ~1e10 (ulp 1024) that is 23.9.
COVERAGE_VALUE_PHASE_S = 60.0
VALUE_F32_UNUSABLE = 0.1
VALUE_F32_CPU_ERR = {
    "chkrebtii_q4": {
        "kramer": {"fenrir_batch": 0.00012321892352318287,
                   "dalton_batch": 0.0024193006054247235,
                   "fenrir_single": 2.7851491882557866e-05},
        "rodeo": {"fenrir_batch": 1.6796901732618608e-05,
                  "dalton_batch": 0.033966106598199985,
                  "fenrir_single": 0.0002254363746345689}},
    "chkrebtii_q5": {
        "kramer": {"fenrir_batch": 0.00030747422161425675,
                   "dalton_batch": 23.899905768240217,
                   "fenrir_single": 0.00026932724895800675},
        "rodeo": {"fenrir_batch": 2.1386948990453902e-05,
                  "dalton_batch": 23.873298024863036,
                  "fenrir_single": 7.58878312829836e-05}},
    "hes1": {
        "kramer": {"fenrir_batch": 0.0027485421820898637,
                   "dalton_batch": 0.05046801196368733,
                   "fenrir_single": 0.0027485421820898637},
        "rodeo": {"fenrir_batch": 7.045598295007949e-06,
                  "dalton_batch": 0.000422002831953705,
                  "fenrir_single": 7.045598295007949e-06}},
    "seirah": {
        "kramer": {"fenrir_batch": 7577899722.8125,
                   "dalton_batch": 9511319237.75,
                   "fenrir_single": 11436659402.8125},
        "rodeo": {"fenrir_batch": 41235283.96972656,
                  "dalton_batch": 38281388.6875,
                  "fenrir_single": 16069459.969726562}}}
# The draws there are held to the sim phase's rule against the fused
# solve's posterior at the same parameters (K1, K2r), on the entries whose
# posterior variance exceeds SIM_VAR_MIN and whose standard deviation
# exceeds SIM_SD_REL of the mean's magnitude (~800 float32 ulps): SEIRAH's
# populations (~1e7) leave most entries' spread below float32's resolution
# there.  Where float32 does not resolve the draws at all (SIM_UNRESOLVED),
# their reading is recorded, not judged, and its witness is the same draws
# by the twins in float64 on the same normals against their posterior, by
# the sim rule on every entry above SIM_VAR_MIN: K6 and K1 are bitwise the
# float32 twins, which are the float64 twins' arithmetic rounded.  At
# 2048 lanes (tools/torch_coverage_reference.py, "lanes", on the CPU) the
# float32 twins read z 11.3 on SEIRAH under kramer (4800 on all 1324
# entries above SIM_VAR_MIN; rodeo 3.7 on 147 entries, 2346 on all 1440)
# and 29-6.7e4 on Chkrebtii's ODE, whose 1024 steps (dt ~ 0.01) leave the
# draw's conditional covariances numerically singular in float32 (the
# JAX package's sampler returns NaN there); the float64 twins read z 3.5
# (rodeo 3.0) on every entry and 3.4-3.7, variance ratios 0.90-1.11.  The
# phase runs that witness on the card, judged, for SIM_F64_WITNESS
# (SEIRAH, all of whose entries SIM_SD_REL would not judge), whose 80
# steps of twins take about a second; Chkrebtii's 1024 steps would take
# its phase past COVERAGE_VALUE_PHASE_S, and its witness is the tool's.
SIM_SD_REL = 1e-4
SIM_UNRESOLVED = {("chkrebtii", "kramer"), ("chkrebtii", "rodeo"),
                  ("seirah", "kramer")}
SIM_F64_WITNESS = {("seirah", "kramer"), ("seirah", "rodeo")}
# The torch_op phase's draws against the float64 posterior of
# ops.precond.solve_mv: the mean of (x - mu)^2 / sigma^2 over the draws and
# the entries whose posterior variance exceeds SIM_VAR_MIN, 1 in
# expectation.  SIM_F64_DRAWS draws on FitzHugh-Nagumo lie within
# SIM_F64_STAT.  The three draws of each method on Lorenz63 (90 000 live
# entries each) lie within SIM_F64_STAT_LORENZ: 1 +- 5 standard errors of
# a three-draw mean, from the spread of one draw's statistic over 12 draws
# (standard deviation 0.0948; tools/torch_op_costs.py --parts spread on the
# CPU), so that variances off by 1.5 x in either direction fail.  A draw is
# not held to the cached mean: over t <= 4 a Lorenz63 draw lies ~10-19 from
# its posterior mean (the phase records it as max_abs_dev_t4).
SIM_F64_DRAWS = 8
SIM_F64_STAT = (0.5, 2.0)
SIM_F64_STAT_LORENZ = (0.73, 1.27)
# at_path_shapes holds each kernel, at its path's full lane width, to its
# plain twin over PATH_TWIN_STEPS steps (or rows) of the path, a forward
# filter's first and a reverse recursion's last (its seeds the path's own
# end), on the same cut operands: the twins' Python loops over whole paths
# took 276-336 s of the script on an NVIDIA H100 80GB HBM3 at 700 W (K1's
# alone 44.8 s at 10 000 x 2048), ~6 us an ATen call.  513 is no multiple
# of any ring's stage (4, 8, 24, 64, 128 or 256 steps), so a cut ends on a
# ragged stage as a path may, and every ring wraps; K5b and K5c, which take
# whole groups of 64 steps, keep the 512 steps of 8.  At 1001 the twins
# took 65.4 s of the script.  The phases of the instances added last take
# fewer (COVERAGE_VALUE_TWIN_STEPS, COVERAGE_GRAD_TWIN_STEPS).
PATH_TWIN_STEPS = 513
# The coverage_value phase holds its kernels to their twins over the first
# (or last) COVERAGE_VALUE_TWIN_STEPS steps of its paths: over 513 the phase
# took 53.2-66.1 s of its COVERAGE_VALUE_PHASE_S on NVIDIA H100 80GB HBM3
# cards at 700 W, as the host's speed went (Chkrebtii's ODE's K8 twin makes
# 657 ATen calls a step at q = 5; its fixtures took 56.7 s of the 66.1).
# 257 is no multiple of any ring's stage either, and every ring wraps:
# K7a's two stages of 128 steps at q = 4 and 5 too.
COVERAGE_VALUE_TWIN_STEPS = 257
# The coverage_grad phase (the gradient path of K11a, K11b and K11e at the
# instances they took last) stays within COVERAGE_GRAD_PHASE_S seconds.
# Lane 0's fenrir and basic values and gradients are held to the float64
# torch-ops on the card (ops.precond.fenrir and basic with torch.autograd,
# at lane 0's float32 parameters) by bench.py's rules: the value within
# max(3 x the float32 twins' error on the CPU, LL_REL_FLOOR x |truth|),
# the gradient's relative L2 error within max(3 x its CPU error,
# GRAD_FLOOR) where that CPU error is at most GRAD_CONTROL_MAX, else
# recorded as unusable in float32; the CPU errors are those that
# tools/torch_coverage_reference.py prints (its "grad", DALTON's for the
# coverage_dalton phase, with its float64 twins' where float32 does not
# resolve DALTON: "f64_twins").  The truth is taken
# at lane 0's own float32 parameters, so the move of the exact gradient
# under float32 rounding of theta (GRAD_THETA_ROUNDING) is nil there.
COVERAGE_GRAD_PHASE_S = 90.0
# Its kernels are held to their twins over the first (a forward filter's)
# or last (a reverse recursion's) COVERAGE_GRAD_TWIN_STEPS steps of their
# paths at 2048 lanes.  The tangent twins' Python loops take 17-68 ms a
# step on the card (K11a's on FitzHugh-Nagumo at q = 5: 68 ms, on
# Chkrebtii's ODE at q = 5: 59 ms; ATen calls, whatever the lanes), so over
# PATH_TWIN_STEPS they took 180 s of the phase's 209 s on an NVIDIA H100
# 80GB HBM3 at 700 W, over 65 steps 38 s of 67.9-81.4 s, as the host's
# speed went.  33 is no multiple of K11b's ring (3 stages of 2 steps) nor
# of K11e's unroll (4, 2): each cut ends ragged and the ring wraps.
COVERAGE_GRAD_TWIN_STEPS = 33
GRAD_F32_CPU_ERR = {
    "chkrebtii_q4/kramer": {
        "fenrir": {"value": 0.00012321892352318287,
                   "grad": 0.0},
        "basic": {"value": 0.00012505028006959407,
                  "grad": 0.0},
        "dalton": {"value": 0.0024193006054247235,
                   "grad": 0.0}},
    "chkrebtii_q4/rodeo": {
        "fenrir": {"value": 1.6796901732618608e-05,
                   "grad": 0.0},
        "basic": {"value": 6.265545325767619e-05,
                  "grad": 0.0},
        "dalton": {"value": 0.033966106598199985,
                   "grad": 0.0}},
    "chkrebtii_q5/kramer": {
        "fenrir": {"value": 0.00030747422161425675,
                   "grad": 0.0},
        "basic": {"value": 0.00030754987958836466,
                  "grad": 0.0},
        "dalton": {"value": 23.899905768240217,
                   "grad": 0.0,
                   "f64_twins": {"value": 9.926950212957308e-06,
                                 "grad": 0.0}}},
    "chkrebtii_q5/rodeo": {
        "fenrir": {"value": 2.1386948990453902e-05,
                   "grad": 0.0},
        "basic": {"value": 1.1598800250922636e-05,
                  "grad": 0.0},
        "dalton": {"value": 23.873298024863036,
                   "grad": 0.0,
                   "f64_twins": {"value": 0.00011029270288176463,
                                 "grad": 0.0}}},
    "hes1/kramer": {
        "fenrir": {"value": 0.0027485421820898637,
                   "grad": 0.013795188013278508},
        "basic": {"value": 0.0003659344966777667,
                  "grad": 0.006850327337272887},
        "dalton": {"value": 0.05046801196368733,
                   "grad": 0.00026201097755028624}},
    "hes1/rodeo": {
        "fenrir": {"value": 7.045598295007949e-06,
                   "grad": 1.2277533630862706e-05},
        "basic": {"value": 6.309310670360446e-05,
                  "grad": 8.397618105735186e-05},
        "dalton": {"value": 0.000422002831953705,
                   "grad": 2.753289864598426e-05}},
    "seirah/kramer": {
        "fenrir": {"value": 7577899722.8125,
                   "grad": 7.130024152477184e-06},
        "basic": {"value": 12745448892.0,
                  "grad": 1.0570678830494094e-05},
        "dalton": {"value": 9511319237.75,
                   "grad": 7.879083819784352e-06}},
    "seirah/rodeo": {
        "fenrir": {"value": 41235283.96972656,
                   "grad": 6.429328588431707e-07},
        "basic": {"value": 40548681739.375,
                  "grad": 2.3565836834115924e-05},
        "dalton": {"value": 38281388.6875,
                   "grad": 9.21656959615569e-06}},
    "fitz_grad_q4/kramer": {
        "fenrir": {"value": 6.7625833537476865e-06,
                   "grad": 5.679384211282232e-06},
        "basic": {"value": 4.233498543726455e-06,
                  "grad": 5.900691584555457e-06},
        "dalton": {"value": 436.74042181127726,
                   "grad": 73.97514279503903,
                   "f64_twins": {"value": 0.006792659098485032,
                                 "grad": 0.005103480064770603}}},
    "fitz_grad_q4/rodeo": {
        "fenrir": {"value": 6.0791217926237096e-05,
                   "grad": 2.9790090732559288e-05},
        "basic": {"value": 6.91343101664188e-05,
                  "grad": 3.29323659138876e-05},
        "dalton": {"value": 8.797718420624733,
                   "grad": 0.01030749110868006,
                   "f64_twins": {"value": 0.00014113634824752808,
                                 "grad": 1.1045727728230106e-06}}},
    "fitz_grad_q5/kramer": {
        "fenrir": {"value": 1.7019152913633206e-05,
                   "grad": 3.2781620612611706e-05},
        "basic": {"value": 1.639740579051363e-05,
                  "grad": 3.269724910351067e-05},
        "dalton": {"value": 12.72827171848835,
                   "grad": 1.0,
                   "f64_twins": {"value": 0.008788828386650849,
                                 "grad": 0.01190640280133846}}},
    "fitz_grad_q5/rodeo": {
        "fenrir": {"value": 0.0013824775646789078,
                   "grad": 5.680806195096802e-05},
        "basic": {"value": 0.0013868248236796887,
                  "grad": 5.600059019639166e-05},
        "dalton": {"value": 9.776396930217743,
                   "grad": 10.620192528939546,
                   "f64_twins": {"value": 3.129243850708008e-05,
                                 "grad": 1.2654847720503358e-07}}}}
# MALA over fenrir on Hes1 (kramer, its Jacobian on nested Duals): 128
# lanes x 20 steps from value_lanes' thetas at this step size; the
# coverage_dalton phase's MALA over DALTON on Hes1 too
GRAD_MALA_STEP = 1e-4
# The coverage_dalton phase (DALTON's gradient K11c at every instance of
# K11a, K8 on FitzHugh-Nagumo at q = 4 and 5) stays within
# COVERAGE_DALTON_PHASE_S seconds.  Lane 0's DALTON value and gradient are
# held to the float64 torch-op (ops.precond.dalton with torch.autograd) on
# the card by coverage_grad's rules on GRAD_F32_CPU_ERR's "dalton" (the
# value recorded, not judged, where its CPU control exceeds
# VALUE_F32_UNUSABLE of the truth, as coverage_value's; the gradient where
# its control exceeds GRAD_CONTROL_MAX).  Where either is unusable in
# float32 (Chkrebtii's ODE at q = 5; FitzHugh-Nagumo at q = 4 and 5, whose
# DALTON is the difference of two float32 sums of ~1e8 and ~1e12 that
# rounds to whole numbers, to 0 at q = 5) the witness is the same
# arithmetic in float64: K11c's twin (K8's on Chkrebtii's ODE, whose
# gradient is exactly zero) on lane 0's float32 operands, held to that
# truth within max(3 x its CPU error, the floors), the "f64_twins" entry.
# Its ATen calls would take ~70 s on the card (200 and 1024 steps of
# 700-1900 calls, twice a case): they run on the card's host instead, in
# DALTON_WITNESS_WORKERS processes beside the phase's work on the card.
# Chkrebtii's ODE observes every 64th step, so its cut with data runs
# over the steps to the first with data and one more (65).
COVERAGE_DALTON_PHASE_S = 60.0
DALTON_WITNESS_WORKERS = 3
# The coverage_daltonng phase (non-Gaussian DALTON's K9 and K11d at every
# instance of K1 under kramer and rodeo) stays within
# COVERAGE_DALTONNG_PHASE_S seconds.  It runs daltonng_fused_batch and its
# gradient on the gradient fixtures of phase 27 at 2048 lanes, their data
# Gaussian in derivative 0 (tools/torch_coverage_reference.py's
# daltonng_args).  Lane 0's value and gradient are held to the float64
# torch-op ops.precond.daltonng with torch.autograd by coverage_grad's
# rules on DALTONNG_F32_CPU_ERR, the float32 twins' errors
# on the CPU (tools/torch_coverage_reference.py --parts daltonng): the
# value recorded, not judged, where its CPU error exceeds
# VALUE_F32_UNUSABLE of the truth, the gradient where its CPU error exceeds
# GRAD_CONTROL_MAX.  Float32 resolves neither at Chkrebtii's ODE (q = 4
# and 5, sums of ~1e7 to 1e13 over 1024 steps) nor at FitzHugh-Nagumo at
# q = 4 and 5; there the witness is the same arithmetic in float64: the
# entries' code with every kernel replaced by its twin, on lane 0's float32
# operands (cov_ref.daltonng_lane0_twins), held to the truth within max(3 x
# its CPU error, the floors).  The truths and the witnesses run in one pool
# of DALTONNG_WORKERS processes beside the phase's checked calls: first
# those that judge lane 0 (Hes1, SEIRAH), on the card, which the phase's
# timed work waits for, then those that a float32-unusable result is only
# recorded against, on the host, each with its witness (~2-4 s a truth on
# the card, host-bound Python loops; 0.5-2 s a truth and 0.8-6.3 s a
# witness on the CPU): all twelve truths on the card took the phase to
# 52.7 s of its 60 on an NVIDIA H100 80GB HBM3 at 700 W, their processes
# and the phase's calls slowing each other on the card.  The pool starts
# with the script, before the build, and phase 29 reports the seconds its
# processes took to start (importing torch and the package: ~10 s of the
# phase's own 46-52 s when they started within it).
# The float32 lanes are finite at 2048 lanes on the CPU wherever
# DALTONNG_NAN_LANES names no count.
COVERAGE_DALTONNG_PHASE_S = 60.0
DALTONNG_WORKERS = 6
DALTONNG_NAN_LANES = {}
DALTONNG_F32_CPU_ERR = {
    "chkrebtii_q4/kramer": {
        "float64": -5.51381816018511, "value": 18396194.48618184,
        "grad": 0.0,
        "f64_twins": {"value": 2.4632270651636645e-05,
                      "grad": 0.0}},
    "chkrebtii_q4/rodeo": {
        "float64": -5.553790148955159, "value": 262027962.44620985,
        "grad": 0.0,
        "f64_twins": {"value": 2.500404661986977e-05,
                      "grad": 0.0}},
    "chkrebtii_q5/kramer": {
        "float64": -5.533399799558538, "value": 92209701453818.47,
        "grad": 0.0,
        "f64_twins": {"value": 0.0004537355162028689,
                      "grad": 0.0}},
    "chkrebtii_q5/rodeo": {
        "float64": -5.613022094228654, "value": 16282617380858.387,
        "grad": 0.0,
        "f64_twins": {"value": 0.019932303912355565,
                      "grad": 0.0}},
    "hes1/kramer": {
        "float64": -6198.61087590412, "value": 2.6098993416198937,
        "grad": 0.00047920790607968876,
        "f64_twins": {"value": 0.0020740359814226395,
                      "grad": 2.509137783302933e-06}},
    "hes1/rodeo": {
        "float64": -250.76608093833966, "value": 0.000764764785344596,
        "grad": 0.0016183875742317004,
        "f64_twins": {"value": 4.24678364652209e-06,
                      "grad": 1.5845484223104436e-06}},
    "seirah/kramer": {
        "float64": -544512443899699.6, "value": 32728899379.625,
        "grad": 3.026944996706382e-05,
        "f64_twins": {"value": 2926943884.5625,
                      "grad": 2.2299600975705477e-06}},
    "seirah/rodeo": {
        "float64": -2549614456855.0977, "value": 207278056.90234375,
        "grad": 2.5534486982968365e-05,
        "f64_twins": {"value": 2368444.564453125,
                      "grad": 3.239712399711868e-06}},
    "fitz_grad_q4/kramer": {
        "float64": -16.267349662302877, "value": 11756.381087837697,
        "grad": 49.418998063580084,
        "f64_twins": {"value": 2.6321413315599784e-07,
                      "grad": 5.144303688425577e-06}},
    "fitz_grad_q4/rodeo": {
        "float64": -15.668421829873296, "value": 21259.058140670128,
        "grad": 136.60755680474762,
        "f64_twins": {"value": 5.248266461421736e-07,
                      "grad": 2.8031889569104065e-06}},
    "fitz_grad_q5/kramer": {
        "float64": -16.268006538186455, "value": 752833775.7319934,
        "grad": 93854931.20604667,
        "f64_twins": {"value": 3.5672746889758855e-07,
                      "grad": 1.0052050516209132e-06}},
    "fitz_grad_q5/rodeo": {
        "float64": -15.56716751404474, "value": 405324496.4328325,
        "grad": 35318814.3480051,
        "f64_twins": {"value": 2.433534973533824e-08,
                      "grad": 9.830397000118953e-08}}}
# The kernels alone take the path's Gaussian data and, where the rate
# exp(b0 + b1 x) stays finite on the fixture (DALTONNG_POISSON_MODELS),
# Poisson counts at the same steps at tests/test_torch_daltonng.py's
# (b0, b1) = DALTONNG_POISSON.
DALTONNG_POISSON = (0.1, 0.05)
DALTONNG_POISSON_MODELS = ("chkrebtii", "fitzhugh")
# the operands of K8 and K11c that hold a row a step, and those of K9 and
# K11d
GRID_KEYS = ("tgrid", "d", "y", "om", "mask")
NN_GRID_KEYS = ("tgrid", "y", "iobs", "mask")
# Clock cycles of the sleep that holds the stream while the host enqueues a
# timed kernel (device_ms): ~10 ms at the H100's clocks, longer than any
# wrapper's host work.
HOLD_CYCLES = 20_000_000
# The card's published peaks (H100 SXM, at a 700 W limit): device memory
# bandwidth and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Arithmetic operations, by name, that count towards a kernel's bound when
# its plain twin performs them (one per output element).
_ARITH = {"add", "sub", "mul", "div", "truediv", "neg", "rsub", "sqrt",
          "log", "clamp", "maximum", "minimum", "abs", "where", "gt", "lt",
          "ge", "le", "reciprocal", "exp"}
# The lane-batched value kernels K1, K2r, K6, K7b, K8; K8's entries in the
# kernels line are its two launches on the DALTON value call, with data and
# without.
VALUE_KERNELS = ("filter_batch", "smoother_batch_rows", "sampler_batch",
                 "fenrir_backward_batch", "dalton_filter_batch/with_obs",
                 "dalton_filter_batch/without_obs")
# The tangent kernels: K11a, K11b, K11c, K11e; K11c's entries are its two
# launches on the DALTON gradient, with data and without.
TAN_KERNELS = ("filter_batch_tan", "fenrir_backward_batch_tan",
               "dalton_filter_batch_tan/with_obs",
               "dalton_filter_batch_tan/without_obs",
               "smoother_mean_batch_tan")
# The tangent kernels whose grid grows with the directions, K11a (a grid
# row per direction) and K11b (a consumer warp per direction), and whose
# CTAs never wait for each other: at the models of many parameters they
# run in waves (K11a on SEIRAH's 6 x 2048 x 6 threads, K11b at 8 warps),
# so split_record records their residency where it holds every other
# kernel's CTAs to one wave.
WAVE_KERNELS = frozenset({"filter_batch_tan", "fenrir_backward_batch_tan"})
# The kernels that run one thread per (lane, block), K1, K8 and K9, per
# block of one solve, K3 and K5b, per (group, block), K5c, or per (lane,
# direction, block), K11a, K11c and K11d, bitwise against their twins, and
# the mangled names of their kernels.
SPLIT_KERNELS = {"filter_batch": "19filter_batch_kernel",
                 "filter_single": "20filter_single_kernel",
                 "mean_boundary_single": "20mean_boundary_kernel",
                 "mean_recovery_single": "20mean_recovery_kernel",
                 "dalton_filter_batch": "20dalton_filter_kernel",
                 "filter_nn_batch": "22filter_nn_batch_kernel",
                 "filter_batch_tan": "23filter_batch_tan_kernel",
                 "dalton_filter_batch_tan": "24dalton_filter_tan_kernel",
                 "filter_nn_batch_tan": "26filter_nn_batch_tan_kernel"}
# K6, K2r, K7b, K11b, K10a and K10b, streams of 32 columns a CTA through a
# ring of shared-memory stages, bitwise against their twins, and the
# mangled names of their kernels.
STREAM_KERNELS = {"sampler_batch": "20sampler_batch_kernel",
                  "smoother_batch_rows": "26smoother_batch_rows_kernel",
                  "fenrir_backward_batch": "22fenrir_backward_kernel",
                  "fenrir_backward_batch_tan": "26fenrir_backward_tan_kernel",
                  "magi_batch": "11magi_kernel",
                  "magi_adjoint_batch": "19magi_adjoint_kernel"}
# K4, K7a and K5a, streams of slabs of the single-solve layout through the
# same ring, one CTA for their one solve's blocks, bitwise against their
# twins.
SLAB_KERNELS = {"smoother_single": "22smoother_single_kernel",
                "fenrir_backward_single": "29fenrir_backward_single_kernel",
                "mean_gain_single": "16mean_gain_kernel"}
# The dependent chain of the serial kernels: float32 operations on the
# critical path of one step's (or row's) carry, counted from the code, each
# at FP32_LATENCY_CYCLES, so that rows x ops x cycles / clock is the least
# time of the recursion however its instructions are issued.  K4 (a row of
# chain_step.cuh): P's A P product (a multiply, two adds), its (A P) A'
# product (a multiply, two adds), + C: 7; m's chain is 4.  K3 (Lorenz63
# EK1, block_step.cuh): the predicted covariance (7), then P H' (3, H0
# waiting on the shuffled means), S (3), 1 / S (1), the gain (1), I - K H
# (2), the Joseph product (6): 23.  K7a, a pair (a step without data, a
# step with data) weighted by the grid's steps of each kind: the chain row
# (7), and at a step with data P D' (3), S (4), 1 / S (1), K (2), I - K D
# (2), the Joseph product (6), + K K' om (1): 26.  K10a at n_active 2, both
# emits (magi_batch.cu; the one carried entry of P, P[2][2], the others
# exact zeros): Q P Q' (a multiply and an add each way) + R (5), S's
# determinant, its reciprocal and S^{-1} (4), G (a multiply, an add: 2),
# P[2][2] - G P_a2 (a multiply, two subtractions: 3): 14.  K10b at n_active
# 2 (magi_adjoint_batch.cu): t = G lam[2] (1), u = v - t (1), lam = Q' u (a
# multiply, two adds: 3): 5.  K5a, K5b, K5c (Lorenz63, mean_chain_single.cu):
# Q m (3), x = mp tv (1), the vector field (3), z = f - W mp (1), m = mp + K
# z (2): 10; K5c's groups run in parallel, so its rows are a group's.  A
# division and a logarithm count as one operation and a shuffle as none, so
# the bound is a floor.
CHAIN_OPS = {"filter_single": 23, "smoother_single": 7,
             "fenrir_backward_single": (7, 26), "magi_batch": 14,
             "magi_adjoint_batch": 5, "mean_gain_single": 10,
             "mean_boundary_single": 10, "mean_recovery_single": 10}
FP32_LATENCY_CYCLES = 4
# The single-solve kernels K3, K4, K7a.
SINGLE_KERNELS = ("filter_single", "smoother_single",
                  "fenrir_backward_single")
# The stationary solve's mean chain K5a, K5b, K5c.
MEAN_KERNELS = ("mean_gain_single", "mean_boundary_single",
                "mean_recovery_single")
# The MAGI kernels K10a, K10b.
MAGI_KERNELS = ("magi_batch", "magi_adjoint_batch")
# Non-Gaussian DALTON's Laplace filter K9 and its tangent twin K11d.
NN_KERNELS = ("filter_nn_batch", "filter_nn_batch_tan")


# the time of the last line printed, and the seconds of each phase: the
# time before each of its lines since the line before it
_CLOCK = {"last": time.perf_counter(), "phases": {}}
# worker pools that main() starts, shut down however it ends
_POOLS = []


def emit(obj):
    """Print obj as one JSON line.  A phase's line gets "seconds", the time
    since the line before it (the work it reports), unless it states its
    own, and that time counts towards its phase's seconds."""
    now = time.perf_counter()
    if "phase" in obj:
        since = now - _CLOCK["last"]
        obj = {**obj, "seconds": obj.get("seconds", since)}
        phases = _CLOCK["phases"]
        phases[obj["phase"]] = phases.get(obj["phase"], 0.0) + since
    _CLOCK["last"] = now
    print(json.dumps(obj), flush=True)


def main():
    t_start = _CLOCK["last"] = time.perf_counter()
    if not (REPO / "rodeo_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: rodeo_tpu_torch not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port is not run on the "
              "CPU", file=sys.stderr)
        return 1

    from torch.utils._python_dispatch import TorchDispatchMode

    import rodeo_tpu_torch
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.models import fitzhugh, lorenz
    from rodeo_tpu_torch.models import obs as obs_models
    from rodeo_tpu_torch.ops import _build
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    from rodeo_tpu_torch.ops import fused_fenrir as ff
    from rodeo_tpu_torch.ops import fused_kalman as fk
    from rodeo_tpu_torch.ops import fused_magi as fm
    from rodeo_tpu_torch.ops import fused_sim as fs
    from rodeo_tpu_torch.ops import precond as tprecond

    dev = torch.device("cuda", 0)
    failures = []

    def check(phase, name, ok):
        if not ok:
            failures.append(f"{phase}: {name}")
        return bool(ok)

    counters = (fk.LAUNCHES, ff.LAUNCHES, fd.LAUNCHES, fs.LAUNCHES,
                fm.LAUNCHES, fdn.LAUNCHES)

    def reset_counts():
        for counts in counters:
            for name in counts:
                counts[name] = 0

    def read_counts():
        return {k: v for counts in counters for k, v in counts.items()}

    def expect(**launched):
        """Every kernel's count: those named, and 0 for the others."""
        return {k: launched.get(k, 0) for k in read_counts()}

    class OpCounter(TorchDispatchMode):
        """Counts the elements produced by arithmetic ATen operations,
        those that the Dual numbers of the tangent twins issue included."""

        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.strip("_")
            if name in _ARITH and isinstance(out, torch.Tensor):
                self.ops += out.numel()
            return out

    class CallCounter(TorchDispatchMode):
        """Counts the ATen operations a call dispatches: on the card, each
        is a kernel launch of PyTorch's or a host-side operation."""

        def __init__(self):
            super().__init__()
            self.calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            return func(*args, **(kwargs or {}))

    def aten_calls(fn):
        with CallCounter() as counter:
            fn()
        return counter.calls

    def op_count(fn):
        """The float32 operations of fn(), as OpCounter counts them."""
        with OpCounter() as counter:
            fn()
        return counter.ops

    def ops_per_step_lane(twin_at):
        """Float32 operations per step and lane of a kernel, counted from
        its plain twin run on the CPU on one lane: twin_at(n) runs n steps,
        and the difference of 3 and 2 steps is one step's work."""
        return op_count(lambda: twin_at(3)) - op_count(lambda: twin_at(2))

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(n_bytes, n_ops):
        """Least time on the card (ms) for n_bytes moved and n_ops float32
        operations, and which of the two limits it."""
        t_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
        t_ops = 1e3 * n_ops / PEAK_F32_PER_S
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations",
                {"bytes": n_bytes, "operations": n_ops})

    def cpu_lane(t, axis=-1):
        """The first lane of a tensor, on the CPU."""
        return t.narrow(axis, 0, 1).cpu().contiguous()

    def cuda_ms(fn, repeats):
        """Median milliseconds of fn() by CUDA events, after one warm-up."""
        fn()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(fn, repeats):
        """Median milliseconds of the device work that fn() enqueues, by
        CUDA events, after one warm-up: a sleep on the stream holds the
        start event back while the host enqueues fn, so that the wrapper's
        host time, which exceeds a short kernel's, is not counted."""
        fn()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def cuda_once(fn):
        """fn() and its milliseconds by CUDA events, one run."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def compare(names, kernel, plain):
        """Per output: max abs difference and that over max|plain|."""
        errs = {}
        for name, a, b in zip(names, kernel, plain):
            diff = (a.double() - b.double()).abs().max().item()
            scale = b.double().abs().max().item()
            errs[name] = {"max_abs_err": diff,
                          "scaled_err": diff / scale if scale else diff}
        return errs

    def slices(tensor, k, axis):
        """The values and each tangent direction of an augmented output."""
        return [tensor.narrow(axis, a * k, k)
                for a in range(tensor.shape[axis] // k)]

    def twin_errors(names, kernel, plain, split=None):
        """compare(), and where split gives each output's entries per slice
        and its axis (a tangent kernel's), per output and slice: the
        values, then each tangent direction."""
        if split is None:
            return compare(names, kernel, plain)
        errs = {}
        for name, a, b, (k, axis) in zip(names, kernel, plain, split):
            parts = ["value"] + [f"tangent{j}"
                                 for j in range(a.shape[axis] // k - 1)]
            errs.update(compare([f"{name}/{p}" for p in parts],
                                slices(a, k, axis), slices(b, k, axis)))
        return errs

    def worst(errs):
        return (max(e["max_abs_err"] for e in errs.values()),
                max(e["scaled_err"] for e in errs.values()))

    def max_err_prefix(mu, ref, n_prefix):
        """bench.py's audit: max abs error of the 0th derivative over the
        first n_prefix rows."""
        return float(np.max(np.abs(np.asarray(mu)[:n_prefix, :, 0]
                                   - np.asarray(ref)[:n_prefix, :, 0])))

    def as_tuple(out):
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def tensors(operands):
        return [v for v in operands.values() if isinstance(v, torch.Tensor)]

    def cpu_lanes(operands, lane_keys):
        """A kernel's keyword operands with those in lane_keys cut to the
        first lane, all on the CPU."""
        return {k: (cpu_lane(v) if k in lane_keys
                    else v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in operands.items()}

    def steps_cut(kernel, twin, *lead, keys=("tgrid",), **operands):
        """at_path_shapes' cut of a forward filter called as kernel(*lead,
        n, **operands), whose operands named in keys hold a row a step: n
        -> the kernel's call and its twin's on the first n steps, n, and
        False (the cut is the path's start)."""
        def cut(n):
            cut_ops = {k: (v[:n] if k in keys else v)
                       for k, v in operands.items()}
            return (lambda: kernel(*lead, n, **cut_ops),
                    lambda: twin(*lead, n, **cut_ops), n, False)
        return cut

    def rows_cut(kernel, twin, args, rows, from_end=False):
        """at_path_shapes' cut of a kernel called as kernel(*args), whose
        operands at the indices rows (its first rows operands where an
        int) hold a row a step (None where absent): n -> the kernel's call
        and its twin's on the first n rows, or on the last n where
        from_end (a reverse recursion, its seeds the path's own end), n,
        and from_end."""
        idx = range(rows) if isinstance(rows, int) else rows

        def cut(n):
            cut_args = [(a[-n:] if from_end else a[:n])
                        if i in idx and a is not None else a
                        for i, a in enumerate(args)]
            return (lambda: kernel(*cut_args), lambda: twin(*cut_args), n,
                    from_end)
        return cut

    def groups_cut(kernel, twin, args, bnd_at=None):
        """at_path_shapes' cut of a mean-chain kernel over groups of 64
        steps (K5b; K5c, whose group entry states are operand bnd_at): the
        whole groups in the first n steps, their times (operand 6) and
        entry states; the cut also gives the steps it keeps."""
        def cut(n):
            n_group = n // 64
            cut_args = list(args)
            cut_args[6] = args[6][:64 * n_group]
            if bnd_at is not None:
                cut_args[bnd_at] = args[bnd_at][:n_group]
            return (lambda: kernel(*cut_args), lambda: twin(*cut_args),
                    64 * n_group, False)
        return cut

    def as_on_path(whole, part, n, from_end):
        """Whether the rows of a cut's output part are the whole path's:
        its first n (a forward cut), or its last ones (a reverse cut: the
        n rows of the recursion and, where the output has more, the
        terminal row K2r writes after them), bitwise."""
        if not from_end:
            return torch.equal(whole[:n], part)
        m = min(part.shape[0], n + 1)
        return torch.equal(whole[-m:], part[-m:])

    def finite_part(a, b):
        """a and b with their entries that are not finite set to zero,
        where those lie at the same entries of both with the same values
        (NaN, inf or -inf); None where they do not."""
        for kind in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(kind(a), kind(b)):
                return None
        fin = torch.isfinite(a)
        return torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)

    kernels = {}

    def at_path_shapes(phase, name, replaces, launches, cut, n_path,
                       names, count_ops, n_work, inputs, split=None,
                       out_bytes=None, repeats=5, register=True, config="",
                       source=None, n_ops=None, key=None, step_outputs=(),
                       twin_steps=PATH_TWIN_STEPS, **extra):
        """A kernel alone at its path's shapes: its median time on the
        device (device_ms) and that of its wrapper's call (cuda_ms) on the
        whole path, the kernel's call of cut(n_path); then, on n =
        min(twin_steps, n_path) steps (or rows) of the path (twin_steps
        PATH_TWIN_STEPS unless given), cut(n)
        gives the kernel's call and its twin's on the same cut CUDA
        operands, whose outputs are compared (twin_errors, checked against
        TWIN_TOL, and bitwise), with the twin's time over those steps
        (plain_ms, plain_steps).  A cut is a forward filter's first steps
        or a reverse recursion's last rows; its outputs named by their
        indices in step_outputs, one row a step, are also held bitwise to
        the whole path's rows there (as_on_path: prefix_bitwise or
        suffix_bitwise).  Its bound comes from the bytes of the path's
        inputs and outputs and from count_ops(n), which runs the twin for n
        steps of one lane on the CPU, times n_work (steps x lanes), or from
        n_ops operations where given.  Registers the kernel's entry of the
        kernels line under key (its name unless given); returns the
        kernel's outputs on the whole path and the entry.  The source is
        csrc/<name>.cu unless named (a file of csrc/)."""
        launch = cut(n_path)[0]
        ms = device_ms(launch, repeats)
        call_ms = cuda_ms(launch, repeats)
        out = as_tuple(launch())
        kernel_cut, twin_cut, n_cut, from_end = cut(min(twin_steps, n_path))
        out_cut = as_tuple(kernel_cut())
        plain, plain_ms = cuda_once(lambda: as_tuple(twin_cut()))
        on_path = all(as_on_path(out[i], out_cut[i], n_cut, from_end)
                      for i in step_outputs)
        errs = twin_errors(names, out_cut, plain, split)
        bitwise = all(torch.equal(a, b) for a, b in zip(out_cut, plain))
        del plain, out_cut
        n_bytes = nbytes(*inputs) + (nbytes(*out) if out_bytes is None
                                     else out_bytes)
        bound_ms, bound_by, work = bound(
            n_bytes, n_ops if n_ops is not None
            else ops_per_step_lane(count_ops) * n_work)
        max_abs, max_scaled = worst(errs)
        entry = {
            "name": name, "route": "cuda",
            "source": f"rodeo_tpu_torch/ops/csrc/{source or name + '.cu'}",
            "replaces": f"rodeo_tpu/ops/{replaces}",
            "launches": launches[name], "max_abs_err": max_abs,
            "max_scaled_err": max_scaled, "tol_scaled": TWIN_TOL,
            "bitwise": bitwise, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "plain_steps": n_cut, "path_steps": n_path,
            "twin_cut": "last" if from_end else "first",
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work,
            "achieved_bytes_per_s": 1e3 * n_bytes / ms,
            "share_of_peak_bytes_per_s": 1e3 * n_bytes / ms
            / PEAK_BYTES_PER_S,
            "library_ms": None, **extra}
        label = f"{name} {config}".strip()
        entry["ok"] = check(phase, f"{label} vs twin", max_scaled <= TWIN_TOL)
        if step_outputs:
            where = "last" if from_end else "first"
            entry["suffix_bitwise" if from_end else "prefix_bitwise"] = check(
                phase, f"{label} over the {where} {n_cut} steps as on the "
                "path", on_path)
        if register:
            kernels[key or name] = entry
        return out, entry

    def lane_setup(mod, n_steps, t_max, n_lane, thetas_of):
        cfg = mod.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float32,
                        device=dev)
        thetas = thetas_of(cfg["theta"], n_lane)
        inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
        return cfg, thetas, inits

    def seeded_thetas(seed):
        def make(theta, n_lane):
            rng = np.random.default_rng(seed)
            noise = torch.tensor(rng.standard_normal((n_lane, 3)),
                                 dtype=torch.float32, device=dev)
            return theta * (1 + 0.01 * noise)
        return make

    def bench_thetas(theta, n_lane):
        # bench.py's lane batch: theta * (1 + 1e-6 * lane index)
        lanes = torch.arange(n_lane, dtype=torch.float32, device=dev)
        return theta.expand(n_lane, 3) * (1 + 1e-6 * lanes[:, None])

    truth = dict(np.load(REPO / ".bench_ref_v8.npz"))
    truth.update(np.load(REPO / ".bench_ref_v8_ctrl.npz"))

    # ---- 1. device and precision --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32_off = check("device", "tf32",
                     not torch.backends.cuda.matmul.allow_tf32
                     and not torch.backends.cudnn.allow_tf32)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # the SM clock's maximum (MHz), for the dependent-chain bounds
    max_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "max_sm_clock_mhz": max_clock_mhz,
          "tf32_off": tf32_off,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # phase 29's worker processes, started here so that their start
    # (imports on the host; no work on the card until phase 29 submits it)
    # runs beside the build; each reports when it is ready
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures import wait as futures_wait

    sys.path.insert(0, str(REPO / "tools"))
    import torch_coverage_reference as cov_ref

    spawn = multiprocessing.get_context("spawn")
    t_pool = time.monotonic()
    daltonng_pool = ProcessPoolExecutor(
        DALTONNG_WORKERS, mp_context=spawn,
        initializer=cov_ref.daltonng_worker_init)
    _POOLS.append(daltonng_pool)
    pool_ready = [daltonng_pool.submit(time.monotonic)
                  for _ in range(DALTONNG_WORKERS)]

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = _build.build_log() or ""
    ptxas = [line.strip() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line
             or "spill" in line]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    def ptxas_report(symbol):
        """ptxas' registers, stack and spill bytes for each instantiation
        of the kernel whose mangled name holds symbol, from the build's
        log (a Compiling line, then its stack and spill line, then its
        registers).  A filter's instantiation is named by its model,
        observation model, q, mode and with_obs; K5a's, K5b's and K5c's by
        their model and q, K5a's and K5c's by the floats a copy moves;
        a stream's (K6, K2r, K4, K7b, K11b, K7a) by q, K11b's directions
        and the floats a copy moves; K11e's by q; K10a's by q, n_active,
        the emit and the floats a copy moves; K10b's by q, n_active and the
        floats a copy moves."""
        rows, entry = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = None
                if symbol in line:
                    args = re.search(r"(Lorenz63|FitzHughNagumo|Chkrebtii"
                                     r"|Hes1|Seirah)E"
                                     r"(?:NS_\d+(Gauss|Poisson)E)?Li(\d+)"
                                     r"ELi(\d+)E(?:Lb(\d)E)?", line)
                    magi = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)ELi(\d+)EE",
                                     line)
                    adjoint = re.search(r"19magi_adjoint_kernelILi(\d+)E"
                                        r"Li(\d+)ELi(\d+)EE", line)
                    mean = re.search(r"mean_\w+?_kernelINS_\d+(\w+?)E"
                                     r"Li(\d+)E(?:Li(\d+)E)?E", line)
                    if adjoint is not None:
                        entry = {"q": int(adjoint[1]),
                                 "n_active": int(adjoint[2]),
                                 "floats_per_copy": int(adjoint[3])}
                    elif mean is not None:
                        entry = {"model": mean[1], "q": int(mean[2])}
                        if mean[3] is not None:
                            entry["floats_per_copy"] = int(mean[3])
                    elif magi is not None:
                        entry = {"q": int(magi[1]), "n_active": int(magi[2]),
                                 "emit_adjoint": bool(int(magi[3])),
                                 "floats_per_copy": int(magi[4])}
                    elif args is None and re.search(r"kernelILi\d+EEEv",
                                                    line):
                        entry = {"q": int(re.search(r"kernelILi(\d+)EEEv",
                                                    line)[1])}
                    elif args is None:
                        args = re.search(r"ILi(\d+)E(?:Li(\d+)E)?Li(\d+)EE",
                                         line)
                        entry = {"q": int(args[1]),
                                 "floats_per_copy": int(args[3])}
                        if args[2] is not None:
                            entry["n_tan"] = int(args[2])
                    else:
                        entry = {"model": args[1], "obs": args[2],
                                 "q": int(args[3]), "mode": int(args[4]),
                                 "with_obs": None if args[5] is None
                                 else bool(int(args[5]))}
                    rows.append(entry)
            elif entry is not None and "spill stores" in line:
                stack, stores, loads = map(int, re.findall(r"(\d+) bytes",
                                                           line))
                entry.update(stack_bytes=stack, spill_stores=stores,
                             spill_loads=loads)
            elif entry is not None and "registers" in line:
                entry["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line)[1])
        return rows

    def earlier_scope(rows):
        """The instantiations of ptxas_report that the phases before
        coverage run: q = 3, Lorenz63 and FitzHugh-Nagumo, kramer and
        rodeo (the coverage phase records the others)."""
        return [r for r in rows if r.get("q") == 3
                and r.get("model", "Lorenz63") in ("Lorenz63",
                                                   "FitzHughNagumo")
                and r.get("mode", 0) in (0, 1)]

    def split_record(phase, kernel, label, geometry, per_sm=True,
                     match=None, waves=False):
        """The launch of a split kernel (SPLIT_KERNELS) at its path's lanes,
        or of a stream (STREAM_KERNELS) at its path's columns, as the card
        reports it (CTA shape, CTAs, threads, registers, local memory, CTAs
        an SM holds; a stream's stages) and ptxas' report of each
        instantiation; checks, under phase, that its CTAs are all resident
        at once and that no instantiation spills.  A tangent kernel (a grid
        row per direction) and a stream of columns (K6, K2r, K7b, K11b,
        K10a, K10b) must also have at least one CTA per SM.  A value filter
        (K1, K8, K9) has no direction axis: at 2048 lanes it runs 128 CTAs
        of 16 lanes (K1) or 64 of 32 (K8, K9), fewer than the card's 132
        SMs, so it is not held to that; nor are K3, K5b and the slab streams
        K4 and K7a (SLAB_KERNELS), one CTA for one solve, nor a stream at
        fewer columns
        than 32 a CTA on every SM (per_sm False: K11b on FitzHugh-Nagumo's 2
        x 2048 columns, 128 CTAs).  The instantiations reported are those
        of the earlier phases (earlier_scope), or those match(row) keeps.
        The residency of WAVE_KERNELS, and of a launch that runs in waves
        (waves: K11c on SEIRAH's 6 x 2048 x 6 threads), is recorded, not
        checked."""
        report = ptxas_report({**SPLIT_KERNELS, **STREAM_KERNELS,
                               **SLAB_KERNELS}[kernel])
        report = earlier_scope(report) if match is None \
            else [r for r in report if match(r)]
        if kernel not in WAVE_KERNELS and not waves:
            check(phase, f"{label} all resident", geometry["all_resident"])
        if per_sm and (geometry["grid_y"] > 1 or kernel in STREAM_KERNELS):
            check(phase, f"{label} at least one CTA per SM",
                  geometry["ctas_at_least_sms"])
        check(phase, f"{label} spills nothing",
              report and all(r.get("spill_stores") == 0
                             and r.get("spill_loads") == 0 for r in report))
        return {"geometry": geometry, "ptxas": report}

    @contextlib.contextmanager
    def split_by_obs(name, by_obs):
        """Inside the block, the launches of fd.<name> (K8 or K11c) are also
        counted by the with_obs argument of the call that made them, in
        by_obs, set to 0 here as reset_counts sets the other counts."""
        wrapper = getattr(fd, name)
        by_obs.update({True: 0, False: 0})

        def counted(*args, **kw):
            before = fd.LAUNCHES[name]
            out = wrapper(*args, **kw)
            by_obs[bool(kw["with_obs"])] += fd.LAUNCHES[name] - before
            return out

        setattr(fd, name, counted)
        try:
            yield
        finally:
            setattr(fd, name, wrapper)

    # ---- 3. K1 against its twin ---------------------------------------------
    k1_names = ["G", "g", "L", "m_last", "p_last"]
    gains = None
    for model, mode, t_max, seed in (("lorenz", "kramer", 2.0, 0),
                                     ("fitzhugh", "rodeo", 10.0, 1)):
        n_steps, n_lane = 1000, 256
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        cfg, thetas, inits = lane_setup(mod, n_steps, t_max, n_lane,
                                        seeded_thetas(seed))
        ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0,
                                  t_max, n_steps, cfg["prior_pars"])
        fused = fk.resolve_model(model)
        out_k = fk.fused_filter_batch(fused, n_steps, **ops, mode=mode)
        out_p = fk._filter_batch_plain(fused, n_steps, **ops, mode=mode)
        torch.cuda.synchronize()
        errs = compare(k1_names, out_k, out_p)
        bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        ok = check("k1_twin", f"{model}/{mode}",
                   worst(errs)[1] <= TWIN_TOL and bitwise
                   and all(torch.isfinite(a).all().item() for a in out_k))
        emit({"phase": "k1_twin", "model": model, "mode": mode,
              "n_steps": n_steps, "n_lane": n_lane, "tol_scaled": TWIN_TOL,
              "bitwise": bitwise, "errors": errs, "ok": ok})
        if gains is None:
            gains, k1_x0, k1_tv = out_k, ops["x0_lanes"], ops["t_vec"]

    # ---- 4. K2r against its twin --------------------------------------------
    rng = np.random.default_rng(2)
    T, q, nb, B = 1000, 3, 3, 256
    G = np.eye(q).reshape(1, q * q, 1, 1) * 0.5 + \
        0.1 * rng.standard_normal((T, q * q, nb, B))
    A = rng.standard_normal((T, nb, B, q, q))
    Lfull = A @ np.swapaxes(A, -1, -2)
    pairs, _ = fk._tri_idx(q)
    L = np.stack([Lfull[..., i, j] for i, j in pairs], axis=1)
    m_sc = np.array([1.0, 0.5, 0.25])
    seeded = [torch.tensor(a, dtype=torch.float32, device=dev).contiguous()
              for a in (rng.standard_normal((T, q, nb, B)), G, L,
                        rng.standard_normal((q, nb, B)),
                        np.abs(rng.standard_normal((len(pairs), nb, B))),
                        rng.standard_normal((q, nb, B)), m_sc,
                        [m_sc[i] * m_sc[j] for i, j in pairs])]
    G1, g1, L1, m1, p1 = gains
    for source, args in (("seeded", seeded),
                         ("k1_gains", (g1[1:], G1[1:], L1[1:], m1, p1,
                                       k1_x0, k1_tv, fk._tri_scale(k1_tv)))):
        out_k = fk.smoother_recursion_batch_rows(*args)
        out_p = fk._smoother_batch_rows_plain(*args)
        torch.cuda.synchronize()
        errs = compare(["mean", "cov"], out_k, out_p)
        bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        ok = check("k2r_twin", source, worst(errs)[1] <= TWIN_TOL and bitwise)
        emit({"phase": "k2r_twin", "inputs": source, "tol_scaled": TWIN_TOL,
              "bitwise": bitwise, "errors": errs, "ok": ok})
    del gains, G1, g1, L1, m1, p1, seeded, k1_x0, k1_tv

    # ---- 5. the main path --------------------------------------------------
    n_steps, n_lane, t_max = 10000, 2048, 20.0
    cfg, thetas, inits = lane_setup(lorenz, n_steps, t_max, n_lane,
                                    bench_thetas)

    def solve():
        return fk.solve_mv_fused_batch(
            thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
            cfg["prior_pars"], model="lorenz", interrogation="kramer")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mean, var = solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    check("main", "one launch per kernel",
          launches == expect(filter_batch=1, smoother_batch_rows=1))
    shapes_ok = check("main", "shapes",
                      tuple(mean.shape) == (n_steps + 1, 3, 3, n_lane)
                      and tuple(var.shape) == (n_steps + 1, 3, 6, n_lane))
    finite = check("main", "finite", torch.isfinite(mean).all().item()
                   and torch.isfinite(var).all().item())
    n_prefix = n_steps // 5              # t <= 4
    err = max_err_prefix(mean[..., 0].cpu().numpy(), truth["solve_mu_10k"],
                         n_prefix)
    control = max_err_prefix(truth["solve_mu_10k_f32cpu"],
                             truth["solve_mu_10k"], n_prefix)
    tol = max(3 * control, AUDIT_FLOOR)
    audit_ok = check("main", "audit", err <= tol)
    del mean, var
    solve_ms = cuda_ms(solve, repeats=5)
    emit({"phase": "main", "model": "lorenz", "interrogation": "kramer",
          "n_steps": n_steps, "n_lane": n_lane, "t_max": t_max,
          "launches": launches, "shapes_ok": shapes_ok, "finite": finite,
          "audit_max_abs_err_t4": err, "audit_control_f32cpu": control,
          "audit_tol": tol, "audit_ok": audit_ok,
          "first_call_s": first_s, "solve_ms": solve_ms,
          "per_solve_us": 1e3 * solve_ms / n_lane,
          "peak_mem_bytes": peak_bytes})

    # each kernel at the main path's shapes, timed and checked against its
    # twin (these launches come after the counts above were read)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    fused = fk.resolve_model("lorenz")
    cpu_ops = cpu_lanes(ops, ("x0_lanes", "theta_lanes"))
    (G, g, L, mN, pN), entry = at_path_shapes(
        "main", "filter_batch", "pallas_kalman.py:1141", launches,
        steps_cut(fk.fused_filter_batch, fk._filter_batch_plain, fused,
                  **ops, mode="kramer"), n_steps,
        k1_names, lambda n: fk._filter_batch_plain(
            fused, n, **{**cpu_ops, "tgrid": cpu_ops["tgrid"][:n]},
            mode="kramer"),
        n_steps * n_lane, tensors(ops), repeats=3, source="filter_batch.cuh",
        step_outputs=(0, 1, 2),
        shape=f"{n_steps} x {n_lane}",
        **split_record("main", "filter_batch", "filter_batch lorenz",
                       fk._filter_batch_geometry("lorenz", n_lane)))
    check("main", "filter_batch bitwise", entry["bitwise"])
    t_vec = ops["t_vec"]
    rows_args = (g[1:], G[1:], L[1:], mN, pN, ops["x0_lanes"], t_vec,
                 fk._tri_scale(t_vec))
    del G, g, L, mN, pN
    rows_cpu = ([cpu_lane(a) for a in rows_args[:6]]
                + [a.cpu() for a in rows_args[6:]])
    _, entry = at_path_shapes(
        "main", "smoother_batch_rows", "pallas_kalman.py:1609", launches,
        rows_cut(fk.smoother_recursion_batch_rows,
                 fk._smoother_batch_rows_plain, rows_args, 3, from_end=True),
        n_steps - 1, ["mean", "cov"],
        lambda n: fk._smoother_batch_rows_plain(
            *[a[:n] for a in rows_cpu[:3]], *rows_cpu[3:]),
        (n_steps - 1) * n_lane, rows_args, repeats=3, step_outputs=(0, 1),
        also_replaces="rodeo_tpu/ops/pallas_kalman.py:1516",
        **split_record("main", "smoother_batch_rows", "smoother_batch_rows",
                       fk._smoother_batch_rows_geometry(3, n_lane)))
    check("main", "smoother_batch_rows bitwise", entry["bitwise"])
    del rows_args, rows_cpu
    emit({"phase": "main_kernels", "n_steps": n_steps, "n_lane": n_lane,
          "filter_batch": kernels["filter_batch"],
          "smoother_batch_rows": kernels["smoother_batch_rows"]})

    # ---- 6. FitzHugh-Nagumo --------------------------------------------
    n_fh = 800
    cfg_fh, thetas_fh, inits_fh = lane_setup(fitzhugh, n_fh, 10.0, 128,
                                             bench_thetas)
    mean_fh, _ = fk.solve_mv_fused_batch(
        thetas_fh, cfg_fh["ode_weight"], inits_fh, 0.0, 10.0, n_fh,
        cfg_fh["prior_pars"], model="fitzhugh", interrogation="kramer")
    err_fh = max_err_prefix(mean_fh[..., 0].cpu().numpy(),
                            truth["solve_mu_fitz"], n_fh + 1)
    control_fh = max_err_prefix(truth["solve_mu_fitz_f32cpu"],
                                truth["solve_mu_fitz"], n_fh + 1)
    tol_fh = max(3 * control_fh, AUDIT_FLOOR)
    fused_ok = check("fitzhugh", "kernel path audit", err_fh <= tol_fh)
    cfg64 = fitzhugh.setup(n_steps=n_fh, t_max=10.0, dtype=torch.float64,
                           device=dev)
    theta64 = cfg64.pop("theta")
    mu64, _ = rodeo_tpu_torch.solve_mv(key=None,
                                       interrogate=interrogate_kramer,
                                       theta=theta64, **cfg64)
    err64 = float(np.max(np.abs(mu64.cpu().numpy()
                                - truth["solve_mu_fitz"])))
    f64_ok = check("fitzhugh", "torch-op float64", err64 <= F64_ATOL)
    emit({"phase": "fitzhugh", "n_steps": n_fh, "n_lane": 128,
          "kernel_path_max_abs_err": err_fh, "control_f32cpu": control_fh,
          "tol": tol_fh, "kernel_path_ok": fused_ok,
          "torch_op_f64_max_abs_err": err64, "atol": F64_ATOL,
          "torch_op_f64_ok": f64_ok})

    # ---- 7. K6, K7b and K8 against their twins ---------------------------
    def bench_obs(model_mod, t_max, n_obs, seed):
        """bench.py's observation model: the 0th derivative of every
        variable at n_obs evenly spaced times, variance 0.005, data
        rng(seed).normal * 5."""
        nb = model_mod.N_VARS
        weight = torch.zeros((n_obs, nb, 1, 3), device=dev)
        weight[..., 0] = 1.0
        data = np.random.default_rng(seed).normal(size=(n_obs, nb, 1)) * 5
        return dict(
            obs_data=torch.tensor(data, dtype=torch.float32, device=dev),
            obs_times=torch.tensor(np.linspace(0.0, t_max, n_obs),
                                   dtype=torch.float32),
            obs_weight=weight,
            obs_var=torch.full((n_obs, nb, 1, 1), 0.005, device=dev))

    def fenrir_chain(n, t_max_m, ops_m, obs):
        """K7b's operands on the fenrir path (Lorenz63 EK1)."""
        return ff._fenrir_operands(fused, n, 0.0, t_max_m, ops_m,
                                   *obs.values(), "kramer")

    def fenrir_plain(*chain):
        """K7b's twin, which skips the update at steps without data."""
        return chain[-1] + fd._block_sum(ff._fenrir_backward_plain(
            *chain[:-1], skip_unobserved=True))

    def fenrir_single_plain(*chain):
        """K7a's twin, its blocks' sums added as the wrapper adds them."""
        return chain[-1] + fd._block_sum(
            ff._fenrir_backward_single_plain(*chain[:-1]))

    n_tw, b_tw = 1000, 256
    cfg_tw, thetas_tw, inits_tw = lane_setup(lorenz, n_tw, 2.0, b_tw,
                                             seeded_thetas(3))
    ops_tw = fk._kernel_operands(thetas_tw, cfg_tw["ode_weight"], inits_tw,
                                 0.0, 2.0, n_tw, cfg_tw["prior_pars"])
    obs_tw = bench_obs(lorenz, 2.0, 11, 0)
    gen = torch.Generator(dev).manual_seed(4)
    eps = torch.randn((n_tw - 1, 3, 3, b_tw), generator=gen, device=dev)
    eps_term = torch.randn((3, 3, b_tw), generator=gen, device=dev)
    k6_args = fs._draw_operands(fused, n_tw, ops_tw, "kramer", eps,
                                eps_term)
    out_k = fs.sampler_batch(*k6_args)
    out_p = fs._sampler_batch_plain(*k6_args)
    errs = compare(["xs"], [out_k], [out_p])
    bitwise = torch.equal(out_k, out_p)
    ok = check("k6_twin", "lorenz/kramer",
               worst(errs)[1] <= TWIN_TOL and bitwise)
    emit({"phase": "k6_twin", "model": "lorenz", "mode": "kramer",
          "n_steps": n_tw, "n_lane": b_tw, "tol_scaled": TWIN_TOL,
          "bitwise": bitwise, "errors": errs, "ok": ok})
    del out_k, out_p
    chain = fenrir_chain(n_tw, 2.0, ops_tw, obs_tw)
    out_k, out_p = ff.fenrir_backward_batch(*chain), fenrir_plain(*chain)
    errs = compare(["ld"], [out_k], [out_p])
    bitwise = torch.equal(out_k, out_p)
    ok = check("k7_twin", "lorenz/kramer",
               worst(errs)[1] <= TWIN_TOL and bitwise)
    emit({"phase": "k7_twin", "model": "lorenz", "mode": "kramer",
          "n_steps": n_tw, "n_lane": b_tw, "tol_scaled": TWIN_TOL,
          "bitwise": bitwise, "errors": errs, "ok": ok})
    del out_k, out_p
    del k6_args, chain, eps, eps_term
    for model, mode, t_max_tw in (("lorenz", "kramer", 2.0),
                                  ("fitzhugh", "rodeo", 10.0)):
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        cfg_m, thetas_m, inits_m = lane_setup(mod, n_tw, t_max_tw, b_tw,
                                              seeded_thetas(5))
        ops_m, obs_m, ld0_m = fd._dalton_prepare(
            thetas_m, cfg_m["ode_weight"], inits_m, 0.0, t_max_tw, n_tw,
            cfg_m["prior_pars"], *bench_obs(mod, t_max_tw, 11, 0).values())
        fused_m = fk.resolve_model(model)
        for with_obs in (True, False):
            args = dict(**ops_m, **obs_m, ld0=ld0_m, mode=mode,
                        with_obs=with_obs)
            out_k = fd.dalton_filter_batch(fused_m, n_tw, **args)
            out_p = fd._dalton_filter_plain(fused_m, n_tw, **args)
            errs = compare(["ld"], [out_k], [out_p])
            bitwise = torch.equal(out_k, out_p)
            ok = check("k8_twin", f"{model}/{mode}/with_obs={with_obs}",
                       worst(errs)[1] <= TWIN_TOL and bitwise)
            emit({"phase": "k8_twin", "model": model, "mode": mode,
                  "with_obs": with_obs, "n_steps": n_tw, "n_lane": b_tw,
                  "tol_scaled": TWIN_TOL, "bitwise": bitwise,
                  "errors": errs, "ok": ok})

    # ---- 8. the tangent kernels against their twins -----------------------
    n_tan = 3
    # the outputs of K11a (A, b, C, last m, last p), K11b and K11c (ld) and
    # K11e (ms): entries per slice and the axis of the slices
    k11a_split = [(9, 1), (3, 1), (6, 1), (3, 0), (6, 0)]
    ld_split, k11e_split = [(1, 0)], [(3, 1)]

    def tan_report(kernel, config, names, kernel_out, twin_out, split,
                   value_out=None):
        """A tangent kernel against its twin; the split kernels (K11a,
        K11c) and the stream K11b must agree with it bitwise, and the
        values of the split kernels (the first slice of each output) with
        value_out, the value kernel's."""
        kernel_out, twin_out = as_tuple(kernel_out), as_tuple(twin_out)
        errs = twin_errors(names, kernel_out, twin_out, split)
        bitwise = all(torch.equal(a, b) for a, b in zip(kernel_out, twin_out))
        ok = check("k11_twin", f"{kernel} {config}",
                   worst(errs)[1] <= TWIN_TOL
                   and all(torch.isfinite(a).all().item()
                           for a in kernel_out)
                   and (bitwise or kernel not in {**SPLIT_KERNELS,
                                                  **STREAM_KERNELS}))
        values = None if value_out is None else check(
            "k11_twin", f"{kernel} {config} values",
            all(torch.equal(slices(a, k, axis)[0], v) for a, v, (k, axis)
                in zip(kernel_out, as_tuple(value_out), split)))
        emit({"phase": "k11_twin", "kernel": kernel, "config": config,
              "n_steps": n_tw, "n_lane": b_tw, "tol_scaled": TWIN_TOL,
              "bitwise": bitwise, "values_bitwise": values,
              "errors": errs, "ok": ok})

    def fenrir_tan_plain(*chain):
        return chain[-1] + fd._block_sum(ff._fenrir_backward_tan_plain(
            *chain[:-1], n_tan).movedim(-2, 0))

    def dalton_seed(ld0, with_obs):
        """K11c's seed: ld0 in the value row with data, zero otherwise."""
        seed = torch.cat([ld0[None], ld0.new_zeros((n_tan, ld0.shape[0]))])
        return seed if with_obs else torch.zeros_like(seed)

    for model, mode, t_max_tw in (("lorenz", "kramer", 2.0),
                                  ("fitzhugh", "rodeo", 10.0)):
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        cfg_m, thetas_m, inits_m = lane_setup(mod, n_tw, t_max_tw, b_tw,
                                              seeded_thetas(8))
        obs_m = bench_obs(mod, t_max_tw, 11, 0)
        ops_m, grid_m, ld0_m = fd._dalton_prepare(
            thetas_m, cfg_m["ode_weight"], inits_m, 0.0, t_max_tw, n_tw,
            cfg_m["prior_pars"], *obs_m.values())
        fused_m = fk.resolve_model(model)
        config = f"{model}/{mode}"
        out_k = fk.fused_filter_batch_tan(fused_m, n_tw, **ops_m, mode=mode)
        tan_report("filter_batch_tan", config, k1_names, out_k,
                   fk._filter_batch_tan_plain(fused_m, n_tw, **ops_m,
                                              mode=mode), k11a_split,
                   fk.fused_filter_batch(fused_m, n_tw, **ops_m, mode=mode))
        for with_obs in (True, False):
            args = dict(**ops_m, **grid_m, mode=mode, with_obs=with_obs,
                        ld0=dalton_seed(ld0_m, with_obs))
            tan_report("dalton_filter_batch_tan",
                       f"{config}/with_obs={with_obs}", ["ld"],
                       fd.dalton_filter_batch_tan(fused_m, n_tw, **args),
                       fd._dalton_filter_tan_plain(fused_m, n_tw, **args),
                       ld_split, fd.dalton_filter_batch(
                           fused_m, n_tw, **{**args, "ld0": args["ld0"][0]}
                       )[None])
        if model == "lorenz":
            A, b, _, m_last, _ = out_k
            e_args = (b[1:], A[1:], m_last, n_tan)
            tan_report("smoother_mean_batch_tan", config, ["ms"],
                       fk.smoother_mean_recursion_batch_tan(*e_args),
                       fk._smoother_mean_tan_plain(*e_args), k11e_split)
            chain = ff._fenrir_operands(fused_m, n_tw, 0.0, t_max_tw, ops_m,
                                        *obs_m.values(), mode, tangent=True)
            tan_report("fenrir_backward_batch_tan", config, ["ld"],
                       ff.fenrir_backward_batch_tan(*chain),
                       fenrir_tan_plain(*chain), ld_split)
            del A, b, m_last, e_args, chain
        del out_k

    # ---- 9. the likelihoods at full width ---------------------------------
    n_ll, b_ll, t_ll = 4000, 2048, 20.0
    cfg_ll, thetas_ll, inits_ll = lane_setup(lorenz, n_ll, t_ll, b_ll,
                                             bench_thetas)
    lanes_ll = dict(thetas=thetas_ll, ode_weight=cfg_ll["ode_weight"],
                    ode_inits=inits_ll, t_min=0.0, t_max=t_ll, n_steps=n_ll,
                    prior_pars=cfg_ll["prior_pars"], model="lorenz",
                    interrogation="kramer")
    obs_f = bench_obs(lorenz, t_ll, 21, 0)        # fenrir and dalton
    obs_b = bench_obs(lorenz, t_ll, 21, 1)        # basic

    def b_loglik(obs_data, ode_data):
        return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    paths = {
        "fenrir": (lambda: ff.fenrir_fused_batch(**lanes_ll, **obs_f),
                   expect(filter_batch=1, fenrir_backward_batch=1)),
        "dalton": (lambda: fd.dalton_fused_batch(**lanes_ll, **obs_f),
                   expect(dalton_filter_batch=2)),
        "basic": (lambda: fk.basic_fused_batch(
            **lanes_ll, obs_data=obs_b["obs_data"],
            obs_times=obs_b["obs_times"], obs_loglik=b_loglik)[0],
            expect(filter_batch=1, smoother_batch_rows=1)),
    }
    path_launches = {}
    # lane 0 of each likelihood, for the torch_op phase's float64 check
    fused_lane0 = {}
    # K8's launches on each path by with_obs, set to 0 with the other counts
    k8_by_obs = {}
    for name, (call, expected) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with split_by_obs("dalton_filter_batch", k8_by_obs):
            ll = call()
        torch.cuda.synchronize()
        got = read_counts()
        path_launches[name] = got
        if name == "dalton":
            k8_dalton = dict(k8_by_obs)
            check("likelihood", "dalton launches by with_obs",
                  k8_dalton == {True: 1, False: 1})
        peak = torch.cuda.max_memory_allocated()
        check("likelihood", f"{name} launches", got == expected)
        finite = check("likelihood", f"{name} finite",
                       tuple(ll.shape) == (b_ll,)
                       and torch.isfinite(ll).all().item())
        ref = float(truth[f"{name}_ll"])
        control = abs(float(truth[f"{name}_ll_f32cpu"]) - ref)
        lane0 = float(ll[0])
        fused_lane0[name] = lane0
        err = abs(lane0 - ref)
        tol = max(3 * control, LL_REL_FLOOR * abs(ref))
        audit_ok = check("likelihood", f"{name} audit", err <= tol)
        del ll
        call_ms = cuda_ms(call, repeats=5)
        emit({"phase": "likelihood", "likelihood": name, "model": "lorenz",
              "interrogation": "kramer", "n_steps": n_ll, "n_lane": b_ll,
              "n_obs": 21, "launches": {k: v for k, v in got.items() if v},
              "finite": finite, "lane0": lane0,
              "audit_abs_err": err, "audit_ref": ref,
              "audit_control_abs_err": control, "audit_tol": tol,
              "audit_ok": audit_ok, "call_ms": call_ms,
              "per_eval_us": 1e3 * call_ms / b_ll, "peak_mem_bytes": peak})

    # K7b and K8 alone at these shapes, timed and checked against their twins
    ops_ll = fk._kernel_operands(thetas_ll, cfg_ll["ode_weight"], inits_ll,
                                 0.0, t_ll, n_ll, cfg_ll["prior_pars"])
    def chain_on_cpu(chain):
        """fenrir's backward operands (K7b's or K11b's) cut to one lane,
        on the CPU, for their twin's operation count."""
        A, b, C, d, y, om, mask, m_seed, p_seed, _ = chain
        return [cpu_lane(A), cpu_lane(b), cpu_lane(C), d.cpu(), y.cpu(),
                om.cpu(), mask.cpu(), cpu_lane(m_seed), cpu_lane(p_seed)]

    def grid_ops(mask, ops_at):
        """A kernel's float32 operations per lane over the steps of a grid
        whose mask is mask, as its twin does them: the twins of K8, K11c
        and K11b skip the observation update at a step without data.
        ops_at(idx) counts the twin's operations on the grid's steps idx.
        A step of each kind is the twin's operations on three steps less
        those on two, the third a step without data or the first with
        data; weighted by the grid's steps of each kind."""
        free = int((mask == 0).nonzero()[0])
        data = (mask != 0).nonzero().flatten().tolist()
        base = ops_at([free, free])
        per_free = ops_at([free] * 3) - base
        per_data = ops_at([free, free, data[0]]) - base if data else 0
        return per_free * (len(mask) - len(data)) + per_data * len(data)

    def dalton_ops(args_cpu, twin, keys=GRID_KEYS):
        """K8's or K11c's (with keys NN_GRID_KEYS, K9's or K11d's) float32
        operations per lane over the grid of args_cpu (its operands cut to
        one lane, on the CPU; those named in keys hold a row a step), as
        its twin, twin(n, operands), does them (grid_ops)."""
        def at(idx):
            rows = {k: (v[idx] if k in keys else v)
                    for k, v in args_cpu.items()}
            return op_count(lambda: twin(len(idx), rows))

        return grid_ops(args_cpu["mask"], at)

    def fenrir_ops(chain_cpu):
        """K7b's float32 operations per lane over its grid (chain_on_cpu's
        operands), as its twin, which skips the update at steps without
        data, does them (grid_ops)."""
        return grid_ops(chain_cpu[6], lambda idx: op_count(
            lambda: ff._fenrir_backward_plain(
                *[t[idx] for t in chain_cpu[:7]], *chain_cpu[7:],
                skip_unobserved=True)))

    def fenrir_tan_ops(chain_cpu):
        """K11b's float32 operations per lane over its grid (chain_on_cpu's
        operands), as its twin does them (grid_ops)."""
        return grid_ops(chain_cpu[6], lambda idx: op_count(
            lambda: ff._fenrir_backward_tan_plain(
                *[t[idx] for t in chain_cpu[:7]], *chain_cpu[7:], n_tan)))

    chain = fenrir_chain(n_ll, t_ll, ops_ll, obs_f)
    chain_cpu = chain_on_cpu(chain)
    _, entry = at_path_shapes(
        "likelihood", "fenrir_backward_batch", "pallas_fenrir.py:291",
        path_launches["fenrir"],
        rows_cut(ff.fenrir_backward_batch, fenrir_plain, chain, 7,
                 from_end=True), n_ll,
        ["ld"], None, None, chain,
        n_ops=b_ll * fenrir_ops(chain_cpu), out_bytes=4 * 3 * b_ll,
        shape=f"{n_ll} x {b_ll}",
        **split_record("likelihood", "fenrir_backward_batch",
                       "fenrir_backward_batch",
                       ff._fenrir_backward_batch_geometry(3, b_ll)))
    check("likelihood", "fenrir_backward_batch bitwise", entry["bitwise"])
    del chain, chain_cpu
    ops_d, obs_d, ld0_d = fd._dalton_prepare(
        thetas_ll, cfg_ll["ode_weight"], inits_ll, 0.0, t_ll, n_ll,
        cfg_ll["prior_pars"], *obs_f.values())
    lane_keys = ("x0_lanes", "theta_lanes", "ld0")
    for with_obs in (True, False):
        k8_args = dict(**ops_d, **obs_d, mode="kramer", with_obs=with_obs,
                       ld0=ld0_d if with_obs else torch.zeros_like(ld0_d))
        k8_cpu = cpu_lanes(k8_args, lane_keys)
        variant = "with_obs" if with_obs else "without_obs"
        # each launch of the DALTON value call is an entry of its own, with
        # its launches of the call, its time and its bound
        _, entry = at_path_shapes(
            "likelihood", "dalton_filter_batch", "pallas_dalton.py:41",
            {"dalton_filter_batch": k8_dalton[with_obs]},
            steps_cut(fd.dalton_filter_batch, fd._dalton_filter_plain, fused,
                      keys=GRID_KEYS, **k8_args), n_ll, ["ld"],
            None, None, tensors(k8_args), n_ops=b_ll * dalton_ops(
                k8_cpu, lambda n, a: fd._dalton_filter_plain(fused, n, **a)),
            key=f"dalton_filter_batch/{variant}",
            config=f"lorenz with_obs={with_obs}", shape=f"{n_ll} x {b_ll}",
            variant=variant, kernel_launches=path_launches["dalton"][
                "dalton_filter_batch"],
            **split_record(
                "likelihood", "dalton_filter_batch",
                f"dalton_filter_batch {variant}",
                fd._dalton_filter_batch_geometry("lorenz", b_ll,
                                                 with_obs=with_obs)))
        check("likelihood", f"dalton_filter_batch {variant} bitwise",
              entry["bitwise"])
    del k8_args, k8_cpu
    # K1 and K2r at these shapes, for the breakdown of the fenrir and basic
    # calls
    k1_ll_ms = device_ms(lambda: fk.fused_filter_batch(
        fused, n_ll, **ops_ll, mode="kramer"), repeats=5)
    G, g, L, mN, pN = fk.fused_filter_batch(fused, n_ll, **ops_ll,
                                            mode="kramer")
    k2r_ll_ms = device_ms(lambda: fk.smoother_recursion_batch_rows(
        g[1:], G[1:], L[1:], mN, pN, ops_ll["x0_lanes"], ops_ll["t_vec"],
        fk._tri_scale(ops_ll["t_vec"])), repeats=5)
    del G, g, L, mN, pN, ops_ll
    emit({"phase": "likelihood_kernels", "n_steps": n_ll, "n_lane": b_ll,
          "fenrir_backward_batch": kernels["fenrir_backward_batch"],
          "dalton_filter_batch": {
              v: kernels[f"dalton_filter_batch/{v}"]
              for v in ("with_obs", "without_obs")},
          "filter_batch_ms": k1_ll_ms, "smoother_batch_rows_ms": k2r_ll_ms})

    # ---- 10. the gradients at full width ---------------------------------
    cfg_fz, thetas_fz, inits_fz = lane_setup(fitzhugh, 200, 10.0, b_ll,
                                             bench_thetas)
    w_fz = torch.zeros((21, 2, 1, 3), device=dev)
    w_fz[..., 0] = 1.0
    # bench.py's MCMC fixture: every 10th of 200 steps, sigma 0.2
    obs_fz = dict(
        obs_data=torch.tensor(truth["y_fitz_mcmc"], dtype=torch.float32,
                              device=dev)[:, :, None],
        obs_times=torch.tensor((10.0 * np.arange(0, 201, 10) / 200)
                               .astype(np.float32)),
        obs_weight=w_fz,
        obs_var=torch.full((21, 2, 1, 1), np.float32(0.2 ** 2), device=dev))
    lanes_fz = dict(thetas=thetas_fz, ode_weight=cfg_fz["ode_weight"],
                    ode_inits=inits_fz, t_min=0.0, t_max=10.0, n_steps=200,
                    prior_pars=cfg_fz["prior_pars"], model="fitzhugh",
                    interrogation="kramer")
    basic_obs = dict(obs_data=obs_b["obs_data"], obs_times=obs_b["obs_times"],
                     obs_loglik=b_loglik)
    grad_paths = {
        # name: (grad call, value call, launches, truth key, steps)
        "fenrir": (lambda: ff.fenrir_fused_batch_grad(**lanes_ll, **obs_f),
                   lambda: ff.fenrir_fused_batch(**lanes_ll, **obs_f),
                   expect(filter_batch_tan=1, fenrir_backward_batch_tan=1),
                   n_ll),
        "dalton": (lambda: fd.dalton_fused_batch_grad(**lanes_ll, **obs_f),
                   lambda: fd.dalton_fused_batch(**lanes_ll, **obs_f),
                   expect(dalton_filter_batch_tan=2), n_ll),
        "basic": (lambda: fk.basic_fused_batch_grad(**lanes_ll, **basic_obs),
                  lambda: fk.basic_fused_batch(**lanes_ll, **basic_obs),
                  expect(filter_batch_tan=1, smoother_mean_batch_tan=1),
                  n_ll),
        "fenrir_fitz": (
            lambda: ff.fenrir_fused_batch_grad(**lanes_fz, **obs_fz),
            lambda: ff.fenrir_fused_batch(**lanes_fz, **obs_fz),
            expect(filter_batch_tan=1, fenrir_backward_batch_tan=1), 200),
    }
    grad_launches = {}
    # K11c's launches on each gradient path by with_obs, set to 0 with the
    # other counts
    k11c_by_obs = {}
    for name, (call, value_call, expected, n_g) in grad_paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with split_by_obs("dalton_filter_batch_tan", k11c_by_obs):
            out = call()
        torch.cuda.synchronize()
        got = read_counts()
        grad_launches[name] = got
        if name == "dalton":
            k11c_dalton = dict(k11c_by_obs)
            check("grad", "dalton launches by with_obs",
                  k11c_dalton == {True: 1, False: 1})
        peak = torch.cuda.max_memory_allocated()
        check("grad", f"{name} launches", got == expected)
        ll, grad = out[0], out[1]
        finite = check("grad", f"{name} finite",
                       tuple(ll.shape) == (b_ll,)
                       and tuple(grad.shape) == (b_ll, 3)
                       and torch.isfinite(ll).all().item()
                       and torch.isfinite(grad).all().item())
        values = value_call()
        if name == "basic":     # (loglik, mean) against (loglik, grad, mean)
            same = torch.equal(ll, values[0]) and torch.equal(out[2],
                                                              values[1])
        else:
            same = torch.equal(ll, values)
        same = check("grad", f"{name} values bitwise", same)
        del out, values
        ref = float(truth[f"{name}_ll"])
        control = abs(float(truth[f"{name}_ll_f32cpu"]) - ref)
        lane0 = float(ll[0])
        err = abs(lane0 - ref)
        tol = max(3 * control, LL_REL_FLOOR * abs(ref))
        ll_ok = check("grad", f"{name} value audit", err <= tol)
        g64 = np.asarray(truth[f"{name}_grad"], np.float64)
        g_ctrl = np.asarray(truth[f"{name}_grad_f32cpu"], np.float64)
        g_lane0 = grad[0].double().cpu().numpy()
        grad_rel = float(np.linalg.norm(g_lane0 - g64) / np.linalg.norm(g64))
        grad_control = float(np.linalg.norm(g_ctrl - g64)
                             / np.linalg.norm(g64))
        rounding = GRAD_THETA_ROUNDING.get(name)
        bench_tol = max(3 * grad_control, GRAD_FLOOR)
        if name == "fenrir_fitz":
            grad_tol = GRAD_FITZ_TOL
        elif max(grad_control, rounding or 0.0) > GRAD_CONTROL_MAX:
            grad_tol = None                 # unusable in float32
        else:
            grad_tol = bench_tol
        grad_ok = None if grad_tol is None else check(
            "grad", f"{name} gradient audit", grad_rel <= grad_tol)
        del ll, grad
        call_ms = cuda_ms(call, repeats=5)
        value_ms = cuda_ms(value_call, repeats=5)
        emit({"phase": "grad", "path": name,
              "model": "fitzhugh" if name == "fenrir_fitz" else "lorenz",
              "interrogation": "kramer", "n_steps": n_g, "n_lane": b_ll,
              "launches": {k: v for k, v in got.items() if v},
              "finite": finite, "values_bitwise": same,
              "lane0": lane0, "audit_abs_err": err, "audit_ref": ref,
              "audit_control_abs_err": control, "audit_tol": tol,
              "audit_ok": ll_ok, "grad_lane0": g_lane0.tolist(),
              "grad_ref": g64.tolist(), "grad_rel_err": grad_rel,
              "grad_control_rel_err": grad_control,
              "grad_theta_rounding_rel": rounding,
              "grad_bench_rule_tol": bench_tol,
              "grad_within_bench_rule": grad_rel <= bench_tol,
              "f32_unusable_on_any_hw": grad_tol is None,
              "grad_tol": grad_tol, "grad_ok": grad_ok, "call_ms": call_ms,
              "per_eval_us": 1e3 * call_ms / b_ll, "value_call_ms": value_ms,
              "ratio_to_value_call": call_ms / value_ms,
              "peak_mem_bytes": peak})

    # each tangent kernel alone at its path's shapes, timed and checked
    # against its twin there: Lorenz63 EK1 at 4000 steps x 2048 lanes, and
    # K11a and K11b on FitzHugh-Nagumo EK1 at 200 steps x 2048 lanes (these
    # launches come after the counts above were read)
    at_grad = {}                    # configuration -> entry, for this phase
    for model, n_g, lanes, obs in (("lorenz", n_ll, lanes_ll, obs_f),
                                   ("fitzhugh", 200, lanes_fz, obs_fz)):
        on_path = model == "lorenz"
        path = "fenrir" if on_path else "fenrir_fitz"
        fused_g = fk.resolve_model(model)
        ops_g = fk._kernel_operands(
            lanes["thetas"], lanes["ode_weight"], lanes["ode_inits"], 0.0,
            lanes["t_max"], n_g, lanes["prior_pars"])
        cpu_g = cpu_lanes(ops_g, ("x0_lanes", "theta_lanes"))
        out_a, at_grad[f"filter_batch_tan/{model}"] = at_path_shapes(
            "grad_kernels", "filter_batch_tan", "pallas_fenrir.py:614",
            grad_launches[path],
            steps_cut(fk.fused_filter_batch_tan, fk._filter_batch_tan_plain,
                      fused_g, **ops_g, mode="kramer"), n_g,
            k1_names, lambda n: fk._filter_batch_tan_plain(
                fused_g, n, **{**cpu_g, "tgrid": cpu_g["tgrid"][:n]},
                mode="kramer"),
            n_g * b_ll, tensors(ops_g), split=k11a_split,
            step_outputs=(0, 1, 2), register=on_path, config=model,
            source="filter_batch_tan.cuh", shape=f"{n_g} x {b_ll}",
            **split_record("grad_kernels", "filter_batch_tan",
                           f"filter_batch_tan {model}",
                           fk._filter_batch_tan_geometry(model, b_ll)))
        k1_out = fk.fused_filter_batch(fused_g, n_g, **ops_g, mode="kramer")
        entry = at_grad[f"filter_batch_tan/{model}"]
        entry["values_bitwise"] = all(
            torch.equal(a.narrow(a.dim() - 3, 0, k), v)
            for a, v, k in zip(out_a, k1_out, (9, 3, 6, 3, 6)))
        check("grad_kernels", f"filter_batch_tan {model} bitwise, values "
              "K1's", entry["bitwise"] and entry["values_bitwise"])
        del k1_out
        if on_path:
            A, b, _, mN, _ = out_a
            e_args = (b[1:], A[1:], mN)
            e_cpu = [cpu_lane(t) for t in e_args]
            _, at_grad["smoother_mean_batch_tan/lorenz"] = at_path_shapes(
                "grad_kernels", "smoother_mean_batch_tan",
                "pallas_kalman.py:1963", grad_launches["basic"],
                rows_cut(fk.smoother_mean_recursion_batch_tan,
                         fk._smoother_mean_tan_plain, (*e_args, n_tan), 2,
                         from_end=True),
                n_g - 1, ["ms"],
                lambda n: fk._smoother_mean_tan_plain(
                    e_cpu[0][:n], e_cpu[1][:n], e_cpu[2], n_tan),
                (n_g - 1) * b_ll, e_args, split=k11e_split, config=model,
                step_outputs=(0,),
                shape=f"{n_g - 1} x {b_ll}")
            del A, b, mN, e_args, e_cpu
        del out_a
        chain = ff._fenrir_operands(fused_g, n_g, 0.0, lanes["t_max"], ops_g,
                                    *obs.values(), "kramer", tangent=True)
        chain_cpu = chain_on_cpu(chain)
        # K11b's operations from its twin, which skips the update at steps
        # without data (as K11b does), weighted by the grid's steps
        _, entry = at_path_shapes(
            "grad_kernels", "fenrir_backward_batch_tan",
            "pallas_fenrir.py:772", grad_launches[path],
            rows_cut(ff.fenrir_backward_batch_tan, fenrir_tan_plain, chain,
                     7, from_end=True), n_g, ["ld"], None, None, chain,
            n_ops=b_ll * fenrir_tan_ops(chain_cpu), split=ld_split,
            out_bytes=4 * (1 + n_tan) * fused_g.n_block * b_ll,
            register=on_path, config=model,
            source="fenrir_backward_batch_tan.cuh", shape=f"{n_g} x {b_ll}",
            **split_record("grad_kernels", "fenrir_backward_batch_tan",
                           f"fenrir_backward_batch_tan {model}",
                           ff._fenrir_backward_batch_tan_geometry(
                               fused_g.n_block, b_ll, n_tan),
                           per_sm=on_path))
        at_grad[f"fenrir_backward_batch_tan/{model}"] = entry
        check("grad_kernels", f"fenrir_backward_batch_tan {model} bitwise",
              entry["bitwise"])
        del chain, chain_cpu, ops_g, cpu_g
    for with_obs in (True, False):
        k11c_args = dict(**ops_d, **obs_d, mode="kramer", with_obs=with_obs,
                         ld0=dalton_seed(ld0_d, with_obs))
        k11c_cpu = cpu_lanes(k11c_args, lane_keys)
        variant = "with_obs" if with_obs else "without_obs"
        # each launch of the DALTON gradient is an entry of its own, with
        # its launches of the gradient call, its time and its bound
        out_c, entry = at_path_shapes(
            "grad_kernels", "dalton_filter_batch_tan",
            "pallas_dalton.py:246",
            {"dalton_filter_batch_tan": k11c_dalton[with_obs]},
            steps_cut(fd.dalton_filter_batch_tan, fd._dalton_filter_tan_plain,
                      fused, keys=GRID_KEYS, **k11c_args), n_ll,
            ["ld"], None, None, tensors(k11c_args), split=ld_split,
            n_ops=b_ll * dalton_ops(
                k11c_cpu,
                lambda n, a: fd._dalton_filter_tan_plain(fused, n, **a)),
            key=f"dalton_filter_batch_tan/{variant}",
            config=f"lorenz with_obs={with_obs}", shape=f"{n_ll} x {b_ll}",
            variant=variant, kernel_launches=grad_launches["dalton"][
                "dalton_filter_batch_tan"],
            **split_record(
                "grad_kernels", "dalton_filter_batch_tan",
                f"dalton_filter_batch_tan {variant}",
                fd._dalton_filter_batch_tan_geometry("lorenz", b_ll,
                                                    with_obs=with_obs)))
        k8_ld = fd.dalton_filter_batch(
            fused, n_ll, **{**k11c_args, "ld0": k11c_args["ld0"][0]})
        entry["values_bitwise"] = torch.equal(out_c[0][0], k8_ld)
        check("grad_kernels", f"dalton_filter_batch_tan {variant} bitwise, "
              "values K8's", entry["bitwise"] and entry["values_bitwise"])
        at_grad[f"dalton_filter_batch_tan/lorenz/{variant}"] = entry
        del out_c, k8_ld
    del k11c_args, k11c_cpu, ops_d, obs_d, ld0_d
    emit({"phase": "grad_kernels", "n_lane": b_ll, "kernels": at_grad})

    # ---- 11. posterior path sampling ---------------------------------------
    n_sim, b_sim = 10000, 2048
    cfg_s, thetas_s, inits_s = lane_setup(lorenz, n_sim, 20.0, b_sim,
                                          bench_thetas)
    gen = torch.Generator(dev).manual_seed(6)

    def sim():
        return fs.solve_sim_fused_batch(
            thetas_s, cfg_s["ode_weight"], inits_s, 0.0, 20.0, n_sim,
            cfg_s["prior_pars"], model="lorenz", interrogation="kramer",
            generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    path = sim()
    torch.cuda.synchronize()
    sim_launches = read_counts()
    sim_peak = torch.cuda.max_memory_allocated()
    check("sim", "launches",
          sim_launches == expect(filter_batch=1, sampler_batch=1))
    sim_shape = check("sim", "shape",
                      tuple(path.shape) == (n_sim + 1, 3, 3, b_sim))
    sim_finite = check("sim", "finite", torch.isfinite(path).all().item())
    del path
    sim_ms = cuda_ms(sim, repeats=3)
    # K6 alone at these shapes
    ops_s = fk._kernel_operands(thetas_s, cfg_s["ode_weight"], inits_s, 0.0,
                                20.0, n_sim, cfg_s["prior_pars"])
    eps = torch.randn((n_sim - 1, 3, 3, b_sim), generator=gen, device=dev)
    eps_term = torch.randn((3, 3, b_sim), generator=gen, device=dev)
    k6_args = fs._draw_operands(fused, n_sim, ops_s, "kramer", eps,
                                eps_term)
    del eps, eps_term, ops_s
    k6_cpu = [cpu_lane(t) for t in k6_args]
    n_col_s = k6_args[2].shape[1] * b_sim
    _, entry = at_path_shapes(
        "sim", "sampler_batch", "pallas_sim.py:51", sim_launches,
        rows_cut(fs.sampler_batch, fs._sampler_batch_plain, k6_args, 2,
                 from_end=True), n_sim - 1, ["xs"],
        lambda n: fs._sampler_batch_plain(k6_cpu[0][:n], k6_cpu[1][:n],
                                          k6_cpu[2]),
        (n_sim - 1) * b_sim, k6_args, step_outputs=(0,),
        **split_record("sim", "sampler_batch", "sampler_batch",
                       fs._sampler_batch_geometry(n_col_s)))
    check("sim", "sampler_batch bitwise", entry["bitwise"])
    del k6_args, k6_cpu
    # the draws against the posterior: FitzHugh-Nagumo, one theta
    n_d, b_d = 800, 2048
    cfg_d, thetas_d, inits_d = lane_setup(
        fitzhugh, n_d, 10.0, b_d,
        lambda theta, n_lane: theta.expand(n_lane, 3).contiguous())
    args_d = (thetas_d, cfg_d["ode_weight"], inits_d, 0.0, 10.0, n_d,
              cfg_d["prior_pars"])
    draws = fs.solve_sim_fused_batch(
        *args_d, model="fitzhugh", interrogation="kramer",
        generator=torch.Generator(dev).manual_seed(7)).double()
    mean_d, var_d = fk.solve_mv_fused_batch(*args_d, model="fitzhugh",
                                            interrogation="kramer")
    _, where = fk._tri_idx(3)
    post_mean = mean_d[1:, ..., 0].double()
    post_var = var_d[1:, :, [where[(j, j)] for j in range(3)], 0].double()
    lane_mean = draws[1:].mean(-1)
    lane_var = draws[1:].var(-1)
    keep = post_var > SIM_VAR_MIN
    z = ((lane_mean - post_mean).abs() / (post_var / b_d).sqrt())[keep]
    ratio = (lane_var / post_var)[keep]
    z_max = z.max().item()
    ratio_range = (ratio.min().item(), ratio.max().item())
    dist_ok = check("sim", "draws against the posterior",
                    z_max <= SIM_Z and SIM_VAR_RATIO[0] <= ratio_range[0]
                    and ratio_range[1] <= SIM_VAR_RATIO[1])
    emit({"phase": "sim", "model": "lorenz", "interrogation": "kramer",
          "n_steps": n_sim, "n_lane": b_sim,
          "launches": {k: v for k, v in sim_launches.items() if v},
          "shape_ok": sim_shape, "finite": sim_finite, "call_ms": sim_ms,
          "per_draw_us": 1e3 * sim_ms / b_sim, "peak_mem_bytes": sim_peak,
          "sampler_batch": kernels["sampler_batch"],
          "distribution": {
              "model": "fitzhugh", "n_steps": n_d, "n_lane": b_d,
              "entries_checked": int(keep.sum().item()),
              "entries": int(keep.numel()), "var_min": SIM_VAR_MIN,
              "max_z": z_max, "z_tol": SIM_Z, "var_ratio": ratio_range,
              "var_ratio_tol": SIM_VAR_RATIO, "ok": dist_ok}})
    del draws, mean_d, var_d, post_mean, post_var, lane_mean, lane_var

    # ---- 12. the single-solve kernels and K2r against their twins ---------
    k3_names = ["mf", "pf", "mp", "pp"]

    def single_setup(mod, n, t_max_s, theta_of, prior_of=lambda p: p):
        """One solve's K3 operands and its float32 scaled transition, on the
        model's prior as prior_of changes it."""
        cfg_s1 = mod.setup(n_steps=n, t_max=t_max_s, dtype=torch.float32,
                           device=dev)
        return fk._single_operands(theta_of(cfg_s1["theta"]),
                                   cfg_s1["ode_weight"], cfg_s1["ode_init"],
                                   0.0, t_max_s, n,
                                   prior_of(cfg_s1["prior_pars"]))

    def twin_report(phase, config, names, kernel_out, twin_out,
                    need_bitwise=False, **info):
        kernel_out, twin_out = as_tuple(kernel_out), as_tuple(twin_out)
        errs = compare(names, kernel_out, twin_out)
        bitwise = all(torch.equal(a, b) for a, b in zip(kernel_out, twin_out))
        ok = check(phase, config, worst(errs)[1] <= TWIN_TOL
                   and (bitwise or not need_bitwise)
                   and all(torch.isfinite(a).all().item()
                           for a in kernel_out))
        emit({"phase": phase, "config": config, "n_steps": n_tw,
              "tol_scaled": TWIN_TOL, **info, "bitwise": bitwise,
              "errors": errs, "ok": ok})

    def one_theta(seed):
        return lambda theta: seeded_thetas(seed)(theta, 1)[0]

    k3_states = None
    for model, mode, t_max_tw, seed in (("lorenz", "kramer", 2.0, 10),
                                        ("fitzhugh", "rodeo", 10.0, 11)):
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        ops_m, Qs_m = single_setup(mod, n_tw, t_max_tw, one_theta(seed))
        fused_m = fk.resolve_model(model)
        out_k = fk.fused_filter(fused_m, n_tw, **ops_m, mode=mode)
        twin_report("k3_twin", f"{model}/{mode}", k3_names, out_k,
                    fk._filter_single_plain(fused_m, n_tw, **ops_m,
                                            mode=mode), need_bitwise=True)
        if k3_states is None:
            k3_states = (ops_m, Qs_m, out_k)
    ops_k3, Qs_k3, (mf, pf, mp, pp) = k3_states
    states = (mf[:-1], pf[:-1], mp[1:], pp[1:])
    rng = np.random.default_rng(13)
    G_s = np.eye(3).reshape(1, 1, 9) * 0.5 + \
        0.1 * rng.standard_normal((n_tw, 3, 9))
    A_s = rng.standard_normal((n_tw, 3, 3, 3))
    L_s = A_s @ np.swapaxes(A_s, -1, -2)
    seeded = [torch.tensor(a, dtype=torch.float32, device=dev).contiguous()
              for a in (rng.standard_normal((n_tw, 3, 3)), G_s,
                        np.stack([L_s[..., i, j] for i, j in pairs], -1),
                        rng.standard_normal((3, 3)),
                        np.abs(rng.standard_normal((3, len(pairs)))))]
    for source, args in (
            ("seeded", seeded),
            ("k3_gains", (*fk._smoother_gains(Qs_k3, ops_k3["prior_var"],
                                              *states), mf[-1], pf[-1]))):
        twin_report("k4_twin", source, ["ms", "ps"],
                    fk.smoother_recursion(*args),
                    fk._smoother_single_plain(*args), need_bitwise=True)
    ops_k3["q_const"] = ff._const_coefs(Qs_k3)
    chain_1 = ff._fenrir_single_operands(
        fused, n_tw, 0.0, 2.0, ops_k3, Qs_k3,
        *bench_obs(lorenz, 2.0, 11, 0).values(), "kramer")
    twin_report("k7a_twin", "lorenz/kramer", ["ld"],
                ff.fenrir_backward_single(*chain_1),
                chain_1[-1] + fd._block_sum(
                    ff._fenrir_backward_single_plain(*chain_1[:-1])),
                need_bitwise=True)
    del k3_states, ops_k3, mf, pf, mp, pp, states, seeded, chain_1

    # ---- 13. the single-solve path ------------------------------------------
    cfg_1 = lorenz.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float32,
                         device=dev)
    single = dict(theta=cfg_1["theta"], ode_weight=cfg_1["ode_weight"],
                  ode_init=cfg_1["ode_init"], t_min=0.0, t_max=t_max,
                  n_steps=n_steps, prior_pars=cfg_1["prior_pars"],
                  model="lorenz", interrogation="kramer")

    def solve_1(**kw):
        return fk.solve_mv_fused(**single, **kw)

    def audit_10k(mean_1):
        return max_err_prefix(mean_1.cpu().numpy(), truth["solve_mu_10k"],
                              n_prefix)

    # phase 5's audit rule for the 10 000-step solve
    control_1 = max_err_prefix(truth["solve_mu_10k_f32cpu"],
                               truth["solve_mu_10k"], n_prefix)
    tol_1 = max(3 * control_1, AUDIT_FLOOR)

    def peak_above_base(fn):
        """fn() and the most device memory it held at once beyond what
        was allocated before it (earlier phases' tensors)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    reset_counts()
    (mean_1, var_1), single_peak = peak_above_base(solve_1)
    single_launches = read_counts()
    check("single", "solve launches",
          single_launches == expect(filter_single=1, smoother_single=1))
    shape_1 = check("single", "solve shapes",
                    tuple(mean_1.shape) == (n_steps + 1, 3, 3)
                    and tuple(var_1.shape) == (n_steps + 1, 3, 3, 3))
    finite_1 = check("single", "solve finite",
                     torch.isfinite(mean_1).all().item()
                     and torch.isfinite(var_1).all().item())
    err_1 = audit_10k(mean_1)
    audit_1 = check("single", "solve audit", err_1 <= tol_1)
    del mean_1, var_1
    solve_1_ms = cuda_ms(solve_1, repeats=5)
    # the 16-step composed smoother: K4 over the groups' boundary steps
    reset_counts()
    mean_c = solve_1(k_compose=16)[0]
    composed_launches = read_counts()
    check("single", "composed solve launches",
          composed_launches == expect(filter_single=1, smoother_single=1))
    err_c = audit_10k(mean_c)
    audit_c = check("single", "composed solve audit", err_c <= tol_1)
    del mean_c
    composed_ms = cuda_ms(lambda: solve_1(k_compose=16), repeats=5)
    cfg_f1 = lorenz.setup(n_steps=n_ll, t_max=t_ll, dtype=torch.float32,
                          device=dev)
    fenrir_1 = dict(single, n_steps=n_ll, t_max=t_ll,
                    prior_pars=cfg_f1["prior_pars"], **obs_f)
    reset_counts()
    ll_1, fenrir_peak = peak_above_base(lambda: ff.fenrir_fused(**fenrir_1))
    fenrir_launches = read_counts()
    check("single", "fenrir launches", fenrir_launches == expect(
        filter_single=1, fenrir_backward_single=1))
    ll_ref = float(truth["fenrir_ll"])
    ll_control = abs(float(truth["fenrir_ll_f32cpu"]) - ll_ref)
    ll_err = abs(float(ll_1) - ll_ref)
    ll_tol = max(3 * ll_control, LL_REL_FLOOR * abs(ll_ref))
    ll_finite = check("single", "fenrir finite",
                      tuple(ll_1.shape) == () and bool(torch.isfinite(ll_1)))
    ll_ok = check("single", "fenrir audit", ll_err <= ll_tol)
    fenrir_1_ms = cuda_ms(lambda: ff.fenrir_fused(**fenrir_1), repeats=5)
    # the torch work around the kernels, in ATen operations per call
    calls_1 = {"solve": aten_calls(solve_1),
               "solve_k_compose_16": aten_calls(
                   lambda: solve_1(k_compose=16)),
               "fenrir": aten_calls(lambda: ff.fenrir_fused(**fenrir_1))}
    emit({"phase": "single", "model": "lorenz", "interrogation": "kramer",
          "solve": {"n_steps": n_steps, "t_max": t_max, "k_compose": 1,
                    "launches": {k: v for k, v in single_launches.items()
                                 if v},
                    "shapes_ok": shape_1, "finite": finite_1,
                    "audit_max_abs_err_t4": err_1,
                    "audit_control_f32cpu": control_1, "audit_tol": tol_1,
                    "audit_ok": audit_1, "call_ms": solve_1_ms,
                    "peak_mem_bytes_above_base": single_peak,
                    "k_compose_16": {
                        "launches": {k: v for k, v in
                                     composed_launches.items() if v},
                        "audit_max_abs_err_t4": err_c, "audit_ok": audit_c,
                        "call_ms": composed_ms}},
          "fenrir": {"n_steps": n_ll, "t_max": t_ll, "n_obs": 21,
                     "launches": {k: v for k, v in fenrir_launches.items()
                                  if v},
                     "finite": ll_finite, "value": float(ll_1),
                     "audit_abs_err": ll_err, "audit_ref": ll_ref,
                     "audit_control_abs_err": ll_control,
                     "audit_tol": ll_tol, "audit_ok": ll_ok,
                     "call_ms": fenrir_1_ms,
                     "peak_mem_bytes_above_base": fenrir_peak},
          "aten_calls_per_call": calls_1})

    # each kernel at its path's shapes (these launches come after the
    # counts above were read): K3 at 10 000 and at 4000 steps, K4 over the
    # plain smoother's 9999 rows and the composed one's boundary groups,
    # K7a at 4000 steps.  K3's record adds its launch, its time per step
    # and the SASS instructions of its step loop (the largest loop of each
    # instantiation, cuobjdump), which say whether the issue of the step's
    # instructions or their latency holds it.
    sass_3 = _build.sass_loops(SPLIT_KERNELS["filter_single"])
    k3_record = {
        **split_record("single", "filter_single", "filter_single lorenz",
                       fk._filter_single_geometry("lorenz", "kramer")),
        "sass_loop": "not measured" if sass_3 is None else sass_3}
    # K4's launch (a consumer and a producer warp, the blocks of the solve's
    # rows spread over lanes) and the SASS instructions of its stage loop
    sass_4 = _build.sass_loops(SLAB_KERNELS["smoother_single"])
    k4_record = {
        **split_record("single", "smoother_single", "smoother_single lorenz",
                       fk._smoother_single_geometry(lorenz.N_VARS)),
        "sass_loop": "not measured" if sass_4 is None else sass_4}

    def chain_bound(entry, kernel, n_rows, n_data=0):
        """A serial kernel's dependent-chain bound, beside its byte bound
        in entry: n_rows x CHAIN_OPS x FP32_LATENCY_CYCLES cycles at the SM
        clock's maximum (K7a's n_data steps with data at its second count,
        the others at its first), and the share of it the kernel
        reaches."""
        ops = CHAIN_OPS[kernel]
        free, data = ops if isinstance(ops, tuple) else (ops, ops)
        cycles = ((n_rows - n_data) * free + n_data * data) \
            * FP32_LATENCY_CYCLES
        chain_ms = 1e3 * cycles / (max_clock_mhz * 1e6)
        entry.update(chain_cycles_per_step=cycles / n_rows,
                     chain_bound_ms=chain_ms,
                     share_of_chain_bound=chain_ms / entry["ms"])
    at_single = {}
    for n_1, t_1, on_path, launches_1 in (
            (n_steps, t_max, True, single_launches),
            (n_ll, t_ll, False, fenrir_launches)):
        ops_1, Qs_1 = single_setup(lorenz, n_1, t_1, lambda th: th)
        if not on_path:      # fenrir_fused takes the float32 transition
            ops_1["q_const"] = ff._const_coefs(Qs_1)
        cpu_1 = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in ops_1.items()}
        out_3, at_single[f"filter_single/{n_1}"] = at_path_shapes(
            "single", "filter_single", "pallas_kalman.py:333", launches_1,
            steps_cut(fk.fused_filter, fk._filter_single_plain, fused,
                      **ops_1, mode="kramer"), n_1,
            k3_names, lambda n: fk._filter_single_plain(
                fused, n, **{**cpu_1, "tgrid": cpu_1["tgrid"][:n]},
                mode="kramer"),
            n_1, tensors(ops_1), register=on_path, config=f"{n_1} steps",
            step_outputs=(0, 1, 2, 3),
            source="filter_single.cuh", shape=f"{n_1} steps", **k3_record)
        entry_3 = at_single[f"filter_single/{n_1}"]
        entry_3["us_per_step"] = 1e3 * entry_3["ms"] / n_1
        chain_bound(entry_3, "filter_single", n_1)
        check("single", f"filter_single {n_1} steps bitwise",
              entry_3["bitwise"])
        mf, pf, mp, pp = out_3
        if on_path:
            states_1 = (mf[:-1], pf[:-1], mp[1:], pp[1:])
            comp, _ = fk._composed_suffixes(ops_1["q_const"],
                                            ops_1["prior_var"], *states_1,
                                            16)
            for gains, label, register in (
                    (fk._smoother_gains(Qs_1, ops_1["prior_var"], *states_1),
                     "rows", True),
                    (fk._boundary_operands(comp), "boundary groups of 16",
                     False)):
                k4_args = (*gains, mf[-1], pf[-1])
                k4_cpu = [a.cpu() for a in k4_args]
                n_rows = k4_args[0].shape[0]
                _, entry_4 = at_path_shapes(
                    "single", "smoother_single", "pallas_kalman.py:763",
                    launches_1,
                    rows_cut(fk.smoother_recursion,
                             fk._smoother_single_plain, k4_args, 3,
                             from_end=True), n_rows,
                    ["ms", "ps"], lambda n: fk._smoother_single_plain(
                        *[a[:n] for a in k4_cpu[:3]], *k4_cpu[3:]),
                    n_rows, k4_args, register=register, step_outputs=(0, 1),
                    config=f"{n_rows} {label}",
                    shape=f"{n_rows} {label}", **k4_record)
                at_single[f"smoother_single/{n_rows}"] = entry_4
                entry_4["us_per_row"] = 1e3 * entry_4["ms"] / n_rows
                chain_bound(entry_4, "smoother_single", n_rows)
                check("single", f"smoother_single {n_rows} {label} bitwise",
                      entry_4["bitwise"])
            del states_1, comp, gains, k4_args, k4_cpu, entry_4
        else:
            chain_1 = ff._fenrir_single_operands(
                fused, n_1, 0.0, t_1, ops_1, Qs_1, *obs_f.values(), "kramer")
            chain_cpu = [t.cpu() for t in chain_1[:9]]
            # the skipping twin's operations over the grid's steps with
            # data and without (grid_ops)
            ops_7 = grid_ops(chain_cpu[6], lambda idx: op_count(
                lambda: ff._fenrir_backward_single_plain(
                    *[t[idx] for t in chain_cpu[:7]], *chain_cpu[7:])))
            _, entry_7 = at_path_shapes(
                "single", "fenrir_backward_single", "pallas_fenrir.py:214",
                launches_1,
                rows_cut(ff.fenrir_backward_single, fenrir_single_plain,
                         chain_1, 7, from_end=True), n_1, ["ld"], None,
                None, chain_1, n_ops=ops_7, out_bytes=4 * 3,
                shape=f"{n_1} steps",
                **split_record("single", "fenrir_backward_single",
                               "fenrir_backward_single lorenz",
                               ff._fenrir_backward_single_geometry(
                                   lorenz.N_VARS)))
            at_single["fenrir_backward_single"] = entry_7
            entry_7["us_per_step"] = 1e3 * entry_7["ms"] / n_1
            chain_bound(entry_7, "fenrir_backward_single", n_1,
                        int((chain_cpu[6] != 0).sum()))
            check("single", f"fenrir_backward_single {n_1} steps bitwise",
                  entry_7["bitwise"])
            del chain_1, chain_cpu
        del out_3, mf, pf, mp, pp, ops_1, Qs_1, cpu_1
    emit({"phase": "single_kernels", "kernels": at_single})

    # ---- 14. the stationary solve's mean chain against its twins ---------
    def non_ibm(prior_pars):
        """A block-constant prior that is not IBM: IBM's weight with its
        last diagonal entry x 0.9 in every block, so that the scaled
        transition is not unit upper-triangular."""
        w, v = prior_pars
        w = w.clone()
        w[:, 2, 2] *= 0.9
        return w, v

    def mean_chain_operands(mod, model, mode, n, t_max_s, theta_of,
                            prior_of=lambda p: p):
        """The operands of K5a, K5b and K5c as solve_mv_fused_stationary
        builds them at n steps (K3's exact prefix and its gains, the tail
        after it), and K5a's with the frozen gain from the prefix's end over
        the tail."""
        ops_m, _ = single_setup(mod, n, t_max_s, theta_of, prior_of)
        fused_m = fk.resolve_model(model)
        n_warm, _ = fk._stationary_schedule(n, 64, True)
        mfw, _, _, ppw = fk.fused_filter(
            fused_m, n_warm, **{**ops_m, "tgrid": ops_m["tgrid"][:n_warm]},
            mode=mode)
        k_pre = fk._stationary_gains(fused_m, ops_m, ppw, mode, 0.0)
        k_star, tail = k_pre[-1], ops_m["tgrid"][n_warm:]
        chain = (fused_m, ops_m["q_const"], ops_m["ode_weight"],
                 ops_m["t_vec"])
        frozen = k_star.expand(n - n_warm, *k_star.shape)
        return dict(
            gain=(*chain, ops_m["x0"], ops_m["theta"], ops_m["tgrid"],
                  torch.cat([k_pre, frozen])),
            boundary=(*chain, mfw[-1], ops_m["theta"], tail, k_star),
            constant=(*chain, mfw[-1], ops_m["theta"], tail,
                      frozen.contiguous()))

    def recovery_args(boundary, bnd):
        """K5c's operands: K5b's, its output in place of the start."""
        return (*boundary[:4], bnd, *boundary[5:])

    # the scaled IBM prior (a unit upper-triangular transition) on both
    # models, and Lorenz63 on a prior that is not IBM
    for model, mode, t_max_tw, seed, prior in (
            ("lorenz", "kramer", 2.0, 10, "ibm"),
            ("fitzhugh", "rodeo", 10.0, 11, "ibm"),
            ("lorenz", "kramer", 2.0, 12, "non_ibm")):
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        args_5 = mean_chain_operands(
            mod, model, mode, n_tw, t_max_tw, one_theta(seed),
            non_ibm if prior == "non_ibm" else lambda p: p)
        label = f"{model}/{mode}" + (" non_ibm" if prior == "non_ibm"
                                     else "")
        twin_report("k5_twin", f"{label} mean_gain_single", ["mf"],
                    fk.mean_gain_chain(*args_5["gain"]),
                    fk._mean_gain_plain(*args_5["gain"]), need_bitwise=True)
        bnd = fk.mean_boundary_chain(*args_5["boundary"])
        twin_report("k5_twin", f"{label} mean_boundary_single",
                    ["bnd"], bnd,
                    fk._mean_boundary_plain(*args_5["boundary"], 64),
                    need_bitwise=True)
        rec = recovery_args(args_5["boundary"], bnd)
        rows = fk.mean_recovery_chain(*rec)
        twin_report("k5_twin", f"{label} mean_recovery_single",
                    ["mf"], rows, fk._mean_recovery_plain(*rec),
                    need_bitwise=True)
        # K5b + K5c are K5a with the frozen gain from the same start
        ref_5 = fk.mean_gain_chain(*args_5["constant"])
        twin_report("k5_twin", f"{label} K5b + K5c against K5a",
                    ["mf"], rows, ref_5, n_group=bnd.shape[0])
        check("k5_twin", f"{label} K5b + K5c bitwise K5a",
              torch.equal(rows, ref_5))
    del args_5, bnd, rec, rows, ref_5

    # ---- 15. the stationary-gain single solve ------------------------------
    def stationary_1(**kw):
        return fk.solve_mv_fused_stationary(**single, **kw)

    path_5 = expect(filter_single=1, mean_boundary_single=1,
                    mean_recovery_single=1, smoother_single=1)
    reset_counts()
    (mean_s, var_s), stat_peak = peak_above_base(stationary_1)
    stat_launches = read_counts()
    check("stationary", "launches", stat_launches == path_5)
    shape_s = check("stationary", "shapes",
                    tuple(mean_s.shape) == (n_steps + 1, 3, 3)
                    and tuple(var_s.shape) == (n_steps + 1, 3, 3, 3))
    finite_s = check("stationary", "finite",
                     torch.isfinite(mean_s).all().item()
                     and torch.isfinite(var_s).all().item())
    err_s = audit_10k(mean_s)
    audit_s = check("stationary", "audit", err_s <= tol_1)
    del mean_s, var_s
    # the two paths in turns, on the same card
    exact_ms = cuda_ms(solve_1, repeats=5)
    stat_ms = cuda_ms(stationary_1, repeats=5)
    stat_ms_2 = cuda_ms(stationary_1, repeats=5)
    exact_ms_2 = cuda_ms(solve_1, repeats=5)
    # the JAX package's smoother, the 64-step composition, once
    reset_counts()
    mean_c64, c64_ms = cuda_once(lambda: stationary_1(k_compose=64)[0])
    c64_launches = read_counts()
    check("stationary", "k_compose=64 launches", c64_launches == path_5)
    err_c64 = audit_10k(mean_c64)
    audit_c64 = check("stationary", "k_compose=64 audit", err_c64 <= tol_1)
    del mean_c64
    # a short horizon at the same step: one 64-step group, so K5a
    n_short = 150
    t_short = t_max * n_short / n_steps
    cfg_sh = lorenz.setup(n_steps=n_short, t_max=t_short,
                          dtype=torch.float32, device=dev)
    short = dict(single, n_steps=n_short, t_max=t_short,
                 prior_pars=cfg_sh["prior_pars"])
    reset_counts()
    mean_sh = fk.solve_mv_fused_stationary(**short)[0]
    short_launches = read_counts()
    check("stationary", "short launches", short_launches == expect(
        filter_single=1, mean_gain_single=1, smoother_single=1))
    finite_sh = check("stationary", "short finite",
                      torch.isfinite(mean_sh).all().item())
    # the audit rule on the truth's first rows, which lie on this grid
    err_sh = max_err_prefix(mean_sh.cpu().numpy(), truth["solve_mu_10k"],
                            n_short + 1)
    tol_sh = max(3 * max_err_prefix(truth["solve_mu_10k_f32cpu"],
                                    truth["solve_mu_10k"], n_short + 1),
                 AUDIT_FLOOR)
    audit_sh = check("stationary", "short audit", err_sh <= tol_sh)
    del mean_sh
    short_ms = cuda_ms(lambda: fk.solve_mv_fused_stationary(**short),
                       repeats=5)
    # the square-root form: the prior's variance given as a factor, against
    # the standard form on the squared factor (the operations then match)
    w_1, v_1 = single["prior_pars"]
    factor_1 = torch.linalg.cholesky(v_1.double()).float()
    mean_q, fac_q = fk.solve_mv_fused_stationary(
        **dict(single, prior_pars=(w_1, factor_1)), kalman_type="sqrt")
    mean_e, var_e = fk.solve_mv_fused_stationary(**dict(
        single, prior_pars=fk.normalize_prior_pars("sqrt", (w_1, factor_1))))
    gram_err = ((fac_q @ fac_q.mT - var_e).abs().max()
                / var_e.abs().max()).item()
    sqrt_means = check("stationary", "sqrt means bitwise",
                       torch.equal(mean_q, mean_e))
    sqrt_factors = check("stationary", "sqrt factors",
                         gram_err <= SQRT_GRAM_TOL and bool(
                             (fac_q.triu(1) == 0).all()))
    del mean_q, fac_q, mean_e, var_e
    # and DALTON's value on the likelihood fixture's first 64 lanes, the
    # observation variance a factor too
    w_ll, v_ll = cfg_ll["prior_pars"]
    factor_ll = torch.linalg.cholesky(v_ll.double()).float()
    lanes_q = dict(lanes_ll, thetas=thetas_ll[:64], ode_inits=inits_ll[:64])
    om_factor = obs_f["obs_var"].sqrt()
    ll_q = fd.dalton_fused_batch(**dict(
        lanes_q, prior_pars=(w_ll, factor_ll), obs_var=om_factor),
        obs_data=obs_f["obs_data"], obs_times=obs_f["obs_times"],
        obs_weight=obs_f["obs_weight"], kalman_type="sqrt")
    ll_e = fd.dalton_fused_batch(**dict(
        lanes_q, prior_pars=fk.normalize_prior_pars(
            "sqrt", (w_ll, factor_ll)),
        obs_var=fk.normalize_meas_var("sqrt", om_factor)),
        obs_data=obs_f["obs_data"], obs_times=obs_f["obs_times"],
        obs_weight=obs_f["obs_weight"])
    sqrt_ll = check("stationary", "sqrt dalton value bitwise",
                    torch.equal(ll_q, ll_e)
                    and torch.isfinite(ll_q).all().item())
    emit({"phase": "stationary", "model": "lorenz", "interrogation": "kramer",
          "n_steps": n_steps, "t_max": t_max,
          "schedule": fk._stationary_schedule(n_steps, 64, True),
          "launches": {k: v for k, v in stat_launches.items() if v},
          "shapes_ok": shape_s, "finite": finite_s,
          "audit_max_abs_err_t4": err_s, "audit_tol": tol_1,
          "audit_ok": audit_s, "call_ms": [stat_ms, stat_ms_2],
          "solve_mv_fused_call_ms": [exact_ms, exact_ms_2],
          "ratio_to_solve_mv_fused": (stat_ms + stat_ms_2)
          / (exact_ms + exact_ms_2),
          "peak_mem_bytes_above_base": stat_peak,
          "aten_calls_per_call": aten_calls(stationary_1),
          "k_compose_64": {
              "launches": {k: v for k, v in c64_launches.items() if v},
              "audit_max_abs_err_t4": err_c64, "audit_ok": audit_c64,
              "one_call_ms": c64_ms},
          "short": {"n_steps": n_short, "t_max": t_short,
                    "launches": {k: v for k, v in short_launches.items()
                                 if v},
                    "finite": finite_sh, "audit_max_abs_err": err_sh,
                    "audit_tol": tol_sh, "audit_ok": audit_sh,
                    "call_ms": short_ms},
          "sqrt": {"means_bitwise": sqrt_means, "gram_err": gram_err,
                   "gram_tol": SQRT_GRAM_TOL, "factors_ok": sqrt_factors,
                   "dalton_64_lanes_bitwise": sqrt_ll}})

    # ---- 16. the mean-chain kernels at their paths' shapes ----------------
    # (these launches come after the counts above were read): K5b and K5c on
    # the 10 000-step solve's tail, K5a on the short horizon's 150 steps
    at_stat = {}
    long_5 = mean_chain_operands(lorenz, "lorenz", "kramer", n_steps, t_max,
                                 lambda th: th)["boundary"]
    short_5 = mean_chain_operands(lorenz, "lorenz", "kramer", n_short,
                                  t_short, lambda th: th)["gain"]
    long_cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
                for a in long_5]
    short_cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in short_5]
    n_tail = long_5[6].shape[0]
    n_group_5 = n_tail // 64

    def k5_record(kernel, geometry):
        """A mean-chain kernel's launch as the card reports it (K5b a thread
        per block of the solve, K5c per (group, block), K5a a consumer and
        a producer warp), ptxas' report and the SASS instructions of its
        step loop."""
        sass = _build.sass_loops({**SPLIT_KERNELS, **SLAB_KERNELS}[kernel])
        return {**split_record("stationary_kernels", kernel,
                               f"{kernel} lorenz", geometry),
                "sass_loop": "not measured" if sass is None else sass}
    k5b_record = k5_record("mean_boundary_single",
                           fk._mean_boundary_geometry("lorenz"))
    k5c_record = k5_record("mean_recovery_single",
                           fk._mean_recovery_geometry("lorenz", n_group_5))
    k5a_record = k5_record("mean_gain_single",
                           fk._mean_gain_geometry("lorenz"))
    bnd, at_stat["mean_boundary_single"] = at_path_shapes(
        "stationary_kernels", "mean_boundary_single", "pallas_kalman.py:2234",
        stat_launches,
        groups_cut(fk.mean_boundary_chain,
                   lambda *a: fk._mean_boundary_plain(*a, 64), long_5),
        n_tail, ["bnd"],
        lambda n: fk._mean_boundary_plain(*long_cpu[:6], long_cpu[6][:n],
                                          long_cpu[7], 1),
        n_tail, tensors(dict(enumerate(long_5))),
        source="mean_chain_single.cu", shape=f"{n_tail} steps", **k5b_record)
    at_stat["mean_boundary_single"]["us_per_step"] = \
        1e3 * at_stat["mean_boundary_single"]["ms"] / n_tail
    check("stationary_kernels", "mean_boundary_single bitwise",
          at_stat["mean_boundary_single"]["bitwise"])
    rec_5 = recovery_args(long_5, bnd[0])
    rec_cpu = recovery_args(long_cpu, bnd[0][:1].cpu())
    _, at_stat["mean_recovery_single"] = at_path_shapes(
        "stationary_kernels", "mean_recovery_single", "pallas_kalman.py:2271",
        stat_launches,
        groups_cut(fk.mean_recovery_chain, fk._mean_recovery_plain, rec_5,
                   bnd_at=4), n_tail, ["mf"],
        lambda n: fk._mean_recovery_plain(*rec_cpu[:6], rec_cpu[6][:n],
                                          rec_cpu[7]),
        n_tail, tensors(dict(enumerate(rec_5))),
        source="mean_chain_single.cu",
        shape=f"{bnd[0].shape[0]} groups of 64", **k5c_record)
    _, at_stat["mean_gain_single"] = at_path_shapes(
        "stationary_kernels", "mean_gain_single", "pallas_kalman.py:2197",
        short_launches,
        rows_cut(fk.mean_gain_chain, fk._mean_gain_plain, short_5, (6, 7)),
        n_short, ["mf"],
        lambda n: fk._mean_gain_plain(*short_cpu[:6], short_cpu[6][:n],
                                      short_cpu[7][:n]),
        n_short, tensors(dict(enumerate(short_5))),
        source="mean_chain_single.cu", shape=f"{n_short} steps",
        step_outputs=(0,), **k5a_record)
    for kernel in ("mean_recovery_single", "mean_gain_single"):
        check("stationary_kernels", f"{kernel} bitwise",
              at_stat[kernel]["bitwise"])
    # K5c's groups run in parallel: its chain is one group's steps
    k_group = n_tail // bnd[0].shape[0]
    for kernel, n_rows in (("mean_boundary_single", n_tail),
                           ("mean_recovery_single", k_group),
                           ("mean_gain_single", n_short)):
        chain_bound(at_stat[kernel], kernel, n_rows)
    del long_5, short_5, long_cpu, short_cpu, bnd, rec_5, rec_cpu
    emit({"phase": "stationary_kernels", "kernels": at_stat})

    # ---- 17. the MAGI kernels against their twins -------------------------
    mu4k = torch.tensor(truth["solve_mu_4k"], dtype=torch.float32,
                        device=dev)
    dt_mg = 20.0 / 4000
    cfg_mg = lorenz.setup(n_steps=4000, t_max=20.0, dtype=torch.float32,
                          device=dev)

    def magi_expand(u):
        return torch.cat([u, torch.zeros_like(u[..., :1])], -1)

    def magi_twin(x, R, m0, q_const, mode):
        """K10a's twin, its blocks' sums added as the wrapper adds them."""
        out = fm._magi_batch_plain(x, R, m0, q_const, mode)
        if mode == "ld":
            return fd._block_sum(out)
        return (fd._block_sum(out[0]),) + tuple(
            a for a in out[1:] if a is not None)

    def magi_streams(out, act):
        """K10b's stream operands from K10a's adjoint outputs."""
        return out[1:] if act < 3 else (*out[1:], None)

    k10a_names = ["ld", "z", "s_inv", "G"]
    rng = np.random.default_rng(14)
    subs_tw = mu4k[:n_tw + 1, :, :2][None] + torch.tensor(
        0.1 * rng.standard_normal((b_tw, n_tw + 1, 3, 2)),
        dtype=torch.float32, device=dev)
    sig2_tw = torch.tensor(rng.uniform(0.5, 2.0, b_tw), dtype=torch.float32,
                           device=dev)
    # the prior's process noise x 1e-5: at the Lorenz63 prior's own scale
    # (sigma 5e7) the determinant of a 3 x 3 forecast variance overflows
    # float32, in the kernel, its twin and the JAX package alike
    wgt_mg, var_mg = cfg_mg["prior_pars"]
    prior_tight = (wgt_mg, var_mg * 1e-5)
    for act, sig2 in ((1, None), (2, None), (3, None), (2, sig2_tw)):
        q_mg, _, R_tw, x_tw, m0_tw = fm._magi_operands(
            magi_expand(subs_tw), act, prior_tight, dt_mg, sig2)
        config = f"n_active={act}" + ("/sig2_lanes" if sig2 is not None
                                      else "")
        for mode in ("ld", "adjoint"):
            out_k = as_tuple(fm.magi_filter_batch(x_tw, R_tw, m0_tw, q_mg,
                                                  emit=mode))
            out_p = as_tuple(magi_twin(x_tw, R_tw, m0_tw, q_mg, mode))
            twin_report("k10_twin", f"magi_batch {config} emit={mode}",
                        k10a_names[:len(out_k)], out_k, out_p,
                        need_bitwise=True, n_lane=b_tw)
        streams = magi_streams(out_k, act)
        twin_report("k10_twin", f"magi_adjoint_batch {config}",
                    ["gx", "lam0"], fm.magi_adjoint_batch(*streams, q_mg),
                    fm._magi_adjoint_batch_plain(*streams, q_mg),
                    need_bitwise=True, n_lane=b_tw)
    del subs_tw, sig2_tw, R_tw, x_tw, m0_tw, out_k, out_p, streams

    # ---- 18. MAGI at full width --------------------------------------------
    n_mg, b_mg = 4000, 2048
    lanes_mg = torch.arange(b_mg, dtype=torch.float32, device=dev)
    # bench.py's lane batch: the cached path + 1e-4 x lane index
    subs_mg = mu4k[None, :n_mg + 1, :, :2] + \
        1e-4 * lanes_mg[:, None, None, None]
    magi_args = (subs_mg, magi_expand, 2, cfg_mg["prior_pars"], dt_mg)

    def magi_value():
        return fm.magi_fused_batch(*magi_args)

    def magi_grad():
        return fm.magi_fused_batch_grad(*magi_args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ld_mg = magi_value()
    torch.cuda.synchronize()
    magi_launches = read_counts()
    magi_peak = torch.cuda.max_memory_allocated()
    check("magi", "value launches", magi_launches == expect(magi_batch=1))
    mg_finite = check("magi", "value finite",
                      tuple(ld_mg.shape) == (b_mg,)
                      and torch.isfinite(ld_mg).all().item())
    mg_ref = float(truth["magi_ll"])
    mg_control = abs(float(truth["magi_ll_f32cpu"]) - mg_ref)
    mg_lane0 = float(ld_mg[0])
    mg_err = abs(mg_lane0 - mg_ref)
    mg_tol = max(3 * mg_control, LL_REL_FLOOR * abs(mg_ref))
    mg_audit = check("magi", "value audit", mg_err <= mg_tol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ld_g, g_mg = magi_grad()
    torch.cuda.synchronize()
    magi_grad_launches = read_counts()
    magi_grad_peak = torch.cuda.max_memory_allocated()
    check("magi", "gradient launches", magi_grad_launches == expect(
        magi_batch=1, magi_adjoint_batch=1))
    g_finite = check("magi", "gradient finite",
                     tuple(g_mg.shape) == tuple(subs_mg.shape)
                     and torch.isfinite(g_mg).all().item())
    mg_same = check("magi", "values bitwise", torch.equal(ld_g, ld_mg))
    # bench.py's gradient audit at lane 1 (the path + 1e-4)
    g64 = np.asarray(truth["magi_grad"], np.float64)
    g_ctrl = np.asarray(truth["magi_grad_f32cpu"], np.float64)
    g_lane1 = g_mg[1].double().cpu().numpy()
    mg_grad_rel = float(np.linalg.norm(g_lane1 - g64) / np.linalg.norm(g64))
    mg_grad_control = float(np.linalg.norm(g_ctrl - g64)
                            / np.linalg.norm(g64))
    mg_bench_tol = max(3 * mg_grad_control, GRAD_FLOOR)
    mg_unusable = mg_grad_control > GRAD_CONTROL_MAX
    mg_grad_ok = None if mg_unusable else check(
        "magi", "gradient audit", mg_grad_rel <= mg_bench_tol)
    del ld_mg, ld_g, g_mg, g_lane1
    value_mg_ms = cuda_ms(magi_value, repeats=5)
    grad_mg_ms = cuda_ms(magi_grad, repeats=5)
    # the informative check: rough lanes at a tight prior, against the
    # float64 torch-op on the CPU (one thread: its operations are tiny)
    cfg64 = lorenz.setup(n_steps=n_mg, t_max=20.0, dtype=torch.float64,
                         device="cpu")
    wgt64, var64 = cfg64["prior_pars"]
    prior_inf = (wgt64, var64 * 1e-5)
    rng = np.random.default_rng(3)
    base = truth["solve_mu_4k"][:, :, :2]
    subs_inf = torch.tensor(np.stack([
        base + 0.1 * (i + 1) * rng.normal(size=base.shape)
        for i in range(4)]))
    ld_inf, g_inf = fm.magi_fused_batch_grad(
        subs_inf.to(dev, torch.float32), magi_expand, 2, prior_inf, dt_mg)
    ld_inf, g_inf = ld_inf.double().cpu(), g_inf.double().cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        g_ref, ld_ref = torch.func.vmap(torch.func.grad_and_value(
            lambda u: tprecond.magi_logdens(u, magi_expand, 2, prior_inf,
                                            dt_mg)))(subs_inf)
    finally:
        torch.set_num_threads(threads)
    ref_s = time.perf_counter() - t0
    inf_value_rel = ((ld_inf - ld_ref) / ld_ref).abs().max().item()
    inf_grad_err = max(
        ((g_inf[i] - g_ref[i]).abs().max()
         / (g_ref[i].abs().max() + 1.0)).item() for i in range(4))
    inf_ok = check("magi", "informative check against float64",
                   inf_value_rel <= MAGI_F64_TOL
                   and inf_grad_err <= MAGI_F64_TOL)
    emit({"phase": "magi", "model": "lorenz", "n_steps": n_mg,
          "n_lane": b_mg, "n_active": 2, "dt": dt_mg,
          "value": {"launches": {k: v for k, v in magi_launches.items()
                                 if v},
                    "finite": mg_finite, "lane0": mg_lane0,
                    "audit_abs_err": mg_err, "audit_ref": mg_ref,
                    "audit_control_abs_err": mg_control,
                    "audit_tol": mg_tol, "audit_ok": mg_audit,
                    "call_ms": value_mg_ms,
                    "per_eval_us": 1e3 * value_mg_ms / b_mg,
                    "peak_mem_bytes": magi_peak},
          "grad": {"launches": {k: v for k, v in magi_grad_launches.items()
                                if v},
                   "finite": g_finite, "values_bitwise": mg_same,
                   "grad_lane": 1, "grad_rel_err": mg_grad_rel,
                   "grad_control_rel_err": mg_grad_control,
                   "grad_bench_rule_tol": mg_bench_tol,
                   "grad_within_bench_rule": mg_grad_rel <= mg_bench_tol,
                   "f32_unusable_on_any_hw": mg_unusable,
                   "grad_ok": mg_grad_ok, "call_ms": grad_mg_ms,
                   "per_eval_us": 1e3 * grad_mg_ms / b_mg,
                   "ratio_to_value_call": grad_mg_ms / value_mg_ms,
                   "peak_mem_bytes": magi_grad_peak},
          "informative": {"n_lane": 4, "prior_var_scale": 1e-5,
                          "value_rel_err": inf_value_rel,
                          "grad_err": inf_grad_err, "tol": MAGI_F64_TOL,
                          "ok": inf_ok, "lane_values": ld_inf.tolist(),
                          "f64_reference_s": ref_s}})
    del subs_inf, ld_inf, g_inf, g_ref, ld_ref

    # ---- 19. the MAGI kernels at the path's shapes ------------------------
    # (these launches come after the counts above were read)
    q_mg, _, R_mg, x_mg, m0_mg = fm._magi_operands(
        magi_expand(subs_mg), 2, cfg_mg["prior_pars"], dt_mg, None)
    mg_cpu = (cpu_lane(x_mg), R_mg.cpu(), cpu_lane(m0_mg))
    at_magi = {}
    for mode, launches_mg in (("adjoint", magi_grad_launches),
                              ("ld", magi_launches)):
        out_mg, entry = at_path_shapes(
            "magi_kernels", "magi_batch", "pallas_magi.py:62", launches_mg,
            rows_cut(functools.partial(fm.magi_filter_batch, emit=mode),
                     functools.partial(magi_twin, mode=mode),
                     (x_mg, R_mg, m0_mg, q_mg), 1), n_mg,
            k10a_names[:4 if mode == "adjoint" else 1],
            lambda n: fm._magi_batch_plain(mg_cpu[0][:n], *mg_cpu[1:], q_mg,
                                           mode),
            n_mg * b_mg, (x_mg, R_mg, m0_mg), register=mode == "ld",
            config=f"emit={mode}", emit=mode, shape=f"{n_mg} x {b_mg}",
            **split_record("magi_kernels", "magi_batch",
                           f"magi_batch emit={mode}",
                           fm._magi_batch_geometry(3, b_mg, 2, mode)))
        at_magi[f"magi_batch/{mode}"] = entry
        entry["us_per_step"] = 1e3 * entry["ms"] / n_mg
        chain_bound(entry, "magi_batch", n_mg)
        check("magi_kernels", f"magi_batch emit={mode} bitwise",
              entry["bitwise"])
        if mode == "adjoint":
            streams_mg = magi_streams(out_mg, 2)
    kernels["magi_batch"]["emit_adjoint"] = {
        k: at_magi["magi_batch/adjoint"][k]
        for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                  "work", "max_abs_err", "max_scaled_err", "bitwise",
                  "launches", "chain_bound_ms", "share_of_chain_bound",
                  "geometry")}
    del out_mg
    streams_cpu = [cpu_lane(t) for t in streams_mg]
    _, at_magi["magi_adjoint_batch"] = at_path_shapes(
        "magi_kernels", "magi_adjoint_batch", "pallas_magi.py:319",
        magi_grad_launches,
        rows_cut(fm.magi_adjoint_batch, fm._magi_adjoint_batch_plain,
                 (*streams_mg, q_mg), len(streams_mg), from_end=True), n_mg,
        ["gx", "lam0"],
        lambda n: fm._magi_adjoint_batch_plain(
            *[t[:n] for t in streams_cpu], q_mg),
        n_mg * b_mg, streams_mg, shape=f"{n_mg} x {b_mg}", step_outputs=(0,),
        **split_record("magi_kernels", "magi_adjoint_batch",
                       "magi_adjoint_batch",
                       fm._magi_adjoint_batch_geometry(3, b_mg, 2)))
    chain_bound(at_magi["magi_adjoint_batch"], "magi_adjoint_batch", n_mg)
    at_magi["magi_adjoint_batch"]["us_per_step"] = \
        1e3 * at_magi["magi_adjoint_batch"]["ms"] / n_mg
    check("magi_kernels", "magi_adjoint_batch bitwise",
          at_magi["magi_adjoint_batch"]["bitwise"])
    del streams_mg, streams_cpu, x_mg, R_mg, m0_mg, subs_mg
    emit({"phase": "magi_kernels", "n_steps": n_mg, "n_lane": b_mg,
          "kernels": at_magi})


    # ---- 20. K9 and K11d against their twins -----------------------------
    nn_names = ["mf", "pf", "mp", "pp"]
    nn_split = [(3, 1), (6, 1), (3, 1), (6, 1)]
    for model, mode, t_max_nn, obs_nn in (
            ("lorenz", "kramer", 2.0, obs_models.gauss(0.005)),
            ("fitzhugh", "rodeo", 10.0, obs_models.poisson(0.1, 0.05))):
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        cfg_nn, thetas_nn, inits_nn = lane_setup(mod, n_tw, t_max_nn, b_tw,
                                                 seeded_thetas(15))
        rng = np.random.default_rng(16)
        nb_nn = mod.N_VARS
        # 21 observations: every 50th step
        y_nn = (rng.normal(size=(21, nb_nn, 1)) * 5 if model == "lorenz"
                else rng.poisson(2.0, size=(21, nb_nn, 1)))
        ops_nn, grid_nn, _, _ = fdn._daltonng_prepare(
            thetas_nn, cfg_nn["ode_weight"], inits_nn, 0.0, t_max_nn, n_tw,
            cfg_nn["prior_pars"], torch.tensor(y_nn, dtype=torch.float32),
            torch.tensor(np.linspace(0.0, t_max_nn, 21)))
        fused_nn = fk.resolve_model(model)
        args_nn = (fused_nn, obs_nn, (0,), n_tw)
        kw_nn = dict(**ops_nn, **grid_nn, mode=mode)
        config = f"{model}/{mode}/{obs_nn.cuda_functor}"
        out_k = fdn.filter_nn_batch(*args_nn, **kw_nn)
        twin_report("k9_twin", f"filter_nn_batch {config}", nn_names, out_k,
                    fdn._filter_nn_batch_plain(*args_nn, **kw_nn),
                    need_bitwise=True, n_lane=b_tw)
        tan_k = fdn.filter_nn_batch_tan(*args_nn, **kw_nn)
        tan_p = fdn._filter_nn_batch_tan_plain(*args_nn, **kw_nn)
        torch.cuda.synchronize()
        errs = twin_errors(nn_names, tan_k, tan_p, nn_split)
        values_k9 = all(torch.equal(a[:, :k], v)
                        for a, v, (k, _) in zip(tan_k, out_k, nn_split))
        bitwise = all(torch.equal(a, b) for a, b in zip(tan_k, tan_p))
        ok = check("k9_twin", f"filter_nn_batch_tan {config}",
                   worst(errs)[1] <= TWIN_TOL and bitwise and values_k9
                   and all(torch.isfinite(a).all().item() for a in tan_k))
        emit({"phase": "k9_twin", "config": f"filter_nn_batch_tan {config}",
              "n_steps": n_tw, "n_lane": b_tw, "tol_scaled": TWIN_TOL,
              "bitwise": bitwise, "values_bitwise_k9": values_k9,
              "errors": errs, "ok": ok})
        del out_k, tan_k, tan_p, ops_nn, grid_nn
    torch.cuda.empty_cache()

    # ---- 21. non-Gaussian DALTON at full width ---------------------------
    n_ng, b_ng, t_ng = 4000, 2048, 20.0
    cfg_ng, thetas_ng, inits_ng = lane_setup(lorenz, n_ng, t_ng, b_ng,
                                             bench_thetas)
    obs_ng = bench_obs(lorenz, t_ng, 21, 1)     # bench.py's rng(1) data
    gauss_ng = obs_models.gauss(0.005)

    def ng_args(n_lane):
        return (thetas_ng[:n_lane], cfg_ng["ode_weight"], inits_ng[:n_lane],
                0.0, t_ng, n_ng, cfg_ng["prior_pars"], obs_ng["obs_data"],
                obs_ng["obs_times"], gauss_ng, (0,), "lorenz")

    def ng_value(n_lane=b_ng):
        return fdn.daltonng_fused_batch(*ng_args(n_lane))

    def ng_grad(n_lane=b_ng):
        return fdn.daltonng_fused_batch_grad(*ng_args(n_lane))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ll_ng = ng_value()
    torch.cuda.synchronize()
    ng_launches = read_counts()
    ng_peak = torch.cuda.max_memory_allocated()
    check("daltonng", "value launches", ng_launches == expect(
        filter_nn_batch=1, smoother_batch_rows=1, filter_batch=1))
    ng_finite = check("daltonng", "value finite",
                      tuple(ll_ng.shape) == (b_ng,)
                      and torch.isfinite(ll_ng).all().item())
    ng_ref = float(truth["daltonng_ll"])
    ng_control = abs(float(truth["daltonng_ll_f32cpu"]) - ng_ref)
    ng_lane0 = float(ll_ng[0])
    ng_err = abs(ng_lane0 - ng_ref)
    ng_tol = max(3 * ng_control, LL_REL_FLOOR * abs(ng_ref))
    ng_audit = check("daltonng", "value audit", ng_err <= ng_tol)
    # the gradient at the largest power of two of lanes that fits
    b_grad = b_ng
    while True:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            ll_g, g_ng = ng_grad(b_grad)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if b_grad == 1:
                raise
            b_grad //= 2
    ng_grad_launches = read_counts()
    ng_grad_peak = torch.cuda.max_memory_allocated()
    check("daltonng", "gradient launches", ng_grad_launches == expect(
        filter_nn_batch_tan=1, smoother_mean_batch_tan=1,
        filter_batch_tan=1))
    g_finite = check("daltonng", "gradient finite",
                     tuple(g_ng.shape) == (b_grad, 3)
                     and torch.isfinite(g_ng).all().item())
    # the values of the same lanes from a value call of the same width
    same_ll = ll_ng if b_grad == b_ng else ng_value(b_grad)
    ng_same = check("daltonng", "values bitwise", torch.equal(ll_g, same_ll))
    g64 = np.asarray(truth["daltonng_grad"], np.float64)
    g_ctrl = np.asarray(truth["daltonng_grad_f32cpu"], np.float64)
    g_lane0 = g_ng[0].double().cpu().numpy()
    ng_grad_rel = float(np.linalg.norm(g_lane0 - g64) / np.linalg.norm(g64))
    # the control is NaN: the gradient is recorded, not judged
    ng_grad_control = float(np.linalg.norm(g_ctrl - g64)
                            / np.linalg.norm(g64))
    ng_unusable = not ng_grad_control <= GRAD_CONTROL_MAX or \
        GRAD_THETA_ROUNDING["daltonng"] > GRAD_CONTROL_MAX
    ng_grad_ok = None if ng_unusable else check(
        "daltonng", "gradient audit",
        ng_grad_rel <= max(3 * ng_grad_control, GRAD_FLOOR))
    del ll_ng, ll_g, g_ng, same_ll
    torch.cuda.empty_cache()
    value_ng_ms = cuda_ms(ng_value, repeats=3)
    grad_ng_ms = cuda_ms(lambda: ng_grad(b_grad), repeats=3)
    # the informative check: FitzHugh-Nagumo EK1 at bench.py's gradient
    # fixture, 4 lanes, against the float64 torch-op on the CPU
    n_fi, t_fi = 200, 10.0
    idx_fi = np.arange(0, n_fi + 1, 10)
    y_fi = torch.tensor(truth["y_fitz_mcmc"])[:, :, None]
    times_fi = torch.tensor(t_fi * idx_fi / n_fi)
    cfg_fi = fitzhugh.setup(n_steps=n_fi, t_max=t_fi, dtype=torch.float32,
                            device=dev)
    thetas_fi = cfg_fi["theta"] * torch.tensor(
        DALTONNG_FITZ_LANES, dtype=torch.float32, device=dev)[:, None]
    n_fi_lane = thetas_fi.shape[0]
    ll_fi, g_fi = fdn.daltonng_fused_batch_grad(
        thetas_fi, cfg_fi["ode_weight"],
        cfg_fi["ode_init"].expand(n_fi_lane, 2, 3), 0.0, t_fi, n_fi,
        cfg_fi["prior_pars"], y_fi.float(), times_fi.float(),
        obs_models.gauss(DALTONNG_FITZ_VAR), (0,), "fitzhugh")
    ll_fi, g_fi = ll_fi.double().cpu(), g_fi.double().cpu()
    cfg64_fi = fitzhugh.setup(n_steps=n_fi, t_max=t_fi, device="cpu")
    cfg64_fi.pop("theta")

    def fitz_loglik(o, x, i, **p):
        return torch.sum(-0.5 * (o[:, 0] - x[:, 0]) ** 2 / DALTONNG_FITZ_VAR)

    t0 = time.perf_counter()
    fi_value_rel, fi_grad_rel, fi_ref = [], [], []
    for i in range(n_fi_lane):
        th = thetas_fi[i].double().cpu().requires_grad_(True)
        ref_i = tprecond.daltonng(
            key=None, interrogate=interrogate_kramer, theta=th,
            obs_data=y_fi, obs_times=times_fi, obs_loglik_i=fitz_loglik,
            **cfg64_fi)
        (g_ref,) = torch.autograd.grad(ref_i, th)
        fi_ref.append(ref_i.item())
        fi_value_rel.append(abs(ll_fi[i].item() - ref_i.item())
                            / abs(ref_i.item()))
        fi_grad_rel.append(((g_fi[i] - g_ref).norm() / g_ref.norm()).item())
    fi_ref_s = time.perf_counter() - t0
    fi_ok = check("daltonng", "informative check against float64",
                  max(fi_value_rel) <= DALTONNG_FITZ_VALUE_TOL
                  and max(fi_grad_rel) <= DALTONNG_FITZ_TOL)
    emit({"phase": "daltonng", "model": "lorenz", "interrogation": "kramer",
          "obs_model": "gauss", "obs_var": 0.005, "n_steps": n_ng,
          "n_lane": b_ng, "n_obs": 21,
          "value": {"launches": {k: v for k, v in ng_launches.items() if v},
                    "finite": ng_finite, "lane0": ng_lane0,
                    "audit_abs_err": ng_err, "audit_ref": ng_ref,
                    "audit_control_abs_err": ng_control,
                    "audit_tol": ng_tol, "audit_ok": ng_audit,
                    "call_ms": value_ng_ms,
                    "per_eval_us": 1e3 * value_ng_ms / b_ng,
                    "peak_mem_bytes": ng_peak},
          "grad": {"n_lane": b_grad,
                   "n_lane_note": None if b_grad == b_ng else
                   f"{b_ng} lanes do not fit in device memory",
                   "launches": {k: v for k, v in ng_grad_launches.items()
                                if v},
                   "finite": g_finite, "values_bitwise": ng_same,
                   "grad_lane0": g_lane0.tolist(), "grad_ref": g64.tolist(),
                   "grad_rel_err": ng_grad_rel,
                   "grad_control_rel_err": ng_grad_control,
                   "grad_theta_rounding_rel":
                   GRAD_THETA_ROUNDING["daltonng"],
                   "f32_unusable_on_any_hw": ng_unusable,
                   "grad_ok": ng_grad_ok, "call_ms": grad_ng_ms,
                   "per_eval_us": 1e3 * grad_ng_ms / b_grad,
                   "ratio_to_value_call": grad_ng_ms / value_ng_ms
                   * b_ng / b_grad,
                   "peak_mem_bytes": ng_grad_peak},
          "informative": {"model": "fitzhugh", "n_steps": n_fi,
                          "n_lane": n_fi_lane, "obs_var": DALTONNG_FITZ_VAR,
                          "lanes": list(DALTONNG_FITZ_LANES),
                          "lane_values": ll_fi.tolist(),
                          "f64_values": fi_ref,
                          "value_rel_err": fi_value_rel,
                          "value_tol": DALTONNG_FITZ_VALUE_TOL,
                          "grad_rel_err": fi_grad_rel,
                          "grad_tol": DALTONNG_FITZ_TOL, "ok": fi_ok,
                          "f64_reference_s": fi_ref_s}})
    del ll_fi, g_fi

    # ---- 22. K9 and K11d at the path's shapes ----------------------------
    # (these launches come after the counts above were read)
    ops_ng, grid_ng, _, _ = fdn._daltonng_prepare(
        thetas_ng, cfg_ng["ode_weight"], inits_ng, 0.0, t_ng, n_ng,
        cfg_ng["prior_pars"], obs_ng["obs_data"], obs_ng["obs_times"])
    fused_ng = fk.resolve_model("lorenz")
    nn_args = (fused_ng, gauss_ng, (0,), n_ng)
    nn_kw = dict(**ops_ng, **grid_ng, mode="kramer")
    nn_cpu = cpu_lanes({**ops_ng, **grid_ng}, ("x0_lanes", "theta_lanes"))

    def nn_steps(n):
        """K9's CPU operands of one lane cut to the first n steps."""
        return {k: (v[:n] if k in ("tgrid", "y", "iobs", "mask") else v)
                for k, v in nn_cpu.items()}

    at_ng = {}
    out9, at_ng["filter_nn_batch"] = at_path_shapes(
        "daltonng_kernels", "filter_nn_batch", "pallas_daltonng.py:77",
        ng_launches,
        steps_cut(fdn.filter_nn_batch, fdn._filter_nn_batch_plain,
                  *nn_args[:3], keys=NN_GRID_KEYS, **nn_kw), n_ng, nn_names,
        lambda n: fdn._filter_nn_batch_plain(fused_ng, gauss_ng, (0,), n,
                                             **nn_steps(n), mode="kramer"),
        n_ng * b_ng, tensors(ops_ng) + tensors(grid_ng), repeats=3,
        shape=f"{n_ng} x {b_ng}", step_outputs=(0, 1, 2, 3),
        **split_record("daltonng_kernels", "filter_nn_batch",
                       "filter_nn_batch",
                       fdn._filter_nn_batch_geometry(
                           "lorenz", gauss_ng, b_ng)))
    check("daltonng_kernels", "filter_nn_batch bitwise",
          at_ng["filter_nn_batch"]["bitwise"])
    # the other kernels of the two paths at these shapes, for the time the
    # calls spend outside kernels
    G9, b9, C9 = fdn._cond_params_cols(ops_ng, *out9)
    rows9 = (b9, G9, C9, out9[0][-1].clone(), out9[1][-1].clone(),
             ops_ng["x0_lanes"], torch.ones(3, device=dev),
             torch.ones(6, device=dev))
    del G9, b9, C9
    path_ms = {"smoother_batch_rows": device_ms(
        lambda: fk.smoother_recursion_batch_rows(*rows9), 3)}
    del rows9
    path_ms["filter_batch"] = device_ms(
        lambda: fk.fused_filter_batch(fused_ng, n_ng, **ops_ng,
                                      mode="kramer"), 3)
    path_ms["filter_batch_tan"] = device_ms(
        lambda: fk.fused_filter_batch_tan(fused_ng, n_ng, **ops_ng,
                                          mode="kramer"), 3)
    A11, b11, _, m11, _ = fk.fused_filter_batch_tan(fused_ng, n_ng, **ops_ng,
                                                    mode="kramer")
    e11 = (b11[1:].contiguous(), A11[1:].contiguous(), m11)
    del A11, b11
    path_ms["smoother_mean_batch_tan"] = device_ms(
        lambda: fk.smoother_mean_recursion_batch_tan(*e11, n_tan), 3)
    del e11, m11
    torch.cuda.empty_cache()
    out11, at_ng["filter_nn_batch_tan"] = at_path_shapes(
        "daltonng_kernels", "filter_nn_batch_tan", "pallas_daltonng.py:269",
        ng_grad_launches,
        steps_cut(fdn.filter_nn_batch_tan, fdn._filter_nn_batch_tan_plain,
                  *nn_args[:3], keys=NN_GRID_KEYS, **nn_kw), n_ng, nn_names,
        lambda n: fdn._filter_nn_batch_tan_plain(
            fused_ng, gauss_ng, (0,), n, **nn_steps(n), mode="kramer"),
        n_ng * b_ng, tensors(ops_ng) + tensors(grid_ng), split=nn_split,
        repeats=3, shape=f"{n_ng} x {b_ng}", step_outputs=(0, 1, 2, 3),
        **split_record("daltonng_kernels", "filter_nn_batch_tan",
                       "filter_nn_batch_tan",
                       fdn._filter_nn_batch_tan_geometry(
                           "lorenz", gauss_ng, b_ng)))
    entry = at_ng["filter_nn_batch_tan"]
    entry["values_bitwise"] = all(
        torch.equal(a[:, :k], v)
        for a, v, (k, _) in zip(out11, out9, nn_split))
    check("daltonng_kernels", "filter_nn_batch_tan bitwise, values K9's",
          entry["bitwise"] and entry["values_bitwise"])
    del out9, out11
    value_kernels_ms = (at_ng["filter_nn_batch"]["ms"]
                        + path_ms["smoother_batch_rows"]
                        + path_ms["filter_batch"])
    grad_kernels_ms = (at_ng["filter_nn_batch_tan"]["ms"]
                       + path_ms["smoother_mean_batch_tan"]
                       + path_ms["filter_batch_tan"])
    emit({"phase": "daltonng_kernels", "n_steps": n_ng, "n_lane": b_ng,
          "kernels": at_ng, "other_kernels_ms": path_ms,
          "value": {"call_ms": value_ng_ms, "kernels_ms": value_kernels_ms,
                    "rest_ms": value_ng_ms - value_kernels_ms},
          "grad": {"n_lane": b_grad, "call_ms": grad_ng_ms,
                   "kernels_ms_at_2048": grad_kernels_ms,
                   "rest_ms": grad_ng_ms - grad_kernels_ms
                   if b_grad == b_ng else None}})
    del ops_ng, grid_ng, nn_cpu

    # ---- 23. the torch-op surface in float64 ---------------------------
    t_phase = time.perf_counter()
    import torch_op_reference

    def on_card(*outs):
        return all(o.is_cuda for o in outs if isinstance(o, torch.Tensor))

    def timed_calls(call, n):
        """n calls of call(): their outputs, the median milliseconds by CUDA
        events and by the wall clock, and the peak memory."""
        outs, event_ms, wall_ms = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            outs.append(call())
            end.record()
            end.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(start.elapsed_time(end))
        return (outs, statistics.median(event_ms), statistics.median(wall_ms),
                torch.cuda.max_memory_allocated())

    # the float64 likelihoods and their gradients against the cache, each
    # called TORCH_OP_CALLS times
    f64_ll = {}
    for name, call in torch_op_reference.likelihood_calls(dev).items():
        outs, event_ms, wall_ms, peak = timed_calls(call, TORCH_OP_CALLS)
        value, grad = outs[0]
        cuda_ok = check("torch_op", f"{name} on the card",
                        all(on_card(*o) for o in outs))
        same = all(torch.equal(o[0], value) for o in outs)
        errs = torch_op_reference.errors(name, value, grad, truth)
        tol = TORCH_OP_TOL[name]
        value_ok = check("torch_op", f"{name} value",
                         errs["value_rel_err"] <= tol["value"])
        grad_ok = (grad is None
                   or check("torch_op", f"{name} gradient",
                            errs["grad_rel_err"] <= tol["grad"]))
        f64_ll[name] = float(value)
        emit({"phase": "torch_op", "call": f"ops.precond.{name.split('_')[0]}"
              + (" + torch.autograd" if grad is not None else ""),
              "likelihood": name, "dtype": "float64", "on_card": cuda_ok,
              "calls_agree": same, **errs, "tol": tol,
              "value_ok": value_ok, "grad_ok": grad_ok,
              "call_ms_events": event_ms, "call_ms_wall": wall_ms,
              "peak_mem_bytes": peak})
        del outs, value, grad

    # lane 0 of the fused likelihoods against the port's float64 value, by
    # the likelihood rule
    for name in ("fenrir", "dalton", "basic"):
        ref = f64_ll[name]
        control = abs(float(truth[f"{name}_ll_f32cpu"])
                      - float(truth[f"{name}_ll"]))
        err = abs(fused_lane0[name] - ref)
        tol = max(3 * control, LL_REL_FLOOR * abs(ref))
        ok = check("torch_op", f"{name}_fused_batch against float64",
                   err <= tol)
        emit({"phase": "torch_op", "fused": f"{name}_fused_batch",
              "lane0": fused_lane0[name], "torch_op_f64": ref,
              "abs_err": err, "tol": tol, "control_f32cpu": control,
              "ok": ok, "cache_ll": float(truth[f"{name}_ll"]),
              "abs_err_against_cache": abs(fused_lane0[name]
                                           - float(truth[f"{name}_ll"]))})

    def draw_statistic(draws, mu, var):
        """The mean of (x - mu)^2 / sigma^2 over the draws and the entries
        whose posterior variance exceeds SIM_VAR_MIN: 1 in expectation."""
        var_d = torch.diagonal(var, dim1=-2, dim2=-1)
        live = var_d > SIM_VAR_MIN
        z2 = (draws - mu) ** 2 / torch.where(live, var_d,
                                             torch.ones_like(var_d))
        return float(z2[..., live].mean()), int(live.sum())

    def sim_posterior(mod, n_steps, t_max):
        """A float64 configuration on the card and its posterior by
        ops.precond.solve_mv."""
        cfg64 = mod.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float64,
                          device=dev)
        th64 = cfg64.pop("theta")
        with torch.no_grad():
            mu, var = tprecond.solve_mv(key=None,
                                        interrogate=interrogate_kramer,
                                        theta=th64, **cfg64)
        return cfg64, th64, mu, var

    # solve_sim on Lorenz63 at 10 000 steps: the float64 posterior (its
    # t <= 4 prefix held to the cached mean by the solve audit's rule), and
    # three draws by each method against it
    cfg_sim, th_sim, mu_sim, var_sim = sim_posterior(lorenz, 10000, 20.0)
    n_prefix = 10000 // 5
    control = max_err_prefix(truth["solve_mu_10k_f32cpu"],
                             truth["solve_mu_10k"], n_prefix)
    tol = max(3 * control, AUDIT_FLOOR)
    err = max_err_prefix(mu_sim.cpu().numpy(), truth["solve_mu_10k"],
                         n_prefix)
    mean_ok = check("torch_op", "solve_mv float64 audit",
                    err <= tol and on_card(mu_sim, var_sim))
    emit({"phase": "torch_op", "call": "ops.precond.solve_mv",
          "model": "lorenz", "n_steps": 10000, "dtype": "float64",
          "audit_max_abs_err_t4": err, "audit_tol": tol, "ok": mean_ok})
    for method, seed in (("svd", 11), ("eigh", 12)):
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.no_grad():
            outs, event_ms, wall_ms, peak = timed_calls(
                lambda: tprecond.solve_sim(
                    key=gen, interrogate=interrogate_kramer, theta=th_sim,
                    method=method, **cfg_sim), 3)
        cuda_ok = check("torch_op", f"solve_sim {method} on the card",
                        on_card(*outs))
        finite = check("torch_op", f"solve_sim {method} finite",
                       all(torch.isfinite(x).all().item()
                           and tuple(x.shape) == (10001, 3, 3)
                           for x in outs))
        starts = check("torch_op", f"solve_sim {method} starts at x0",
                       all(torch.equal(x[0], cfg_sim["ode_init"])
                           for x in outs))
        stat, n_live = draw_statistic(torch.stack(outs), mu_sim, var_sim)
        stat_ok = check("torch_op", f"solve_sim {method} statistic",
                        SIM_F64_STAT_LORENZ[0] <= stat
                        <= SIM_F64_STAT_LORENZ[1])
        emit({"phase": "torch_op", "call": "ops.precond.solve_sim",
              "method": method, "model": "lorenz", "n_steps": 10000,
              "dtype": "float64", "n_draws": len(outs), "on_card": cuda_ok,
              "finite": finite, "starts_at_x0": starts,
              "n_live_entries": n_live, "mean_sq_z": stat,
              "range": SIM_F64_STAT_LORENZ, "ok": stat_ok,
              "max_abs_dev_t4": [max_err_prefix(x.cpu().numpy(),
                                                mu_sim.cpu().numpy(),
                                                n_prefix) for x in outs],
              "call_ms_events": event_ms, "call_ms_wall": wall_ms,
              "peak_mem_bytes": peak})
        del outs
    del mu_sim, var_sim

    # FitzHugh-Nagumo at 800 steps: SIM_F64_DRAWS eigh draws from one
    # generator against the float64 posterior
    cfg_fh64, th_fh64, mu_fh, var_fh = sim_posterior(fitzhugh, 800, 10.0)
    gen = torch.Generator(dev).manual_seed(13)
    with torch.no_grad():
        outs, event_ms, wall_ms, peak = timed_calls(
            lambda: tprecond.solve_sim(
                key=gen, interrogate=interrogate_kramer, theta=th_fh64,
                method="eigh", **cfg_fh64), SIM_F64_DRAWS)
    draws = torch.stack(outs)
    stat, n_live = draw_statistic(draws, mu_fh, var_fh)
    cuda_ok = check("torch_op", "FitzHugh-Nagumo draws on the card",
                    on_card(mu_fh, var_fh, *outs))
    stat_ok = check("torch_op", "FitzHugh-Nagumo draws' statistic",
                    SIM_F64_STAT[0] <= stat <= SIM_F64_STAT[1]
                    and torch.isfinite(draws).all().item())
    emit({"phase": "torch_op", "call": "ops.precond.solve_sim",
          "method": "eigh", "model": "fitzhugh", "n_steps": 800,
          "dtype": "float64", "n_draws": SIM_F64_DRAWS, "on_card": cuda_ok,
          "n_live_entries": n_live, "mean_sq_z": stat,
          "range": SIM_F64_STAT, "ok": stat_ok, "call_ms_events": event_ms,
          "call_ms_wall": wall_ms, "peak_mem_bytes": peak})
    del outs, draws, mu_fh, var_fh
    emit({"phase": "torch_op", "seconds": time.perf_counter() - t_phase})

    # ---- 24. MCMC ----------------------------------------------------------
    t_phase = time.perf_counter()
    import torch_mcmc_reference as mcmc_ref
    from rodeo_tpu_torch import parallel as tpar
    from rodeo_tpu_torch.inference import pseudo_marginal as tpm

    fix_mc = mcmc_ref.fixture(truth, dev)
    cfg_mc, theta_mc = fix_mc["cfg"], fix_mc["theta"]
    solver_mc = dict(ode_weight=cfg_mc["ode_weight"],
                     ode_init=cfg_mc["ode_init"], t_min=0.0,
                     t_max=mcmc_ref.T_MAX, n_steps=mcmc_ref.N_STEPS,
                     prior_pars=cfg_mc["prior_pars"])
    gen_mc = torch.Generator(dev).manual_seed(24)

    def timed_run(run):
        """run() once: its outputs, seconds on the wall clock to the end of
        its device work, the kernel launches it made and its peak
        memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, read_counts(),
                torch.cuda.max_memory_allocated())

    def rates(n_chain_steps, seconds, draws):
        """Chain steps per second, and ESS per second of draws (n_samples,
        n_chains) as bench.py's _ess_total (None under 4 samples)."""
        x = draws.detach().double().cpu().numpy()
        n_eff = tpar.ess(x) if x.shape[0] >= 4 else None
        return {"chain_steps_per_s": n_chain_steps / seconds,
                "ess": n_eff,
                "ess_per_s": None if n_eff is None else n_eff / seconds}

    def launched(counts):
        return {k: v for k, v in counts.items() if v}

    def finite(*tensors):
        return all(torch.isfinite(t).all().item() for t in tensors)

    # the lockstep random walk over posterior draws: 512 chains x 100
    n_rw, s_rw = 512, 100
    runner_rw = tpar.make_chain_runner(
        mcmc_ref.path_loglik(fix_mc), n_rw, s_rw, 0.01, model="fitzhugh",
        device=dev, **solver_mc)
    init_rw = theta_mc.expand(n_rw, 3).contiguous()
    (pos_rw, ll_rw, acc_rw), sec_rw, counts_rw, peak_rw = timed_run(
        lambda: runner_rw(init_rw, gen_mc))
    mean_acc_rw = acc_rw.mean().item()
    rw_ok = [
        check("mcmc", "fused random walk launches",
              counts_rw == expect(filter_batch=s_rw + 1,
                                  sampler_batch=s_rw + 1)),
        check("mcmc", "fused random walk finite", finite(pos_rw, ll_rw)),
        check("mcmc", "fused random walk acceptance in (0, 1)",
              0.0 < mean_acc_rw < 1.0)]
    emit({"phase": "mcmc", "runner": "run_chains_fused", "model": "fitzhugh",
          "n_steps": mcmc_ref.N_STEPS, "n_chains": n_rw, "n_samples": s_rw,
          "rw_scale": 0.01, "launches": launched(counts_rw),
          "seconds": sec_rw, **rates(n_rw * s_rw, sec_rw, pos_rw[..., 0]),
          "mean_accept": mean_acc_rw, "peak_mem_bytes": peak_rw,
          "ok": all(rw_ok)})
    del pos_rw, ll_rw, acc_rw

    # MALA, HMC and NUTS over fenrir's value and gradient, 128 lanes, each
    # after a short adapt_step_size, launches counted over the main run
    n_g = mcmc_ref.GRAD_LANES
    lpg_mc = mcmc_ref.logpost_grad(fix_mc, n_g)
    init_g = theta_mc.expand(n_g, 3).contiguous()
    obs_mc = fix_mc["obs"]
    lanes_mc = dict(ode_weight=cfg_mc["ode_weight"],
                    ode_inits=cfg_mc["ode_init"].expand(n_g, 2, 3),
                    t_min=0.0, t_max=mcmc_ref.T_MAX,
                    n_steps=mcmc_ref.N_STEPS, prior_pars=cfg_mc["prior_pars"],
                    model="fitzhugh", **obs_mc)
    summaries, steps_mc = {}, {}
    for name, spec in mcmc_ref.SAMPLERS.items():
        t_ad = time.perf_counter()
        step, pos0, acc_ad = mcmc_ref.adapt(name, lpg_mc, n_g, init_g,
                                            gen_mc)
        t_ad = time.perf_counter() - t_ad
        steps_mc[name] = step
        runner = mcmc_ref.make_runner(name, lpg_mc, n_g, spec["n_samples"],
                                      step)
        (pos, ll, acc), sec, counts, peak = timed_run(
            lambda: runner(pos0, gen_mc))
        n_tan = counts["filter_batch_tan"]
        if name == "nuts":
            # at most 2**max_depth - 1 leaves a proposal, and one leaf
            budget = 2 ** spec["extra"]["max_depth"] - 1
            launches_ok = (1 + spec["n_samples"] <= n_tan
                           <= 1 + budget * spec["n_samples"]
                           and counts == expect(
                               filter_batch_tan=n_tan,
                               fenrir_backward_batch_tan=n_tan))
        else:
            per_step = spec["extra"].get("n_leapfrog", 1)
            n_tan = 1 + per_step * spec["n_samples"]
            launches_ok = counts == expect(filter_batch_tan=n_tan,
                                           fenrir_backward_batch_tan=n_tan)
        fresh = ff.fenrir_fused_batch(pos[-1], device=dev, **lanes_mc)
        summaries[name] = mcmc_ref.summary(pos)
        ok = [check("mcmc", f"{name} launches", launches_ok),
              check("mcmc", f"{name} finite", finite(pos, ll)),
              check("mcmc", f"{name} carried log-density bitwise",
                    torch.equal(fresh, ll))]
        emit({"phase": "mcmc", "runner": f"make_{name}_runner",
              "likelihood": "fenrir", "model": "fitzhugh", "n_lane": n_g,
              "n_samples": spec["n_samples"], **spec["extra"],
              "step_size": float(step), "adapt_accept": acc_ad,
              "adapt_seconds": t_ad, "launches": launched(counts),
              "seconds": sec,
              **rates(n_g * spec["n_samples"], sec, pos[..., 0]),
              "mean_accept": acc.mean().item(), "peak_mem_bytes": peak,
              "theta": summaries[name], "ok": all(ok)})
        del pos, ll, acc, fresh
    agree = mcmc_ref.agreement(summaries)
    agree_ok = check("mcmc", "MALA, HMC and NUTS theta means agree",
                     agree["ok"])
    emit({"phase": "mcmc", "agreement": agree, "ok": agree_ok})

    # MALA over DALTON's value and gradient: 128 lanes x 20 steps
    s_dal = 20
    (pos_d, ll_d, acc_d), sec_d, counts_d, peak_d = timed_run(
        lambda: tpar.run_chains_mala_fused(
            init_g, gen_mc, s_dal, steps_mc["mala"], model="fitzhugh",
            likelihood="dalton", device=dev, **solver_mc, **obs_mc))
    fresh_d = fd.dalton_fused_batch(pos_d[-1], device=dev, **lanes_mc)
    dal_ok = [
        check("mcmc", "DALTON MALA launches",
              counts_d == expect(dalton_filter_batch_tan=2 * (s_dal + 1))),
        check("mcmc", "DALTON MALA finite", finite(pos_d, ll_d)),
        check("mcmc", "DALTON MALA carried log-density bitwise",
              torch.equal(fresh_d, ll_d))]
    emit({"phase": "mcmc", "runner": "run_chains_mala_fused",
          "likelihood": "dalton", "model": "fitzhugh", "n_lane": n_g,
          "n_samples": s_dal, "step_size": float(steps_mc["mala"]),
          "launches": launched(counts_d), "seconds": sec_d,
          **rates(n_g * s_dal, sec_d, pos_d[..., 0]),
          "mean_accept": acc_d.mean().item(), "peak_mem_bytes": peak_d,
          "ok": all(dal_ok)})
    del pos_d, ll_d, acc_d, fresh_d

    # MAGI's Gibbs sampler of the path and sigma^2 on phase 18's fixture
    n_sw, n_in = 4, 2
    subs_gb = mu4k[None, :n_mg + 1, :, :2] + \
        1e-4 * torch.arange(b_mg, dtype=torch.float32,
                            device=dev)[:, None, None, None]
    (pos_gb, sig2_gb, ll_gb, acc_gb), sec_gb, counts_gb, peak_gb = \
        timed_run(lambda: tpar.run_chains_magi_gibbs(
            subs_gb, gen_mc, n_sw, 1e-6, magi_expand, 2,
            cfg_mg["prior_pars"], dt_mg, sig2_init=1.0, n_inner=n_in,
            device=dev))
    # a gradient call a MALA step and a refresh a sweep, and the first;
    # two value calls a sweep
    n_grad_gb = 1 + n_sw * (n_in + 1)
    gibbs_ok = [
        check("mcmc", "Gibbs launches", counts_gb == expect(
            magi_batch=n_grad_gb + 2 * n_sw, magi_adjoint_batch=n_grad_gb)),
        check("mcmc", "Gibbs sigma^2 finite and positive",
              finite(sig2_gb) and (sig2_gb > 0).all().item()),
        check("mcmc", "Gibbs log-densities finite", finite(ll_gb, pos_gb))]
    emit({"phase": "mcmc", "runner": "run_chains_magi_gibbs",
          "model": "lorenz", "n_steps": n_mg, "n_lane": b_mg,
          "n_sweeps": n_sw, "n_inner": n_in, "step_size": 1e-6,
          "launches": launched(counts_gb), "seconds": sec_gb,
          **rates(b_mg * n_sw, sec_gb, sig2_gb), "ess_of": "sigma^2",
          "sig2_mean": sig2_gb.mean().item(),
          "mean_accept": acc_gb.mean().item(), "peak_mem_bytes": peak_gb,
          "ok": all(gibbs_ok)})
    del subs_gb, pos_gb, sig2_gb, ll_gb, acc_gb

    # the reference path: pseudo_marginal.normal_random_walk through
    # run_chains, 32 chains of bench.py's mcmc_xla log-density (the
    # torch-op solve_sim, eigh), as many steps (3 to 10) as fit MCMC_XLA_S
    y_mc = fix_mc["y"]
    idx_mc = torch.as_tensor(mcmc_ref.OBS_IDX, device=dev)

    def logpost_xla(theta, rng):
        xs = tprecond.solve_sim(key=rng, interrogate=interrogate_kramer,
                                theta=theta, method="eigh", **cfg_mc)
        resid = xs[idx_mc, :, 0] - y_mc
        return -0.5 * torch.sum(resid * resid) / mcmc_ref.SIGMA_OBS ** 2, \
            xs[-1]

    n_xla = 32
    _, t_call, _, _ = timed_run(lambda: logpost_xla(theta_mc, gen_mc))
    s_xla = min(10, max(3, int(MCMC_XLA_S / (n_xla * t_call)) - 1))
    alg_xla = tpm.normal_random_walk(
        logpost_xla, 0.01 * torch.ones(3, device=dev))
    (pos_x, state_x, acc_x), sec_x, counts_x, peak_x = timed_run(
        lambda: tpar.run_chains(alg_xla, theta_mc.expand(n_xla, 3), gen_mc,
                                s_xla))
    xla_ok = [
        check("mcmc", "run_chains finite",
              finite(pos_x, state_x.logdensity, state_x.auxdata)),
        check("mcmc", "run_chains launches no kernel",
              counts_x == expect())]
    emit({"phase": "mcmc", "runner": "run_chains",
          "algorithm": "pseudo_marginal.normal_random_walk",
          "logdensity": "ops.precond.solve_sim (eigh)", "model": "fitzhugh",
          "n_chains": n_xla, "n_samples": s_xla, "sigma": 0.01,
          "logdensity_call_s": t_call, "seconds": sec_x,
          **rates(n_xla * s_xla, sec_x, pos_x[..., 0]),
          "mean_accept": acc_x.mean().item(), "peak_mem_bytes": peak_x,
          "ok": all(xla_ok)})
    del pos_x, state_x, acc_x
    mcmc_s = time.perf_counter() - t_phase
    check("mcmc", f"phase within {MCMC_PHASE_S} s", mcmc_s <= MCMC_PHASE_S)
    emit({"phase": "mcmc", "seconds": mcmc_s, "limit_s": MCMC_PHASE_S})

    # ---- 25. coverage: every instance of K1, K3, K2r and K4 -------------
    t_phase = time.perf_counter()
    from rodeo_tpu_torch.interrogate import interrogate_chkrebtii
    from rodeo_tpu_torch.models import chkrebtii, hes1, seirah
    from rodeo_tpu_torch.ops import fused_sim as fs_cov

    # (a) each instance that the kernels took in this slice, bitwise against
    # its twin at a small shape: K1 on 37 lanes (a ragged lane group), K3 on
    # lane 0, on tools/torch_coverage_reference.py's INSTANCE_CHECKS, short
    # horizons on which every mode stays finite
    t_part = time.perf_counter()
    cov_rows, gains_q = [], {}
    for functor, mode, q in cov_ref.new_filter_instances():
        case = cov_ref.instance_case(functor, mode, q, 37, dev, seed=19)
        outs_c = cov_ref.filter_instance_outputs(case, mode)
        torch.cuda.synchronize()
        row = dict(case["config"])
        for name_k, (ko, po) in zip(("filter_batch", "filter_single"),
                                    outs_c):
            fin = all(torch.isfinite(a).all().item() for a in po)
            bit = all(torch.equal(a, b) for a, b in zip(ko, po))
            check("coverage", f"{name_k} {functor}/{mode}/q={q} finite", fin)
            check("coverage", f"{name_k} {functor}/{mode}/q={q} bitwise",
                  bit)
            row[name_k] = {"bitwise": bit, "finite": fin,
                           "max_scaled_err": worst(compare(
                               [str(i) for i in range(len(ko))], ko,
                               po))[1]}
        for name_k, geo in (
                ("filter_batch", fk._filter_batch_geometry(
                    case["fused"], 2048, mode=mode, q=q)),
                ("filter_single", fk._filter_single_geometry(
                    case["fused"], mode=mode, q=q))):
            row[name_k].update(registers=geo["registers"],
                               local_bytes=geo["local_bytes"],
                               shared_bytes=geo["shared_bytes"])
        if functor == "Chkrebtii" and mode == "kramer":
            gains_q[q] = (outs_c[0][0], case["batch"])
        cov_rows.append(row)
        del outs_c
    emit({"phase": "coverage", "part": "instances", "rows": cov_rows,
          "seconds": time.perf_counter() - t_part,
          "ptxas": [r for sym in ("19filter_batch_kernel",
                                  "20filter_single_kernel")
                    for r in ptxas_report(sym)
                    if r not in earlier_scope([r])]})

    # K2r and K4 at q = 4 and 5: on seeded rows, and on K1's gains of
    # Chkrebtii's ODE (K2r) and on K3's smoothing gains of it (K4)
    t_part = time.perf_counter()
    cov_rows = []
    for q in (4, 5):
        rng_c = np.random.default_rng(q)
        pairs_c, _ = fk._tri_idx(q)
        T_c, nb_c, B_c = 300, 3, 37
        A_c = rng_c.standard_normal((T_c, nb_c, B_c, q, q))
        Lf_c = A_c @ np.swapaxes(A_c, -1, -2)
        sc_c = np.linspace(1.0, 0.1, q)
        seeded_c = [torch.tensor(a, dtype=torch.float32,
                                 device=dev).contiguous() for a in (
            rng_c.standard_normal((T_c, q, nb_c, B_c)),
            np.eye(q).reshape(1, q * q, 1, 1) * 0.5
            + 0.1 * rng_c.standard_normal((T_c, q * q, nb_c, B_c)),
            np.stack([Lf_c[..., i, j] for i, j in pairs_c], axis=1),
            rng_c.standard_normal((q, nb_c, B_c)),
            np.abs(rng_c.standard_normal((len(pairs_c), nb_c, B_c))),
            rng_c.standard_normal((q, nb_c, B_c)), sc_c,
            [sc_c[i] * sc_c[j] for i, j in pairs_c])]
        (G_c, g_c, L_c, mN_c, pN_c), ops_c = gains_q[q]
        k1_rows = (g_c[1:], G_c[1:], L_c[1:], mN_c, pN_c, ops_c["x0_lanes"],
                   ops_c["t_vec"], fk._tri_scale(ops_c["t_vec"]))
        for source, args_c in (("seeded", seeded_c), ("k1_gains", k1_rows)):
            ko = fk.smoother_recursion_batch_rows(*args_c)
            po = fk._smoother_batch_rows_plain(*args_c)
            torch.cuda.synchronize()
            bit = all(torch.equal(a, b) for a, b in zip(ko, po))
            check("coverage", f"smoother_batch_rows q={q} {source} bitwise",
                  bit)
            cov_rows.append({"kernel": "smoother_batch_rows", "q": q,
                             "inputs": source, "bitwise": bit})
        case = cov_ref.instance_case("Chkrebtii", "kramer", q, 1, dev,
                                     seed=19)
        cfg_c, n_c = case["cfg"], case["n_steps"]
        one, Qs_c = fk._single_operands(
            torch.zeros(1, device=dev), cfg_c["ode_weight"],
            cfg_c["ode_init"], 0.0, cfg_c["t_max"], n_c, cfg_c["prior_pars"])
        mf_c, pf_c, mp_c, pp_c = fk.fused_filter(case["fused"], n_c, **one)
        k4_gains = fk._smoother_gains(Qs_c, one["prior_var"], mf_c[:-1],
                                      pf_c[:-1], mp_c[1:], pp_c[1:])
        k4_seeded = [torch.tensor(a, dtype=torch.float32,
                                  device=dev).contiguous() for a in (
            rng_c.standard_normal((T_c, 7, q)),
            np.eye(q).reshape(1, 1, q * q) * 0.5
            + 0.1 * rng_c.standard_normal((T_c, 7, q * q)),
            np.abs(rng_c.standard_normal((T_c, 7, len(pairs_c)))),
            rng_c.standard_normal((7, q)),
            np.abs(rng_c.standard_normal((7, len(pairs_c)))))]
        for source, args_c in (("seeded", k4_seeded),
                               ("k3_gains", (*k4_gains, mf_c[-1],
                                             pf_c[-1]))):
            ko = fk.smoother_recursion(*args_c)
            po = fk._smoother_single_plain(*args_c)
            torch.cuda.synchronize()
            bit = all(torch.equal(a, b) for a, b in zip(ko, po))
            check("coverage", f"smoother_single q={q} {source} bitwise", bit)
            cov_rows.append({"kernel": "smoother_single", "q": q,
                             "inputs": source, "n_block": args_c[0].shape[1],
                             "bitwise": bit})
        geo2 = fk._smoother_batch_rows_geometry(3, 2048, q=q)
        geo4 = fk._smoother_single_geometry(1, q=q)
        cov_rows.append({"q": q, "smoother_batch_rows_geometry": geo2,
                         "smoother_single_geometry": geo4})
    emit({"phase": "coverage", "part": "smoothers", "rows": cov_rows,
          "seconds": time.perf_counter() - t_part,
          "ptxas": [r for sym in ("26smoother_batch_rows_kernel",
                                  "22smoother_single_kernel")
                    for r in ptxas_report(sym) if r.get("q") != 3]})
    del gains_q

    def batch_kernels_ms(model_k, mode_k, thetas_k, inits_k, cfg_k, eps_k):
        """K1 and K2r alone on a batched solve's operands: their device
        milliseconds (device_ms, median of 3)."""
        n_k = cfg_k["n_steps"]
        ops_k = fk._kernel_operands(thetas_k, cfg_k["ode_weight"], inits_k,
                                    cfg_k["t_min"], cfg_k["t_max"], n_k,
                                    cfg_k["prior_pars"])
        fused_k = fk.resolve_model(model_k)
        k1 = functools.partial(fk.fused_filter_batch, fused_k, n_k, **ops_k,
                               mode=mode_k, eps=eps_k)
        G_k, g_k, L_k, mN_k, pN_k = k1()
        t_k = ops_k["t_vec"]
        rows_k = (g_k[1:], G_k[1:], L_k[1:], mN_k, pN_k, ops_k["x0_lanes"],
                  t_k, fk._tri_scale(t_k))
        return {"filter_batch": device_ms(k1, 3),
                "smoother_batch_rows": device_ms(
                    lambda: fk.smoother_recursion_batch_rows(*rows_k), 3)}

    def single_kernels_ms(model_k, cfg_k, theta_k):
        """K3 and K4 alone on one solve's operands (kramer), device
        milliseconds."""
        n_k = cfg_k["n_steps"]
        one_k, Qs_k = fk._single_operands(
            theta_k, cfg_k["ode_weight"], cfg_k["ode_init"], cfg_k["t_min"],
            cfg_k["t_max"], n_k, cfg_k["prior_pars"])
        fused_k = fk.resolve_model(model_k)
        k3 = functools.partial(fk.fused_filter, fused_k, n_k, **one_k)
        mf_k, pf_k, mp_k, pp_k = k3()
        k4_args = (*fk._smoother_gains(Qs_k, one_k["prior_var"], mf_k[:-1],
                                       pf_k[:-1], mp_k[1:], pp_k[1:]),
                   mf_k[-1], pf_k[-1])
        return {"filter_single": device_ms(k3, 3),
                "smoother_single": device_ms(
                    lambda: fk.smoother_recursion(*k4_args), 3)}

    def prefix(cfg_k, n_k):
        """cfg_k's first n_k steps: the same step size, t_max cut to the
        n_k-th step."""
        return {**cfg_k, "n_steps": n_k, "t_max": cfg_k["t_min"] + (
            cfg_k["t_max"] - cfg_k["t_min"]) * n_k / cfg_k["n_steps"]}

    def twin_row(label, ko, po):
        """A kernel's outputs against its twin's on the same operands:
        bitwise (checked) and the largest scaled error."""
        bit = all(torch.equal(a, b) for a, b in zip(ko, po))
        check("coverage", f"{label} bitwise", bit)
        return {"bitwise": bit, "max_scaled_err": worst(compare(
            [str(i) for i in range(len(ko))], ko, po))[1]}

    def batch_twins(label, model_k, mode_k, thetas_k, inits_k, cfg_k,
                    eps_k):
        """K1 on a batched solve's operands and K2r on K1's gains, each
        against its twin on the same operands (twin_row)."""
        n_k = cfg_k["n_steps"]
        ops_k = fk._kernel_operands(thetas_k, cfg_k["ode_weight"], inits_k,
                                    cfg_k["t_min"], cfg_k["t_max"], n_k,
                                    cfg_k["prior_pars"])
        fused_k = fk.resolve_model(model_k)
        k1_out = fk.fused_filter_batch(fused_k, n_k, **ops_k, mode=mode_k,
                                       eps=eps_k)
        k1_twin = fk._filter_batch_plain(fused_k, n_k, **ops_k, mode=mode_k,
                                         eps=eps_k)
        G_k, g_k, L_k, mN_k, pN_k = k1_out
        t_k = ops_k["t_vec"]
        rows_k = (g_k[1:], G_k[1:], L_k[1:], mN_k, pN_k, ops_k["x0_lanes"],
                  t_k, fk._tri_scale(t_k))
        k2_out = fk.smoother_recursion_batch_rows(*rows_k)
        k2_twin = fk._smoother_batch_rows_plain(*rows_k)
        torch.cuda.synchronize()
        return {"filter_batch": twin_row(f"{label} filter_batch", k1_out,
                                         k1_twin),
                "smoother_batch_rows": twin_row(
                    f"{label} smoother_batch_rows", k2_out, k2_twin)}

    def single_twins(label, model_k, cfg_k, theta_k):
        """K3 on one solve's operands (kramer) and K4 on its smoothing
        gains, each against its twin on the same operands (twin_row)."""
        n_k = cfg_k["n_steps"]
        one_k, Qs_k = fk._single_operands(
            theta_k, cfg_k["ode_weight"], cfg_k["ode_init"], cfg_k["t_min"],
            cfg_k["t_max"], n_k, cfg_k["prior_pars"])
        fused_k = fk.resolve_model(model_k)
        k3_out = fk.fused_filter(fused_k, n_k, **one_k)
        k3_twin = fk._filter_single_plain(fused_k, n_k, **one_k,
                                          mode="kramer")
        mf_k, pf_k, mp_k, pp_k = k3_out
        k4_args = (*fk._smoother_gains(Qs_k, one_k["prior_var"], mf_k[:-1],
                                       pf_k[:-1], mp_k[1:], pp_k[1:]),
                   mf_k[-1], pf_k[-1])
        k4_out = fk.smoother_recursion(*k4_args)
        k4_twin = fk._smoother_single_plain(*k4_args)
        torch.cuda.synchronize()
        return {"filter_single": twin_row(f"{label} filter_single", k3_out,
                                          k3_twin),
                "smoother_single": twin_row(f"{label} smoother_single",
                                            k4_out, k4_twin)}

    # (b) the main path at full width under schober and chkrebtii: Lorenz63,
    # 10 000 steps x 2048 lanes, chkrebtii at prior sigma CHKREBTII_SIGMA
    # with normals drawn beforehand (the call's time is the solve's); K1 and
    # K2r at the full 2048 lanes against their twins over the first
    # COVERAGE_TWIN_STEPS steps
    for mode in ("schober", "chkrebtii"):
        t_part = time.perf_counter()
        sigma_b = cov_ref.CHKREBTII_SIGMA if mode == "chkrebtii" else 5e7
        cfg_b = lorenz.setup(n_steps=10000, t_max=20.0, prior_sigma=sigma_b,
                             dtype=torch.float32, device=dev)
        thetas_b = bench_thetas(cfg_b["theta"], 2048)
        inits_b = cfg_b["ode_init"].expand(2048, 3, 3)
        eps_b = torch.randn((10000, 3, 3, 2048),
                            generator=torch.Generator(dev).manual_seed(25),
                            device=dev) if mode == "chkrebtii" else None

        def solve_b():
            return fk.solve_mv_fused_batch(
                thetas_b, cfg_b["ode_weight"], inits_b, 0.0, 20.0, 10000,
                cfg_b["prior_pars"], model="lorenz", interrogation=mode,
                eps=eps_b)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mean_b, var_b = solve_b()
        torch.cuda.synchronize()
        launches_b = read_counts()
        peak_b = torch.cuda.max_memory_allocated()
        ok_b = [check("coverage", f"{mode} full width launches",
                      launches_b == expect(filter_batch=1,
                                           smoother_batch_rows=1)),
                check("coverage", f"{mode} full width finite",
                      finite(mean_b, var_b))]
        del mean_b, var_b
        ms_b = cuda_ms(solve_b, repeats=3)
        kernels_b = batch_kernels_ms("lorenz", mode, thetas_b, inits_b, cfg_b,
                                     eps_b)
        cfg_t = prefix(cfg_b, COVERAGE_TWIN_STEPS)
        twins_b = batch_twins(
            f"{mode} full width", "lorenz", mode, thetas_b, inits_b, cfg_t,
            None if eps_b is None else eps_b[:COVERAGE_TWIN_STEPS])
        emit({"phase": "coverage", "part": "full_width", "model": "lorenz",
              "interrogation": mode, "prior_sigma": sigma_b,
              "n_steps": 10000, "n_lane": 2048,
              "launches": launched(launches_b), "solve_ms": ms_b,
              "per_solve_us": 1e3 * ms_b / 2048, "peak_mem_bytes": peak_b,
              "kernels_ms": kernels_b,
              "twins": {"n_steps": cfg_t["n_steps"], "n_lane": 2048,
                        **twins_b},
              "seconds": time.perf_counter() - t_part,
              "ok": all(ok_b) and all(r["bitwise"]
                                      for r in twins_b.values())})
        del eps_b

    # (c)-(e) the pointwise audits: x of each fixture's fused solve, one
    # solve (K3, K4) and a lane batch (K1, K2r, lane 0), against the
    # float64 torch-op solve on the card
    lanes_cov = {"chkrebtii_q4": 128, "chkrebtii_q5": 128, "hes1": 2048,
                 "seirah": 2048, "fitz_schober": 128}
    mu64_value = {}     # the value fixtures' float64 solves, for phase 26
    for name_f, n_lane_f in lanes_cov.items():
        t_part = time.perf_counter()
        mu64 = cov_ref.float64_solve(name_f, dev)
        if name_f in cov_ref.VALUE_FIXTURES:
            mu64_value[name_f] = mu64
        tol_f = max(3 * COVERAGE_F32_CPU_ERR[name_f], COVERAGE_FLOOR)
        row = {"fixture": name_f, "config": cov_ref.FIXTURES[name_f],
               "control_f32cpu": COVERAGE_F32_CPU_ERR[name_f], "tol": tol_f}
        for how, n_l, kern in (("single", None, ("filter_single",
                                                 "smoother_single")),
                               ("batch", n_lane_f, ("filter_batch",
                                                    "smoother_batch_rows"))):
            call_f = cov_ref.float32_call(name_f, dev, n_lane=n_l)
            reset_counts()
            mu32 = call_f()
            torch.cuda.synchronize()
            launches_f = read_counts()
            lane0 = mu32 if n_l is None else mu32[..., 0]
            err_f = cov_ref.max_err_x(lane0, mu64)
            check("coverage", f"{name_f} {how} launches",
                  launches_f == expect(**{k: 1 for k in kern}))
            check("coverage", f"{name_f} {how} finite", finite(mu32))
            check("coverage", f"{name_f} {how} audit", err_f <= tol_f)
            ms_f = cuda_ms(call_f, repeats=3)
            row[how] = {"n_lane": n_l or 1, "max_abs_err_x": err_f,
                        "ms": ms_f, "per_solve_ms": ms_f / (n_l or 1),
                        "launches": launched(launches_f)}
        if name_f.startswith("chkrebtii"):
            cfg_k, theta_k = cov_ref.fixture_config(name_f, torch.float32,
                                                    dev)
            row["kernels_ms"] = {
                "batch": batch_kernels_ms(
                    "chkrebtii", "kramer", theta_k.expand(n_lane_f, 1),
                    cfg_k["ode_init"].expand(
                        (n_lane_f,) + cfg_k["ode_init"].shape), cfg_k, None),
                "single": single_kernels_ms("chkrebtii", cfg_k, theta_k)}
            # K1 and K2r over the fixture's lanes, K3 and K4 over one solve,
            # against their twins on the same operands, over the first
            # COVERAGE_TWIN_STEPS steps
            cfg_t = prefix(cfg_k, COVERAGE_TWIN_STEPS)
            row["twins"] = {
                "n_steps": COVERAGE_TWIN_STEPS,
                "batch": batch_twins(
                    name_f, "chkrebtii", "kramer",
                    theta_k.expand(n_lane_f, 1), cfg_k["ode_init"].expand(
                        (n_lane_f,) + cfg_k["ode_init"].shape), cfg_t, None),
                "single": single_twins(name_f, "chkrebtii", cfg_t, theta_k)}
        emit({"phase": "coverage", "part": "audit", **row,
              "seconds": time.perf_counter() - t_part,
              "ok": all(row[h]["max_abs_err_x"] <= tol_f
                        for h in ("single", "batch"))
              and all(r["bitwise"] for h in ("batch", "single")
                      for r in row.get("twins", {}).get(h, {}).values())})
        del mu64, mu32

    # (f) chkrebtii in distribution: FitzHugh-Nagumo, 100 steps to t = 5,
    # 2048 fused lanes against 16 float64 torch-op realizations
    cfg_f = fitzhugh.setup(n_steps=100, t_max=5.0, dtype=torch.float32,
                           device=dev)
    theta_f = cfg_f.pop("theta")
    reset_counts()
    mu_chk, _ = fk.solve_mv_fused_batch(
        theta_f.expand(2048, 3), cfg_f["ode_weight"],
        cfg_f["ode_init"].expand(2048, 2, 3), 0.0, 5.0, 100,
        cfg_f["prior_pars"], model="fitzhugh", interrogation="chkrebtii",
        generator=torch.Generator(dev).manual_seed(26))
    launches_f = read_counts()
    cfg_f64 = fitzhugh.setup(n_steps=100, t_max=5.0, dtype=torch.float64,
                             device=dev)
    theta_f64 = cfg_f64.pop("theta")
    real = torch.stack([rodeo_tpu_torch.solve_mv(
        key=torch.Generator(dev).manual_seed(100 + s_r),
        interrogate=functools.partial(interrogate_chkrebtii,
                                      kalman_type="standard"),
        theta=theta_f64, **cfg_f64)[0][:, :, 0] for s_r in range(16)])
    x_chk = mu_chk[:, :, 0, :].double()
    mean_diff = (x_chk.mean(-1) - real.mean(0)).abs().max().item()
    sd_ratio = (x_chk.std(-1).mean() / real.std(0).mean()).item()
    dist_ok = [check("coverage", "chkrebtii launches",
                     launches_f == expect(filter_batch=1,
                                          smoother_batch_rows=1)),
               check("coverage", "chkrebtii finite",
                     finite(mu_chk) and finite(real)),
               check("coverage", "chkrebtii mean paths",
                     mean_diff < CHK_MEAN_TOL),
               check("coverage", "chkrebtii spread",
                     CHK_SPREAD[0] < sd_ratio < CHK_SPREAD[1])]
    emit({"phase": "coverage", "part": "chkrebtii_distribution",
          "model": "fitzhugh", "n_steps": 100, "t_max": 5.0, "n_lane": 2048,
          "n_realizations": 16, "max_mean_diff": mean_diff,
          "mean_tol": CHK_MEAN_TOL, "spread_ratio": sd_ratio,
          "spread_range": CHK_SPREAD, "ok": all(dist_ok)})
    del mu_chk, real, x_chk

    # (g) chkrebtii draws: solve_sim_fused_batch at 2048 lanes and the
    # lockstep random walk over it, 512 chains x 20 steps, on the MCMC
    # phase's FitzHugh-Nagumo fixture
    gen_cov = torch.Generator(dev).manual_seed(27)
    reset_counts()
    paths_chk = fs_cov.solve_sim_fused_batch(
        theta_mc.expand(2048, 3), cfg_mc["ode_weight"],
        cfg_mc["ode_init"].expand(2048, 2, 3), 0.0, mcmc_ref.T_MAX,
        mcmc_ref.N_STEPS, cfg_mc["prior_pars"], model="fitzhugh",
        interrogation="chkrebtii", generator=gen_cov)
    torch.cuda.synchronize()
    sim_ok = [check("coverage", "chkrebtii draw launches",
                    read_counts() == expect(filter_batch=1,
                                            sampler_batch=1)),
              check("coverage", "chkrebtii draws finite", finite(paths_chk))]
    del paths_chk
    n_rw_c, s_rw_c = 512, 20
    runner_c = tpar.make_chain_runner(
        mcmc_ref.path_loglik(fix_mc), n_rw_c, s_rw_c, 0.01,
        model="fitzhugh", interrogation="chkrebtii", device=dev,
        **solver_mc)
    (pos_c, ll_c, acc_c), sec_c, counts_c, peak_c = timed_run(
        lambda: runner_c(theta_mc.expand(n_rw_c, 3).contiguous(), gen_cov))
    rw_c_ok = [
        check("coverage", "chkrebtii random walk launches",
              counts_c == expect(filter_batch=s_rw_c + 1,
                                 sampler_batch=s_rw_c + 1)),
        check("coverage", "chkrebtii random walk finite",
              finite(pos_c, ll_c))]
    emit({"phase": "coverage", "part": "chkrebtii_draws",
          "model": "fitzhugh", "n_steps": mcmc_ref.N_STEPS,
          "sim_n_lane": 2048, "sim_ok": all(sim_ok), "n_chains": n_rw_c,
          "n_samples": s_rw_c, "launches": launched(counts_c),
          "walk_seconds": sec_c, "chain_steps_per_s": n_rw_c * s_rw_c / sec_c,
          "mean_accept": acc_c.mean().item(), "peak_mem_bytes": peak_c,
          "ok": all(rw_c_ok)})
    del pos_c, ll_c, acc_c
    cov_s = time.perf_counter() - t_phase
    check("coverage", f"phase within {COVERAGE_PHASE_S} s",
          cov_s <= COVERAGE_PHASE_S)
    emit({"phase": "coverage", "seconds": cov_s, "build_s": build_s,
          "limit_s": COVERAGE_PHASE_S})

    # ---- 26. coverage_value: K6, K7a, K7b and K8 at every instance ------
    t_phase = time.perf_counter()
    from rodeo_tpu_torch.ops.obs_grid import obs_indices

    def lane0_audit(label, value, truth_v, control, phase="coverage_value"):
        """The likelihood rule on lane 0: |value - truth| within max(3 x
        the float32 twin's CPU error, LL_REL_FLOOR x |truth|), unless the
        float32 CPU control misses by more than VALUE_F32_UNUSABLE of the
        truth, where no float32 evaluation resolves the value: recorded,
        not judged."""
        err = abs(value - truth_v)
        tol = max(3 * control, LL_REL_FLOOR * abs(truth_v))
        unusable = control > VALUE_F32_UNUSABLE * abs(truth_v)
        ok = True if unusable else check(phase, f"{label} audit",
                                         err <= tol)
        return {"lane0": value, "f64": truth_v, "abs_err": err,
                "control_f32cpu": control, "tol": tol,
                "f32_unusable": unusable, "ok": ok}

    def sim_rule(stats):
        """The sim phase's rule on cov_ref.draw_stats' reading."""
        return (stats["entries_checked"] > 0 and stats["max_z"] <= SIM_Z
                and SIM_VAR_RATIO[0] <= stats["var_ratio"][0]
                and stats["var_ratio"][1] <= SIM_VAR_RATIO[1])

    n_val = 2048
    val_kernels = {}        # kernel key -> [instance entries]

    def wide_dalton(name, mode, obs):
        """DALTON of value fixture name under mode at n_val lanes
        VALUE_WIDE_LANES apart, where float32 turns it NaN on
        VALUE_NAN_LANES' lanes on the CPU: not finite on some lanes exactly
        where K8's sums, with data or without, are (or finite on every lane
        where the CPU's twins are), and K8 bitwise its twin over the whole
        path, not finite where the twin is."""
        model, _, n, t_max, _ = cov_ref.FIXTURES[name]
        scale = cov_ref.VALUE_WIDE_LANES[name]
        fused = fk.resolve_model(model)
        cfg, _ = cov_ref.fixture_config(name, torch.float32, dev)
        thetas, inits = cov_ref.value_lanes(name, n_val, dev, seed=28,
                                            scale=scale)
        lead = (thetas, cfg["ode_weight"], inits, 0.0, t_max, n,
                cfg["prior_pars"])
        ll = fd.dalton_fused_batch(*lead, model=model, interrogation=mode,
                                   device=dev, **obs)
        bad = ~torch.isfinite(ll)
        stated = cov_ref.VALUE_NAN_LANES.get((model, mode), 0)
        label = f"{name}/{mode} lanes {scale} apart"
        out = {"scale": scale, "nonfinite_lanes": int(bad.sum()),
               "nonfinite_lanes_cpu": stated}
        if not stated:
            out["ok"] = check("coverage_value", f"{label} DALTON finite",
                              not bad.any())
            return out
        ops, grid, ld0 = fd._dalton_prepare(*lead, *obs.values())
        k8_bad, same = torch.zeros_like(bad), True
        for with_obs in (True, False):
            k8 = dict(**ops, **grid, mode=mode, with_obs=with_obs,
                      ld0=ld0 if with_obs else torch.zeros_like(ld0))
            ld = fd.dalton_filter_batch(fused, n, **k8)
            pair = finite_part(ld, fd._dalton_filter_plain(fused, n, **k8))
            same = same and pair is not None and torch.equal(*pair)
            k8_bad |= ~torch.isfinite(ld)
        out["ok"] = all([
            check("coverage_value", f"{label} K8 bitwise its twin, not "
                  "finite where it is", same),
            check("coverage_value", f"{label} DALTON not finite on some "
                  "lanes, where K8 is", bad.any()
                  and torch.equal(bad, k8_bad))])
        return out
    for name_v, every_v in cov_ref.VALUE_FIXTURES.items():
        t_part = time.perf_counter()
        model_v, q_v, n_v, t_v, _ = cov_ref.FIXTURES[name_v]
        cfg_v, theta_v = cov_ref.fixture_config(name_v, torch.float32, dev)
        fused_v = fk.resolve_model(model_v)
        nb_v = fused_v.n_block
        thetas_v, inits_v = cov_ref.value_lanes(name_v, n_val, dev, seed=28)
        obs_v = cov_ref.value_obs(name_v, mu64_value[name_v], torch.float32,
                                  dev, seed=29)
        lead_v = (thetas_v, cfg_v["ode_weight"], inits_v, 0.0, t_v, n_v,
                  cfg_v["prior_pars"])
        for mode_v in cov_ref.VALUE_MODES:
            row = {"fixture": name_v, "model": model_v, "q": q_v,
                   "mode": mode_v, "n_steps": n_v, "n_lane": n_val,
                   "n_obs": obs_v["obs_data"].shape[0]}
            ref_v = cov_ref.value_float64(name_v, mode_v, thetas_v[0],
                                          inits_v[0], obs_v, dev)
            calls_v = cov_ref.value_float32_calls(name_v, mode_v, thetas_v,
                                                  inits_v, obs_v, dev)
            k8_obs = {}
            for call_v, expected_v in (
                    ("fenrir_batch", expect(filter_batch=1,
                                            fenrir_backward_batch=1)),
                    ("dalton_batch", expect(dalton_filter_batch=2)),
                    ("fenrir_single", expect(filter_single=1,
                                             fenrir_backward_single=1))):
                label = f"{name_v}/{mode_v} {call_v}"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                with split_by_obs("dalton_filter_batch", k8_obs):
                    ll_v = calls_v[call_v]()
                torch.cuda.synchronize()
                got_v = read_counts()
                check("coverage_value", f"{label} launches",
                      got_v == expected_v)
                if call_v == "dalton_batch":
                    k8_dalton_v = dict(k8_obs)
                    check("coverage_value", f"{label} launches by with_obs",
                          k8_dalton_v == {True: 1, False: 1})
                check("coverage_value", f"{label} finite", finite(ll_v))
                row[call_v] = {
                    "launches": launched(got_v),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    **lane0_audit(label, float(ll_v.reshape(-1)[0]),
                                  ref_v[call_v.split("_")[0]],
                                  VALUE_F32_CPU_ERR[name_v][mode_v][call_v]),
                    "call_ms": cuda_ms(calls_v[call_v], repeats=3)}
                if call_v != "fenrir_single":
                    row[call_v]["per_lane_us"] = \
                        1e3 * row[call_v]["call_ms"] / n_val
                del ll_v
            # the draws at the lanes, then at the setup's parameters on
            # every lane against the solve's posterior there (K1, K2r)
            gen_v = torch.Generator(dev).manual_seed(30)
            sim_v = functools.partial(fs.solve_sim_fused_batch, *lead_v,
                                      model=model_v, interrogation=mode_v,
                                      generator=gen_v, device=dev)
            reset_counts()
            path_v = sim_v()
            torch.cuda.synchronize()
            got_v = read_counts()
            check("coverage_value", f"{name_v}/{mode_v} sim launches",
                  got_v == expect(filter_batch=1, sampler_batch=1))
            check("coverage_value", f"{name_v}/{mode_v} sim finite",
                  finite(path_v) and tuple(path_v.shape)
                  == (n_v + 1, nb_v, q_v, n_val))
            del path_v
            base_v = (theta_v.expand(n_val, theta_v.shape[0]),
                      cfg_v["ode_weight"], cfg_v["ode_init"].expand(
                          (n_val,) + cfg_v["ode_init"].shape), 0.0, t_v, n_v,
                      cfg_v["prior_pars"])
            eps_v, eps_t_v = cov_ref.draw_normals(name_v, n_val, gen_v, dev)
            draws_v = fs.solve_sim_fused_batch(
                *base_v, model=model_v, interrogation=mode_v, eps=eps_v,
                eps_term=eps_t_v, device=dev)
            mean_v, var_v = fk.solve_mv_fused_batch(
                *[a[:1] if i in (0, 2) else a for i, a in enumerate(base_v)],
                model=model_v, interrogation=mode_v, device=dev)
            _, where_v = fk._tri_idx(q_v)
            stats_v = cov_ref.draw_stats(
                draws_v, mean_v[..., 0],
                var_v[:, :, [where_v[(j, j)] for j in range(q_v)], 0],
                SIM_VAR_MIN, SIM_SD_REL)
            judged_v = (model_v, mode_v) not in SIM_UNRESOLVED
            if judged_v:
                stats_v["ok"] = check(
                    "coverage_value", f"{name_v}/{mode_v} draws against the "
                    "posterior", sim_rule(stats_v))
            del draws_v, mean_v, var_v
            if (model_v, mode_v) in SIM_F64_WITNESS:
                # the same draws by the twins in float64 on the same
                # normals, against their posterior by the sim rule
                t_w = time.perf_counter()
                stats_w = cov_ref.draw_stats(
                    *cov_ref.float64_draws(name_v, mode_v, n_val, eps_v,
                                           eps_t_v, dev), SIM_VAR_MIN)
                stats_w["seconds"] = time.perf_counter() - t_w
                stats_w["ok"] = check(
                    "coverage_value", f"{name_v}/{mode_v} float64 twins' "
                    "draws against their posterior", sim_rule(stats_w))
                stats_v["float64_twins"] = stats_w
            row["sim"] = {"launches": launched(got_v),
                          "call_ms": cuda_ms(sim_v, repeats=3),
                          "distribution": {**stats_v, "judged": judged_v,
                                           "z_tol": SIM_Z,
                                           "var_ratio_tol": SIM_VAR_RATIO}}
            del eps_v, eps_t_v
            if name_v in cov_ref.VALUE_WIDE_LANES:
                row["wide_lanes"] = wide_dalton(name_v, mode_v, obs_v)
            emit({"phase": "coverage_value", "part": "calls", **row})

            # each new instance of K8 (this model, mode and q) and, once a
            # q, of K7b, K7a and K6 alone at these shapes, against its twin
            # over COVERAGE_VALUE_TWIN_STEPS steps at the full width
            ops_v = fk._kernel_operands(thetas_v, cfg_v["ode_weight"],
                                        inits_v, 0.0, t_v, n_v,
                                        cfg_v["prior_pars"])
            ops_d, obs_d, ld0_d = fd._dalton_prepare(*lead_v,
                                                     *obs_v.values())
            for with_obs in (True, False):
                variant = "with_obs" if with_obs else "without_obs"
                k8_v = dict(**ops_d, **obs_d, mode=mode_v, with_obs=with_obs,
                            ld0=ld0_d if with_obs
                            else torch.zeros_like(ld0_d))
                k8_cpu = cpu_lanes(k8_v, ("x0_lanes", "theta_lanes", "ld0"))
                geo = fd._dalton_filter_batch_geometry(
                    model_v, n_val, mode_v, with_obs, q_v)
                _, entry = at_path_shapes(
                    "coverage_value", "dalton_filter_batch",
                    "pallas_dalton.py:41",
                    {"dalton_filter_batch": k8_dalton_v[with_obs]},
                    steps_cut(fd.dalton_filter_batch, fd._dalton_filter_plain,
                              fused_v, keys=GRID_KEYS, **k8_v), n_v, ["ld"],
                    None, None, tensors(k8_v), repeats=3, register=False,
                    twin_steps=COVERAGE_VALUE_TWIN_STEPS,
                    n_ops=n_val * dalton_ops(
                        k8_cpu, lambda n, a: fd._dalton_filter_plain(
                            fused_v, n, **a)),
                    config=f"{model_v}/{mode_v}/q={q_v} {variant}",
                    shape=f"{n_v} x {n_val}", model=model_v, mode=mode_v,
                    q=q_v, variant=variant, **split_record(
                        "coverage_value", "dalton_filter_batch",
                        f"dalton_filter_batch {model_v}/{mode_v}/q={q_v} "
                        f"{variant}", geo, per_sm=False,
                        match=lambda r: r.get("model") == fused_v.cuda_functor
                        and r.get("q") == q_v
                        and r.get("mode") == fk._MODES[mode_v]
                        and r.get("with_obs") == with_obs))
                check("coverage_value", f"dalton_filter_batch {model_v}/"
                      f"{mode_v}/q={q_v} {variant} bitwise",
                      entry["bitwise"])
                val_kernels.setdefault(f"dalton_filter_batch/{variant}",
                                       []).append(entry)
            del ops_d, obs_d, ld0_d, k8_v, k8_cpu
            if mode_v != "kramer":
                continue
            # K7b on the kramer fenrir's chain
            chain_v = ff._fenrir_operands(fused_v, n_v, 0.0, t_v, ops_v,
                                          *obs_v.values(), mode_v)
            chain_cpu_v = chain_on_cpu(chain_v)
            geo = ff._fenrir_backward_batch_geometry(nb_v, n_val, q_v)
            _, entry = at_path_shapes(
                "coverage_value", "fenrir_backward_batch",
                "pallas_fenrir.py:291",
                {"fenrir_backward_batch": row["fenrir_batch"]["launches"].get(
                    "fenrir_backward_batch", 0)},
                rows_cut(ff.fenrir_backward_batch, fenrir_plain, chain_v, 7,
                         from_end=True), n_v, ["ld"], None, None, chain_v,
                n_ops=n_val * fenrir_ops(chain_cpu_v),
                out_bytes=4 * nb_v * n_val, repeats=3, register=False,
                twin_steps=COVERAGE_VALUE_TWIN_STEPS,
                config=f"q={q_v}", shape=f"{n_v} x {n_val}", q=q_v,
                model=model_v, **split_record(
                    "coverage_value", "fenrir_backward_batch",
                    f"fenrir_backward_batch q={q_v}", geo, per_sm=False,
                    match=lambda r: r.get("q") == q_v))
            check("coverage_value", f"fenrir_backward_batch q={q_v} bitwise",
                  entry["bitwise"])
            val_kernels.setdefault("fenrir_backward_batch", []).append(entry)
            del chain_v, chain_cpu_v
            # K7a on lane 0's single fenrir chain
            one_v, Qs_v = fk._single_operands(
                thetas_v[0], cfg_v["ode_weight"], inits_v[0], 0.0, t_v, n_v,
                cfg_v["prior_pars"])
            one_v["q_const"] = ff._const_coefs(Qs_v)
            chain_1 = ff._fenrir_single_operands(
                fused_v, n_v, 0.0, t_v, one_v, Qs_v, *obs_v.values(), mode_v)
            chain_1_cpu = [t.cpu() for t in chain_1[:9]]
            ops_7 = grid_ops(chain_1_cpu[6], lambda idx: op_count(
                lambda: ff._fenrir_backward_single_plain(
                    *[t[idx] for t in chain_1_cpu[:7]], *chain_1_cpu[7:])))
            geo = ff._fenrir_backward_single_geometry(nb_v, q_v)
            _, entry = at_path_shapes(
                "coverage_value", "fenrir_backward_single",
                "pallas_fenrir.py:214",
                {"fenrir_backward_single": row["fenrir_single"][
                    "launches"].get("fenrir_backward_single", 0)},
                rows_cut(ff.fenrir_backward_single, fenrir_single_plain,
                         chain_1, 7, from_end=True), n_v, ["ld"], None,
                None, chain_1, n_ops=ops_7, out_bytes=4 * nb_v,
                register=False,
                twin_steps=COVERAGE_VALUE_TWIN_STEPS,
                config=f"q={q_v}", shape=f"{n_v} steps", q=q_v,
                model=model_v, **split_record(
                    "coverage_value", "fenrir_backward_single",
                    f"fenrir_backward_single q={q_v}", geo, per_sm=False,
                    match=lambda r: r.get("q") == q_v))
            check("coverage_value", f"fenrir_backward_single q={q_v} "
                  "bitwise", entry["bitwise"])
            val_kernels.setdefault("fenrir_backward_single", []).append(entry)
            del chain_1, chain_1_cpu, one_v, Qs_v
            # K6 on the draw's operands
            gen_k6 = torch.Generator(dev).manual_seed(31)
            eps_v = torch.randn((n_v - 1, q_v, nb_v, n_val), generator=gen_k6,
                                device=dev)
            eps_t_v = torch.randn((q_v, nb_v, n_val), generator=gen_k6,
                                  device=dev)
            k6_v = fs._draw_operands(fused_v, n_v, ops_v, mode_v, eps_v,
                                     eps_t_v)
            k6_cpu = [cpu_lane(t) for t in k6_v]
            geo = fs._sampler_batch_geometry(nb_v * n_val, q_v)
            _, entry = at_path_shapes(
                "coverage_value", "sampler_batch", "pallas_sim.py:51",
                {"sampler_batch": row["sim"]["launches"].get(
                    "sampler_batch", 0)},
                rows_cut(fs.sampler_batch, fs._sampler_batch_plain, k6_v, 2,
                         from_end=True), n_v - 1, ["xs"],
                lambda n: fs._sampler_batch_plain(k6_cpu[0][:n],
                                                  k6_cpu[1][:n], k6_cpu[2]),
                (n_v - 1) * n_val, k6_v, register=False,
                twin_steps=COVERAGE_VALUE_TWIN_STEPS, config=f"q={q_v}",
                step_outputs=(0,),
                shape=f"{n_v - 1} x {n_val}", q=q_v, model=model_v,
                **split_record("coverage_value", "sampler_batch",
                               f"sampler_batch q={q_v}", geo, per_sm=False,
                               match=lambda r: r.get("q") == q_v))
            check("coverage_value", f"sampler_batch q={q_v} bitwise",
                  entry["bitwise"])
            val_kernels.setdefault("sampler_batch", []).append(entry)
            del eps_v, eps_t_v, k6_v, k6_cpu
        del ops_v
        emit({"phase": "coverage_value", "part": "kernels",
              "fixture": name_v,
              "kernels": {k: [e for e in v if e["model"] == model_v
                              and e["q"] == q_v]
                          for k, v in val_kernels.items()},
              "seconds": time.perf_counter() - t_part})

    # the lockstep random walk over Chkrebtii's ODE at q = 4: 512 chains x
    # 20 steps, each position scaling x0, its likelihood the Gaussian fit
    # of x to the fixture's data (K1 and K6 a step)
    cfg_w, _ = cov_ref.fixture_config("chkrebtii_q4", torch.float32, dev)
    obs_w = cov_ref.value_obs("chkrebtii_q4", mu64_value["chkrebtii_q4"],
                              torch.float32, dev, seed=29)
    idx_w = obs_indices(0.0, cfg_w["t_max"], cfg_w["n_steps"],
                        obs_w["obs_times"]).to(dev)
    y_w = obs_w["obs_data"][:, 0, 0]

    def walk_loglik(positions, paths):
        return -0.5 * torch.sum((paths[idx_w, 0, 0] - y_w[:, None]) ** 2,
                                dim=0) / cov_ref.VALUE_OBS_VAR \
            - 0.5 * positions[:, 0] ** 2

    n_rw_v, s_rw_v = 512, 20
    runner_v = tpar.make_chain_runner(
        walk_loglik, n_rw_v, s_rw_v, 1e-3, cfg_w["ode_weight"],
        cfg_w["ode_init"], 0.0, cfg_w["t_max"], cfg_w["n_steps"],
        cfg_w["prior_pars"], "chkrebtii",
        position_to_init=lambda p: cfg_w["ode_init"] * (1 + p[:, :, None]),
        device=dev)
    (pos_v, ll_v, acc_v), sec_v, counts_v, peak_v = timed_run(
        lambda: runner_v(torch.zeros((n_rw_v, 1), device=dev),
                         torch.Generator(dev).manual_seed(32)))
    walk_ok = [
        check("coverage_value", "chkrebtii q=4 random walk launches",
              counts_v == expect(filter_batch=s_rw_v + 1,
                                 sampler_batch=s_rw_v + 1)),
        check("coverage_value", "chkrebtii q=4 random walk finite",
              finite(pos_v, ll_v))]
    emit({"phase": "coverage_value", "part": "random_walk",
          "model": "chkrebtii", "q": 4, "n_steps": cfg_w["n_steps"],
          "n_chains": n_rw_v, "n_samples": s_rw_v,
          "launches": launched(counts_v), "walk_seconds": sec_v,
          "chain_steps_per_s": n_rw_v * s_rw_v / sec_v,
          "mean_accept": acc_v.mean().item(), "peak_mem_bytes": peak_v,
          "ok": all(walk_ok)})
    del pos_v, ll_v, acc_v
    for key_v, entries_v in val_kernels.items():
        kernels[key_v]["instances"] = entries_v
    val_s = time.perf_counter() - t_phase
    check("coverage_value", f"phase within {COVERAGE_VALUE_PHASE_S} s",
          val_s <= COVERAGE_VALUE_PHASE_S)
    emit({"phase": "coverage_value", "seconds": val_s,
          "limit_s": COVERAGE_VALUE_PHASE_S})

    # ---- 27. coverage_grad: K11a, K11b and K11e at every instance -------
    t_phase = time.perf_counter()
    n_cg = 2048
    cg_kernels = {}         # kernel key -> [instance entries]
    k11a_names = ["A", "b", "C", "m_last", "p_last"]

    def grad_rel(g, g64):
        """bench.py's audit_grad: the relative L2 error of the gradient g
        against g64 (the norm of g where g64 is zero)."""
        g, g64 = np.asarray(g, np.float64), np.asarray(g64, np.float64)
        norm = np.linalg.norm(g64)
        return float(np.linalg.norm(g - g64) / norm) if norm > 0 \
            else float(np.linalg.norm(g))

    def cg_audit(label, lane0, truth_v, control, phase="coverage_grad"):
        """bench.py's rules on lane 0 against the float64 torch-op: the
        value by the likelihood rule, or a gradient (lane0 and truth_v
        lists) by audit_grad's relative L2 error, recorded as unusable in
        float32 where its CPU control exceeds GRAD_CONTROL_MAX."""
        if not isinstance(lane0, list):
            err = abs(lane0 - truth_v)
            tol = max(3 * control, LL_REL_FLOOR * abs(truth_v))
            return {"lane0": lane0, "f64": truth_v, "abs_err": err,
                    "control_f32cpu": control, "tol": tol,
                    "ok": check(phase, f"{label} value audit", err <= tol)}
        rel = grad_rel(lane0, truth_v)
        unusable = control > GRAD_CONTROL_MAX
        tol = max(3 * control, GRAD_FLOOR)
        return {"lane0": lane0, "f64": truth_v, "rel_err": rel,
                "control_f32cpu": control, "tol": tol,
                "theta_rounding_rel": 0.0, "f32_unusable": unusable,
                "within_rule": rel <= tol,
                "ok": True if unusable else check(
                    phase, f"{label} gradient audit", rel <= tol)}

    for name_g, (model_g, q_g, n_g, t_g) in cov_ref.GRAD_FIXTURES.items():
        t_part = time.perf_counter()
        cfg_g, (thetas_g, inits_g), obs_g, var_g = cov_ref.grad_fixture(
            name_g, n_cg, torch.float32, dev, mu64=mu64_value.get(name_g))
        fused_g = fk.resolve_model(model_g)
        nb_g, n_tan_g = fused_g.n_block, thetas_g.shape[1]
        nt_g = q_g * (q_g + 1) // 2
        lead_g = (thetas_g, cfg_g["ode_weight"], inits_g, 0.0, t_g, n_g,
                  cfg_g["prior_pars"])
        ops_g = fk._kernel_operands(*lead_g)
        cpu_g = cpu_lanes(ops_g, ("x0_lanes", "theta_lanes"))
        split_a = [(q_g * q_g, 1), (q_g, 1), (nt_g, 1), (q_g, 0), (nt_g, 0)]
        for mode_g in cov_ref.VALUE_MODES:
            label_g = f"{name_g}/{mode_g}"
            kw_g = dict(model=model_g, interrogation=mode_g, device=dev)
            basic_g = dict(obs_data=obs_g["obs_data"],
                           obs_times=obs_g["obs_times"],
                           obs_loglik=cov_ref.gauss_loglik(var_g))
            calls_g = cov_ref.grad_float32_calls(name_g, mode_g, thetas_g,
                                                 inits_g, obs_g, var_g, dev)
            values_g = {
                "fenrir": lambda: ff.fenrir_fused_batch(*lead_g, **obs_g,
                                                        **kw_g),
                "basic": lambda: fk.basic_fused_batch(*lead_g, **basic_g,
                                                      **kw_g),
                "solve": lambda: fk.solve_mv_fused_batch(*lead_g, **kw_g)}
            tan_e = expect(filter_batch_tan=1, smoother_mean_batch_tan=1)
            expected_g = {"fenrir": expect(filter_batch_tan=1,
                                           fenrir_backward_batch_tan=1),
                          "basic": tan_e, "solve": tan_e}
            ref_g = cov_ref.grad_float64(name_g, mode_g, thetas_g[0],
                                         inits_g[0], obs_g, var_g, dev)
            row = {"fixture": name_g, "model": model_g, "q": q_g,
                   "mode": mode_g, "n_steps": n_g, "n_lane": n_cg,
                   "n_theta": n_tan_g}
            for entry_g in ("fenrir", "basic", "solve"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                out_g = calls_g[entry_g]()
                torch.cuda.synchronize()
                got_g = read_counts()
                check("coverage_grad", f"{label_g} {entry_g} launches",
                      got_g == expected_g[entry_g])
                check("coverage_grad", f"{label_g} {entry_g} finite",
                      finite(*out_g))
                val_g = values_g[entry_g]()
                same = {"fenrir": lambda: torch.equal(out_g[0], val_g),
                        "basic": lambda: torch.equal(out_g[0], val_g[0])
                        and torch.equal(out_g[2], val_g[1]),
                        "solve": lambda: torch.equal(out_g[0],
                                                     val_g[0])}[entry_g]()
                rec = {"launches": launched(got_g),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "values_bitwise": check(
                           "coverage_grad", f"{label_g} {entry_g} values "
                           "bitwise the value call's", same)}
                if entry_g != "solve":
                    ctrl = GRAD_F32_CPU_ERR[label_g][entry_g]
                    rec["value"] = cg_audit(
                        f"{label_g} {entry_g}", float(out_g[0][0]),
                        ref_g[entry_g][0], ctrl["value"])
                    rec["grad"] = cg_audit(
                        f"{label_g} {entry_g}",
                        out_g[1][0].double().cpu().tolist(),
                        ref_g[entry_g][1], ctrl["grad"])
                del out_g, val_g
                rec["call_ms"] = cuda_ms(calls_g[entry_g], repeats=3)
                rec["value_call_ms"] = cuda_ms(values_g[entry_g], repeats=3)
                rec["ratio_to_value_call"] = \
                    rec["call_ms"] / rec["value_call_ms"]
                rec["per_lane_us"] = 1e3 * rec["call_ms"] / n_cg
                row[entry_g] = rec
            emit({"phase": "coverage_grad", "part": "calls", **row})

            # K11a's instance of this model, mode and q alone at these
            # shapes, against its twin over COVERAGE_GRAD_TWIN_STEPS steps
            geo = fk._filter_batch_tan_geometry(model_g, n_cg, mode_g, q_g)
            out_a, entry = at_path_shapes(
                "coverage_grad", "filter_batch_tan", "pallas_fenrir.py:614",
                {"filter_batch_tan": row["fenrir"]["launches"].get(
                    "filter_batch_tan", 0)},
                steps_cut(fk.fused_filter_batch_tan,
                          fk._filter_batch_tan_plain, fused_g, **ops_g,
                          mode=mode_g), n_g, k11a_names,
                lambda n: fk._filter_batch_tan_plain(
                    fused_g, n, **{**cpu_g, "tgrid": cpu_g["tgrid"][:n]},
                    mode=mode_g),
                n_g * n_cg, tensors(ops_g), split=split_a,
                step_outputs=(0, 1, 2), repeats=3, register=False,
                twin_steps=COVERAGE_GRAD_TWIN_STEPS,
                config=f"{model_g}/{mode_g}/q={q_g}",
                source="filter_batch_tan.cuh", shape=f"{n_g} x {n_cg}",
                model=model_g, mode=mode_g, q=q_g, n_tan=n_tan_g,
                **split_record(
                    "coverage_grad", "filter_batch_tan",
                    f"filter_batch_tan {model_g}/{mode_g}/q={q_g}", geo,
                    per_sm=False,
                    match=lambda r: r.get("model") == fused_g.cuda_functor
                    and r.get("q") == q_g
                    and r.get("mode") == fk._MODES[mode_g]))
            k1_g = fk.fused_filter_batch(fused_g, n_g, **ops_g, mode=mode_g)
            entry["values_bitwise"] = all(
                torch.equal(a.narrow(a.dim() - 3, 0, k), v)
                for a, v, (k, _) in zip(out_a, k1_g, split_a))
            check("coverage_grad", f"filter_batch_tan {model_g}/{mode_g}/"
                  f"q={q_g} bitwise, values K1's",
                  entry["bitwise"] and entry["values_bitwise"])
            cg_kernels.setdefault("filter_batch_tan", []).append(entry)
            del k1_g
            if model_g == "fitzhugh":
                # K1's instance of FitzHugh-Nagumo at this q and mode
                geo = fk._filter_batch_geometry(model_g, n_cg, mode_g, q_g)
                _, entry = at_path_shapes(
                    "coverage_grad", "filter_batch", "pallas_kalman.py:1141",
                    {"filter_batch": 1},
                    steps_cut(fk.fused_filter_batch, fk._filter_batch_plain,
                              fused_g, **ops_g, mode=mode_g), n_g, k1_names,
                    lambda n: fk._filter_batch_plain(
                        fused_g, n, **{**cpu_g, "tgrid": cpu_g["tgrid"][:n]},
                        mode=mode_g),
                    n_g * n_cg, tensors(ops_g), step_outputs=(0, 1, 2),
                    repeats=3, register=False,
                    twin_steps=COVERAGE_GRAD_TWIN_STEPS,
                    config=f"{model_g}/{mode_g}/q={q_g}",
                    source="filter_batch.cuh",
                    shape=f"{n_g} x {n_cg}", model=model_g, mode=mode_g,
                    q=q_g, **split_record(
                        "coverage_grad", "filter_batch",
                        f"filter_batch {model_g}/{mode_g}/q={q_g}", geo,
                        per_sm=False, match=lambda r: r.get("model")
                        == fused_g.cuda_functor and r.get("q") == q_g
                        and r.get("mode") == fk._MODES[mode_g]))
                check("coverage_grad", f"filter_batch {model_g}/{mode_g}/"
                      f"q={q_g} bitwise", entry["bitwise"])
                cg_kernels.setdefault("filter_batch", []).append(entry)
            if mode_g != "kramer":
                del out_a
                continue
            # once a (q, directions): K11e on K11a's chain, and K11b on the
            # fenrir gradient's
            A_g, b_g, _, mN_g, _ = out_a
            e_args = (b_g[1:], A_g[1:], mN_g)
            e_cpu = [cpu_lane(t) for t in e_args]
            geo = fk._smoother_mean_batch_tan_geometry(nb_g * n_cg, n_tan_g,
                                                       q_g)
            _, entry = at_path_shapes(
                "coverage_grad", "smoother_mean_batch_tan",
                "pallas_kalman.py:1963",
                {"smoother_mean_batch_tan": row["basic"]["launches"].get(
                    "smoother_mean_batch_tan", 0)},
                rows_cut(fk.smoother_mean_recursion_batch_tan,
                         fk._smoother_mean_tan_plain, (*e_args, n_tan_g), 2,
                         from_end=True), n_g - 1, ["ms"],
                lambda n: fk._smoother_mean_tan_plain(
                    e_cpu[0][:n], e_cpu[1][:n], e_cpu[2], n_tan_g),
                (n_g - 1) * n_cg, e_args, split=[(q_g, 1)],
                step_outputs=(0,), repeats=3, register=False,
                twin_steps=COVERAGE_GRAD_TWIN_STEPS,
                config=f"q={q_g} n_tan={n_tan_g}",
                shape=f"{n_g - 1} x {n_cg}", model=model_g, q=q_g,
                n_tan=n_tan_g, geometry=geo, ptxas=[
                    r for r in ptxas_report("24smoother_mean_tan_kernel")
                    if r.get("q") == q_g])
            check("coverage_grad", f"smoother_mean_batch_tan q={q_g} "
                  f"n_tan={n_tan_g} bitwise", entry["bitwise"])
            check("coverage_grad", f"smoother_mean_batch_tan q={q_g} "
                  "spills nothing", entry["ptxas"] and all(
                      r.get("spill_stores") == 0 for r in entry["ptxas"]))
            cg_kernels.setdefault("smoother_mean_batch_tan", []).append(entry)
            del out_a, A_g, b_g, mN_g, e_args, e_cpu
            chain_g = ff._fenrir_operands(fused_g, n_g, 0.0, t_g, ops_g,
                                          *obs_g.values(), mode_g,
                                          tangent=True)
            chain_cpu_g = chain_on_cpu(chain_g)

            def tan_plain_g(*chain, n_tan=n_tan_g):
                return chain[-1] + fd._block_sum(
                    ff._fenrir_backward_tan_plain(*chain[:-1], n_tan)
                    .movedim(-2, 0))

            n_ops_b = n_cg * grid_ops(chain_cpu_g[6], lambda idx: op_count(
                lambda: ff._fenrir_backward_tan_plain(
                    *[t[idx] for t in chain_cpu_g[:7]], *chain_cpu_g[7:],
                    n_tan_g)))
            geo = ff._fenrir_backward_batch_tan_geometry(nb_g, n_cg, n_tan_g,
                                                         q_g)
            _, entry = at_path_shapes(
                "coverage_grad", "fenrir_backward_batch_tan",
                "pallas_fenrir.py:772",
                {"fenrir_backward_batch_tan": row["fenrir"]["launches"].get(
                    "fenrir_backward_batch_tan", 0)},
                rows_cut(ff.fenrir_backward_batch_tan, tan_plain_g, chain_g,
                         7, from_end=True), n_g, ["ld"], None, None, chain_g,
                n_ops=n_ops_b, split=[(1, 0)],
                out_bytes=4 * (1 + n_tan_g) * nb_g * n_cg, repeats=3,
                register=False, twin_steps=COVERAGE_GRAD_TWIN_STEPS,
                config=f"q={q_g} n_tan={n_tan_g}",
                source="fenrir_backward_batch_tan.cuh",
                shape=f"{n_g} x {n_cg}", model=model_g, q=q_g,
                n_tan=n_tan_g, **split_record(
                    "coverage_grad", "fenrir_backward_batch_tan",
                    f"fenrir_backward_batch_tan q={q_g} n_tan={n_tan_g}",
                    geo, per_sm=False,
                    match=lambda r: r.get("q") == q_g
                    and r.get("n_tan") == n_tan_g))
            check("coverage_grad", f"fenrir_backward_batch_tan q={q_g} "
                  f"n_tan={n_tan_g} bitwise", entry["bitwise"])
            cg_kernels.setdefault("fenrir_backward_batch_tan",
                                  []).append(entry)
            del chain_g, chain_cpu_g
        del ops_g, cpu_g
        emit({"phase": "coverage_grad", "part": "kernels",
              "fixture": name_g,
              "kernels": {k: [e for e in v if e["model"] == model_g
                              and e["q"] == q_g]
                          for k, v in cg_kernels.items()},
              "seconds": time.perf_counter() - t_part})

    # MALA over fenrir on Hes1 under kramer (K11a and K11b a step, its
    # Jacobian on nested Duals): 128 lanes x 20 steps
    cfg_h, (thetas_h, _), obs_h, _ = cov_ref.grad_fixture(
        "hes1", 128, torch.float32, dev, mu64=mu64_value["hes1"])
    n_mh, s_mh = 128, 20
    solver_h = dict(ode_weight=cfg_h["ode_weight"],
                    ode_init=cfg_h["ode_init"], t_min=0.0,
                    t_max=cfg_h["t_max"], n_steps=cfg_h["n_steps"],
                    prior_pars=cfg_h["prior_pars"])
    (pos_h, ll_h, acc_h), sec_h, counts_h, peak_h = timed_run(
        lambda: tpar.run_chains_mala_fused(
            thetas_h, torch.Generator(dev).manual_seed(34), s_mh,
            GRAD_MALA_STEP, model="hes1", likelihood="fenrir", device=dev,
            **solver_h, **obs_h))
    fresh_h = ff.fenrir_fused_batch(
        pos_h[-1], cfg_h["ode_weight"],
        cfg_h["ode_init"].expand((n_mh,) + cfg_h["ode_init"].shape), 0.0,
        cfg_h["t_max"], cfg_h["n_steps"], cfg_h["prior_pars"], **obs_h,
        model="hes1", device=dev)
    mala_h_ok = [
        check("coverage_grad", "Hes1 MALA launches",
              counts_h == expect(filter_batch_tan=s_mh + 1,
                                 fenrir_backward_batch_tan=s_mh + 1)),
        check("coverage_grad", "Hes1 MALA finite", finite(pos_h, ll_h)),
        check("coverage_grad", "Hes1 MALA carried log-density bitwise",
              torch.equal(fresh_h, ll_h))]
    emit({"phase": "coverage_grad", "runner": "run_chains_mala_fused",
          "likelihood": "fenrir", "model": "hes1", "mode": "kramer",
          "n_lane": n_mh, "n_samples": s_mh, "step_size": GRAD_MALA_STEP,
          "launches": launched(counts_h), "seconds": sec_h,
          **rates(n_mh * s_mh, sec_h, pos_h[..., 0]),
          "mean_accept": acc_h.mean().item(), "peak_mem_bytes": peak_h,
          "ok": all(mala_h_ok)})
    del pos_h, ll_h, acc_h, fresh_h
    for key_g, entries_g in cg_kernels.items():
        kernels[key_g].setdefault("instances", []).extend(entries_g)
    grad_s = time.perf_counter() - t_phase
    check("coverage_grad", f"phase within {COVERAGE_GRAD_PHASE_S} s",
          grad_s <= COVERAGE_GRAD_PHASE_S)
    emit({"phase": "coverage_grad", "seconds": grad_s,
          "limit_s": COVERAGE_GRAD_PHASE_S})

    # ---- 28. coverage_dalton: K11c at every instance, K8 on FitzHugh-Nagumo
    # at q = 4 and 5 -------------------------------------------------------
    t_phase = time.perf_counter()
    n_cd = 2048
    cd_kernels = {}         # kernel key -> [instance entries]
    cd_pending = []         # (label, witness future, truth, controls)

    def cd_witness(label, result, truth, ctrl, phase="coverage_dalton"):
        """The float64 witness of an unusable float32 result: K11c's (or
        K8's, K9's and K11d's) twins in float64 on lane 0's float32
        operands, result = (value, gradient or None), against the float64
        truth, within max(3 x the tool's CPU error of the same comparison,
        LL_REL_FLOOR x |truth|) for the value and max(3 x it, GRAD_FLOOR)
        for the gradient's relative L2 error."""
        v64, g64 = result
        v64 = float(v64[0])
        err = abs(v64 - truth[0])
        v_tol = max(3 * ctrl["value"], LL_REL_FLOOR * abs(truth[0]))
        out = {"value": v64, "abs_err": err, "tol": v_tol,
               "control_f64cpu": ctrl["value"],
               "ok": check(phase, f"{label} float64 twins' "
                           "value against the truth", err <= v_tol)}
        if g64 is not None:
            rel = grad_rel(g64[0], truth[1])
            g_tol = max(3 * ctrl["grad"], GRAD_FLOOR)
            out.update(grad=g64[0].tolist(), grad_rel_err=rel,
                       grad_tol=g_tol, grad_control_f64cpu=ctrl["grad"])
            out["ok"] = check(phase, f"{label} float64 twins' "
                              "gradient against the truth",
                              rel <= g_tol) and out["ok"]
        return out

    # the float64 witnesses first, on the host, beside the work on the card
    fixtures_d = {}
    pool = ProcessPoolExecutor(DALTON_WITNESS_WORKERS, mp_context=spawn)
    try:
        witnesses = {}
        for name_d, (model_d, q_d, n_d, t_d) in cov_ref.GRAD_FIXTURES.items():
            fix = cov_ref.grad_fixture(name_d, n_cd, torch.float32, dev,
                                       mu64=mu64_value.get(name_d))
            _, (thetas_d, inits_d), obs_d, _ = fix
            prep = cov_ref.dalton_operands(name_d, thetas_d, inits_d, obs_d,
                                           dev)
            fixtures_d[name_d] = fix, prep
            ops_d, grid_d, ld0_d = prep
            for mode_d in cov_ref.VALUE_MODES:
                if "f64_twins" not in GRAD_F32_CPU_ERR[
                        f"{name_d}/{mode_d}"]["dalton"]:
                    continue
                witnesses[f"{name_d}/{mode_d}"] = pool.submit(
                    cov_ref.dalton_float64_twins, model_d, mode_d, n_d,
                    cpu_lanes(ops_d, ("x0_lanes", "theta_lanes")),
                    {k: v.cpu() for k, v in grid_d.items()},
                    cpu_lane(ld0_d), tangent=model_d != "chkrebtii")

        for name_d, (model_d, q_d, n_d, t_d) in cov_ref.GRAD_FIXTURES.items():
            t_part = time.perf_counter()
            (cfg_d, (thetas_d, inits_d), obs_d, var_d), prep = \
                fixtures_d.pop(name_d)
            ops_d, grid_d, ld0_d = prep
            fused_d = fk.resolve_model(model_d)
            n_tan_d = fused_d.n_theta
            lead_d = (thetas_d, cfg_d["ode_weight"], inits_d, 0.0, t_d, n_d,
                      cfg_d["prior_pars"])
            # the cut with data holds a step with data
            first_data = int((grid_d["mask"] != 0).nonzero()[0])
            twin_steps = {True: max(COVERAGE_GRAD_TWIN_STEPS,
                                    first_data + 2),
                          False: COVERAGE_GRAD_TWIN_STEPS}
            for mode_d in cov_ref.VALUE_MODES:
                label_d = f"{name_d}/{mode_d}"
                ctrl_d = GRAD_F32_CPU_ERR[label_d]["dalton"]
                call_d = cov_ref.grad_float32_calls(
                    name_d, mode_d, thetas_d, inits_d, obs_d, var_d,
                    dev)["dalton"]
                value_d = functools.partial(
                    fd.dalton_fused_batch, *lead_d, **obs_d, model=model_d,
                    interrogation=mode_d, device=dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                k11c_obs = {}
                with split_by_obs("dalton_filter_batch_tan", k11c_obs):
                    ll_d, g_d = call_d()
                torch.cuda.synchronize()
                got_d = read_counts()
                k11c_obs = dict(k11c_obs)
                check("coverage_dalton", f"{label_d} launches",
                      got_d == expect(dalton_filter_batch_tan=2))
                check("coverage_dalton", f"{label_d} launches by with_obs",
                      k11c_obs == {True: 1, False: 1})
                val_d = value_d()
                fin = torch.isfinite(val_d)
                pair = finite_part(ll_d, val_d)
                row = {"fixture": name_d, "model": model_d, "q": q_d,
                       "mode": mode_d, "n_steps": n_d, "n_lane": n_cd,
                       "n_theta": n_tan_d, "launches": launched(got_d),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "nonfinite_lanes": int((~fin).sum()),
                       "finite_where_k8_is": check(
                           "coverage_dalton", f"{label_d} finite wherever "
                           "K8 is", bool(fin.any()) and torch.equal(
                               torch.isfinite(ll_d), fin)
                           and finite(g_d[fin])),
                       "values_bitwise": check(
                           "coverage_dalton", f"{label_d} values bitwise "
                           "the value call's",
                           pair is not None and torch.equal(*pair))}
                truth_d = cov_ref.grad_float64(
                    name_d, mode_d, thetas_d[0], inits_d[0], obs_d, var_d,
                    dev, fns=("dalton",))["dalton"]
                row["value"] = lane0_audit(label_d, float(ll_d[0]),
                                           truth_d[0], ctrl_d["value"],
                                           phase="coverage_dalton")
                if model_d == "chkrebtii":
                    # no parameter: the gradient is exactly zero
                    row["grad"] = {"all_zero": check(
                        "coverage_dalton", f"{label_d} gradient exactly "
                        "zero", bool((g_d == 0).all()))}
                else:
                    row["grad"] = cg_audit(
                        label_d, g_d[0].double().cpu().tolist(), truth_d[1],
                        ctrl_d["grad"], phase="coverage_dalton")
                if row["value"]["f32_unusable"] or \
                        row["grad"].get("f32_unusable"):
                    got = label_d in witnesses
                    check("coverage_dalton", f"{label_d} float64 witness "
                          "submitted", got)
                    if got:
                        cd_pending.append((label_d, witnesses.pop(label_d),
                                           truth_d, ctrl_d["f64_twins"]))
                del val_d, ll_d, g_d
                row["call_ms"] = cuda_ms(call_d, repeats=3)
                row["value_call_ms"] = cuda_ms(value_d, repeats=3)
                row["ratio_to_value_call"] = \
                    row["call_ms"] / row["value_call_ms"]
                row["per_lane_us"] = 1e3 * row["call_ms"] / n_cd
                emit({"phase": "coverage_dalton", "part": "calls", **row})

                # K11c's instance of this model, mode and q alone at these
                # shapes, with data and without, against its twin
                for with_obs in (True, False):
                    variant = "with_obs" if with_obs else "without_obs"
                    seed = torch.cat([ld0_d[None], ld0_d.new_zeros(
                        (n_tan_d, ld0_d.shape[0]))])
                    k11c_d = dict(**ops_d, **grid_d, mode=mode_d,
                                  with_obs=with_obs,
                                  ld0=seed if with_obs
                                  else torch.zeros_like(seed))
                    k11c_cpu = cpu_lanes(k11c_d, ("x0_lanes", "theta_lanes",
                                                  "ld0"))
                    n_tw = min(twin_steps[with_obs], n_d)
                    geo = fd._dalton_filter_batch_tan_geometry(
                        model_d, n_cd, mode_d, with_obs, q_d)
                    out_c, entry = at_path_shapes(
                        "coverage_dalton", "dalton_filter_batch_tan",
                        "pallas_dalton.py:246",
                        {"dalton_filter_batch_tan": k11c_obs[with_obs]},
                        steps_cut(fd.dalton_filter_batch_tan,
                                  fd._dalton_filter_tan_plain, fused_d,
                                  keys=GRID_KEYS, **k11c_d), n_d, ["ld"],
                        None, None, tensors(k11c_d), split=[(1, 0)],
                        n_ops=n_cd * dalton_ops(
                            k11c_cpu, lambda n, a: fd._dalton_filter_tan_plain(
                                fused_d, n, **a)),
                        repeats=3, register=False, twin_steps=n_tw,
                        config=f"{model_d}/{mode_d}/q={q_d} {variant}",
                        source="dalton_filter_batch_tan.cuh",
                        shape=f"{n_d} x {n_cd}", model=model_d, mode=mode_d,
                        q=q_d, n_tan=n_tan_d, variant=variant,
                        cut_holds_data=bool(
                            (grid_d["mask"][:n_tw] != 0).any()),
                        **split_record(
                            "coverage_dalton", "dalton_filter_batch_tan",
                            f"dalton_filter_batch_tan {model_d}/{mode_d}/"
                            f"q={q_d} {variant}", geo, per_sm=False,
                            waves=not geo["all_resident"]
                            and model_d == "seirah",
                            match=lambda r: r.get("model")
                            == fused_d.cuda_functor and r.get("q") == q_d
                            and r.get("mode") == fk._MODES[mode_d]
                            and r.get("with_obs") == with_obs))
                    k8_ld = fd.dalton_filter_batch(
                        fused_d, n_d, **{**k11c_d, "ld0": k11c_d["ld0"][0]})
                    entry["values_bitwise"] = torch.equal(out_c[0][0], k8_ld)
                    check("coverage_dalton", f"dalton_filter_batch_tan "
                          f"{model_d}/{mode_d}/q={q_d} {variant} bitwise, "
                          "values K8's",
                          entry["bitwise"] and entry["values_bitwise"])
                    if with_obs:
                        check("coverage_dalton", f"dalton_filter_batch_tan "
                              f"{model_d}/{mode_d}/q={q_d} cut holds a step "
                              "with data", entry["cut_holds_data"])
                    cd_kernels.setdefault(
                        f"dalton_filter_batch_tan/{variant}",
                        []).append(entry)
                    del out_c, k8_ld, k11c_d, k11c_cpu
                    if model_d != "fitzhugh":
                        continue
                    # K8's instance of FitzHugh-Nagumo at this q and mode
                    k8_d = dict(**ops_d, **grid_d, mode=mode_d,
                                with_obs=with_obs,
                                ld0=ld0_d if with_obs
                                else torch.zeros_like(ld0_d))
                    k8_cpu = cpu_lanes(k8_d, ("x0_lanes", "theta_lanes",
                                              "ld0"))
                    geo = fd._dalton_filter_batch_geometry(
                        model_d, n_cd, mode_d, with_obs, q_d)
                    _, entry = at_path_shapes(
                        "coverage_dalton", "dalton_filter_batch",
                        "pallas_dalton.py:41", {"dalton_filter_batch": 1},
                        steps_cut(fd.dalton_filter_batch,
                                  fd._dalton_filter_plain, fused_d,
                                  keys=GRID_KEYS, **k8_d), n_d, ["ld"],
                        None, None, tensors(k8_d), repeats=3,
                        register=False, twin_steps=n_tw,
                        n_ops=n_cd * dalton_ops(
                            k8_cpu, lambda n, a: fd._dalton_filter_plain(
                                fused_d, n, **a)),
                        config=f"{model_d}/{mode_d}/q={q_d} {variant}",
                        shape=f"{n_d} x {n_cd}", model=model_d, mode=mode_d,
                        q=q_d, variant=variant,
                        cut_holds_data=bool(
                            (grid_d["mask"][:n_tw] != 0).any()),
                        **split_record(
                            "coverage_dalton", "dalton_filter_batch",
                            f"dalton_filter_batch {model_d}/{mode_d}/"
                            f"q={q_d} {variant}", geo, per_sm=False,
                            match=lambda r: r.get("model")
                            == fused_d.cuda_functor and r.get("q") == q_d
                            and r.get("mode") == fk._MODES[mode_d]
                            and r.get("with_obs") == with_obs))
                    check("coverage_dalton", f"dalton_filter_batch "
                          f"{model_d}/{mode_d}/q={q_d} {variant} bitwise",
                          entry["bitwise"])
                    cd_kernels.setdefault(f"dalton_filter_batch/{variant}",
                                          []).append(entry)
                    del k8_d, k8_cpu
            del ops_d, grid_d, ld0_d, prep
            emit({"phase": "coverage_dalton", "part": "kernels",
                  "fixture": name_d,
                  "kernels": {k: [e for e in v if e["model"] == model_d
                                  and e["q"] == q_d]
                              for k, v in cd_kernels.items()},
                  "seconds": time.perf_counter() - t_part})

        # MALA over DALTON on Hes1 under kramer (K11c a step with data and
        # one without, its Jacobian on nested Duals): 128 lanes x 20 steps
        cfg_h, (thetas_h, _), obs_h, _ = cov_ref.grad_fixture(
            "hes1", 128, torch.float32, dev, mu64=mu64_value["hes1"])
        n_mh, s_mh = 128, 20
        solver_h = dict(ode_weight=cfg_h["ode_weight"],
                        ode_init=cfg_h["ode_init"], t_min=0.0,
                        t_max=cfg_h["t_max"], n_steps=cfg_h["n_steps"],
                        prior_pars=cfg_h["prior_pars"])
        (pos_h, ll_h, acc_h), sec_h, counts_h, peak_h = timed_run(
            lambda: tpar.run_chains_mala_fused(
                thetas_h, torch.Generator(dev).manual_seed(35), s_mh,
                GRAD_MALA_STEP, model="hes1", likelihood="dalton",
                device=dev, **solver_h, **obs_h))
        fresh_h = fd.dalton_fused_batch(
            pos_h[-1], cfg_h["ode_weight"],
            cfg_h["ode_init"].expand((n_mh,) + cfg_h["ode_init"].shape),
            0.0, cfg_h["t_max"], cfg_h["n_steps"], cfg_h["prior_pars"],
            **obs_h, model="hes1", device=dev)
        mala_d_ok = [
            check("coverage_dalton", "Hes1 DALTON MALA launches",
                  counts_h == expect(dalton_filter_batch_tan=2 * (s_mh + 1))),
            check("coverage_dalton", "Hes1 DALTON MALA finite",
                  finite(pos_h, ll_h)),
            check("coverage_dalton", "Hes1 DALTON MALA carried log-density "
                  "bitwise", torch.equal(fresh_h, ll_h))]
        emit({"phase": "coverage_dalton", "runner": "run_chains_mala_fused",
              "likelihood": "dalton", "model": "hes1", "mode": "kramer",
              "n_lane": n_mh, "n_samples": s_mh,
              "step_size": GRAD_MALA_STEP, "launches": launched(counts_h),
              "seconds": sec_h, **rates(n_mh * s_mh, sec_h, pos_h[..., 0]),
              "mean_accept": acc_h.mean().item(), "peak_mem_bytes": peak_h,
              "ok": all(mala_d_ok)})
        del pos_h, ll_h, acc_h, fresh_h

        # the float64 witnesses, run on the host meanwhile
        t_w = time.perf_counter()
        witness_d = {label: cd_witness(label, fut.result(), truth, ctrl)
                     for label, fut, truth, ctrl in cd_pending}
        check("coverage_dalton", "every witness submitted is read",
              not witnesses)
        emit({"phase": "coverage_dalton", "part": "float64_witness",
              "workers": DALTON_WITNESS_WORKERS,
              "wait_s": time.perf_counter() - t_w, "witness": witness_d})
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for key_d, entries_d in cd_kernels.items():
        kernels[key_d].setdefault("instances", []).extend(entries_d)
    dalton_s = time.perf_counter() - t_phase
    check("coverage_dalton", f"phase within {COVERAGE_DALTON_PHASE_S} s",
          dalton_s <= COVERAGE_DALTON_PHASE_S)
    emit({"phase": "coverage_dalton", "seconds": dalton_s,
          "limit_s": COVERAGE_DALTON_PHASE_S})

    # ---- 29. coverage_daltonng: K9 and K11d at every instance -----------
    t_phase = time.perf_counter()
    n_cn = 2048
    cn_kernels = {}         # kernel key -> [instance entries]
    b0_pois, b1_pois = DALTONNG_POISSON

    def cn_unusable(label):
        """Whether the float32 twins' CPU error shows that float32 does not
        resolve lane 0's value or gradient (lane0_audit's and cg_audit's
        rules on DALTONNG_F32_CPU_ERR)."""
        ctrl = DALTONNG_F32_CPU_ERR[label]
        return (ctrl["value"] > VALUE_F32_UNUSABLE * abs(ctrl["float64"])
                or ctrl["grad"] > GRAD_CONTROL_MAX)

    def with_eigh_events(fn):
        """fn(), the milliseconds on the device of the torch.linalg.eigh
        calls it makes (daltonng's eigendecompositions at q = 4 and 5), by
        CUDA events around each, and the matrices they take."""
        events, eigh = [], torch.linalg.eigh

        def timed(a, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = eigh(a, *args, **kw)
            end.record()
            events.append((start, end, a.shape[0]))
            return out

        torch.linalg.eigh = timed
        try:
            out = fn()
        finally:
            torch.linalg.eigh = eigh
        torch.cuda.synchronize()
        return (out, sum(s.elapsed_time(e) for s, e, _ in events),
                sum(n for _, _, n in events))

    # the float64 truths and the witnesses in the pool's processes beside
    # the phase's checked calls: first the truths that judge lane 0, on the
    # card, then those that a float32-unusable result is only recorded
    # against, on the host, each with its witness
    futures_wait(pool_ready)
    emit({"phase": "coverage_daltonng", "part": "pool",
          "workers": DALTONNG_WORKERS,
          "start_s": max(f.result() for f in pool_ready) - t_pool})
    try:
        truths, witnesses, prep_n, host_jobs = {}, {}, {}, []
        for name_n in cov_ref.GRAD_FIXTURES:
            fix = cov_ref.grad_fixture(name_n, n_cn, torch.float32, dev,
                                       mu64=mu64_value.get(name_n))
            _, (thetas_n, inits_n), obs_n, var_n = fix
            lane0 = (thetas_n[0].cpu(), inits_n[0].cpu(),
                     {k: v.cpu() for k, v in obs_n.items()}, var_n)
            for mode_n in cov_ref.VALUE_MODES:
                label_n = f"{name_n}/{mode_n}"
                if cn_unusable(label_n):
                    host_jobs += [
                        (truths, label_n, cov_ref.daltonng_float64,
                         (name_n, mode_n, *lane0, "cpu")),
                        (witnesses, label_n, cov_ref.daltonng_lane0_twins,
                         (name_n, mode_n, *lane0))]
                else:
                    truths[label_n] = daltonng_pool.submit(
                        cov_ref.daltonng_float64, name_n, mode_n, *lane0,
                        "cuda")
            prep_n[name_n] = fix
        for into, label_n, fn, args in host_jobs:
            into[label_n] = daltonng_pool.submit(fn, *args)

        # the calls, checked, and the kernels' operations counted on the
        # CPU (untimed, while the truths run)
        rows_n, launches_n, grids_n, ops_count = {}, {}, {}, {}
        t_checked = time.perf_counter()
        for name_n, (model_n, q_n, n_n, t_n) in \
                cov_ref.GRAD_FIXTURES.items():
            cfg_n, (thetas_n, inits_n), obs_n, var_n = prep_n[name_n]
            args_n = cov_ref.daltonng_args(name_n, thetas_n, inits_n, obs_n,
                                           var_n)
            n_tan_n = fk.resolve_model(model_n).n_theta
            for mode_n in cov_ref.VALUE_MODES:
                label_n = f"{name_n}/{mode_n}"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                ll_n, g_n = fdn.daltonng_fused_batch_grad(
                    *args_n, interrogation=mode_n, device=dev)
                torch.cuda.synchronize()
                got_g = read_counts()
                peak_g = torch.cuda.max_memory_allocated()
                reset_counts()
                val_n = fdn.daltonng_fused_batch(
                    *args_n, interrogation=mode_n, device=dev)
                torch.cuda.synchronize()
                got_v = read_counts()
                launches_n[label_n] = {**got_v, **{
                    k: v for k, v in got_g.items() if v}}
                check("coverage_daltonng", f"{label_n} value launches",
                      got_v == expect(filter_nn_batch=1,
                                      smoother_batch_rows=1,
                                      filter_batch=1))
                check("coverage_daltonng", f"{label_n} gradient launches",
                      got_g == expect(filter_nn_batch_tan=1,
                                      smoother_mean_batch_tan=1,
                                      filter_batch_tan=1))
                fin = torch.isfinite(val_n)
                pair = finite_part(ll_n, val_n)
                row = {"fixture": name_n, "model": model_n, "q": q_n,
                       "mode": mode_n, "n_steps": n_n, "n_lane": n_cn,
                       "n_theta": n_tan_n, "launches": launched(got_g),
                       "value_launches": launched(got_v),
                       "peak_mem_bytes": peak_g,
                       "nonfinite_lanes": int((~fin).sum()),
                       "finite": check(
                           "coverage_daltonng", f"{label_n} finite but on "
                           "DALTONNG_NAN_LANES' lanes",
                           int((~fin).sum())
                           == DALTONNG_NAN_LANES.get(label_n, 0)
                           and torch.equal(torch.isfinite(ll_n), fin)
                           and finite(g_n[fin])),
                       "values_bitwise": check(
                           "coverage_daltonng", f"{label_n} values bitwise "
                           "the value call's",
                           pair is not None and torch.equal(*pair)),
                       "lane0": (float(ll_n[0]),
                                 g_n[0].double().cpu().tolist())}
                if model_n == "chkrebtii":
                    # no parameter: the gradient is exactly zero
                    row["grad"] = {"all_zero": check(
                        "coverage_daltonng", f"{label_n} gradient exactly "
                        "zero", bool((g_n == 0).all()))}
                rows_n[label_n] = row
                del val_n, ll_n, g_n
        # then the work on the host, while the truths on the card run: the
        # kernels alone take the path's Gaussian data and, where the rate
        # stays finite, Poisson counts at the same steps
        for name_n, (model_n, q_n, n_n, t_n) in \
                cov_ref.GRAD_FIXTURES.items():
            cfg_n, (thetas_n, inits_n), obs_n, var_n = prep_n[name_n]
            ops_n, grid_n, _, _ = fdn._daltonng_prepare(
                thetas_n, cfg_n["ode_weight"], inits_n, 0.0, t_n, n_n,
                cfg_n["prior_pars"], obs_n["obs_data"], obs_n["obs_times"])
            grids = {"Gauss": (obs_models.gauss(var_n), grid_n)}
            if model_n in DALTONNG_POISSON_MODELS:
                rng_n = np.random.default_rng(q_n)
                counts = torch.tensor(rng_n.poisson(
                    2.0, size=tuple(grid_n["y"].shape)), dtype=torch.float32,
                    device=dev) * grid_n["mask"][:, None]
                grids["Poisson"] = (obs_models.poisson(b0_pois, b1_pois),
                                    {**grid_n, "y": counts.contiguous()})
            grids_n[name_n] = ops_n, grids
            fused_n = fk.resolve_model(model_n)
            for mode_n in cov_ref.VALUE_MODES:
                for obs_name, (obs_k, grid_k) in grids.items():
                    nn_cpu = cpu_lanes({**ops_n, **grid_k},
                                       ("x0_lanes", "theta_lanes"))
                    for twin in (fdn._filter_nn_batch_plain,
                                 fdn._filter_nn_batch_tan_plain):
                        ops_count[name_n, mode_n, obs_name, twin] = \
                            n_cn * dalton_ops(
                                nn_cpu, lambda n, a, tw=twin: tw(
                                    fused_n, obs_k, (0,), n, **a,
                                    mode=mode_n), NN_GRID_KEYS)
        checked_s = time.perf_counter() - t_checked
        # the timed work waits for the truths on the card
        t_wait = time.perf_counter()
        futures_wait([truths[label] for label in rows_n
                      if not cn_unusable(label)])
        truth_wait_s = time.perf_counter() - t_wait

        for name_n, (model_n, q_n, n_n, t_n) in \
                cov_ref.GRAD_FIXTURES.items():
            t_part = time.perf_counter()
            cfg_n, (thetas_n, inits_n), obs_n, var_n = prep_n.pop(name_n)
            args_n = cov_ref.daltonng_args(name_n, thetas_n, inits_n, obs_n,
                                           var_n)
            fused_n = fk.resolve_model(model_n)
            n_tan_n = fused_n.n_theta
            nt_n = q_n * (q_n + 1) // 2
            for mode_n in cov_ref.VALUE_MODES:
                label_n = f"{name_n}/{mode_n}"
                row = rows_n[label_n]
                # each call timed once, the checked call its warm-up, with
                # the device time of its torch.linalg.eigh calls
                for key, entry in (
                        ("call", fdn.daltonng_fused_batch_grad),
                        ("value_call", fdn.daltonng_fused_batch)):
                    (_, eigh_ms, n_eigh), row[f"{key}_ms"] = cuda_once(
                        lambda: with_eigh_events(lambda: entry(
                            *args_n, interrogation=mode_n, device=dev)))
                    row.update({f"{key}_eigh_ms": eigh_ms,
                                f"{key}_eigh_matrices": n_eigh,
                                f"{key}_eigh_share":
                                    eigh_ms / row[f"{key}_ms"]})
                row["ratio_to_value_call"] = \
                    row["call_ms"] / row["value_call_ms"]
                row["per_lane_us"] = 1e3 * row["call_ms"] / n_cn
            ops_n, grids = grids_n.pop(name_n)
            grid_n = grids["Gauss"][1]
            # the cut holds a step with data (65 steps on Chkrebtii's ODE)
            first_data = int((grid_n["mask"] != 0).nonzero()[0])
            n_tw = min(max(COVERAGE_GRAD_TWIN_STEPS, first_data + 2), n_n)

            # K9's and K11d's instances of this model and q alone at these
            # shapes against their twins
            for mode_n in cov_ref.VALUE_MODES:
                for obs_name, (obs_k, grid_k) in grids.items():
                    nn_kw = dict(**ops_n, **grid_k, mode=mode_n)
                    config = f"{model_n}/{mode_n}/q={q_n}/{obs_name}"
                    on_path = obs_name == "Gauss"
                    outs = {}
                    for kernel, twin, wrapper, geometry, split in (
                            ("filter_nn_batch", fdn._filter_nn_batch_plain,
                             fdn.filter_nn_batch,
                             fdn._filter_nn_batch_geometry, None),
                            ("filter_nn_batch_tan",
                             fdn._filter_nn_batch_tan_plain,
                             fdn.filter_nn_batch_tan,
                             fdn._filter_nn_batch_tan_geometry,
                             [(q_n, 1), (nt_n, 1), (q_n, 1), (nt_n, 1)])):
                        geo = geometry(fused_n, obs_k, n_cn, mode_n, q_n)
                        launches = launches_n[f"{name_n}/{mode_n}"] \
                            if on_path else {kernel: 0}
                        outs[kernel], entry = at_path_shapes(
                            "coverage_daltonng", kernel,
                            "pallas_daltonng.py:"
                            + ("269" if kernel.endswith("tan") else "77"),
                            launches,
                            steps_cut(wrapper, twin, fused_n, obs_k, (0,),
                                      keys=NN_GRID_KEYS, **nn_kw), n_n,
                            nn_names, None, None,
                            tensors(ops_n) + tensors(grid_k), split=split,
                            n_ops=ops_count[name_n, mode_n, obs_name,
                                            twin],
                            repeats=3, register=False, twin_steps=n_tw,
                            config=config, source=f"{kernel}.cuh",
                            shape=f"{n_n} x {n_cn}", model=model_n,
                            mode=mode_n, q=q_n, obs=obs_name,
                            on_path=on_path, step_outputs=(0, 1, 2, 3),
                            cut_holds_data=bool(
                                (grid_k["mask"][:n_tw] != 0).any()),
                            **split_record(
                                "coverage_daltonng", kernel,
                                f"{kernel} {config}", geo, per_sm=False,
                                waves=not geo["all_resident"]
                                and model_n == "seirah",
                                match=lambda r: r.get("model")
                                == fused_n.cuda_functor
                                and r.get("q") == q_n
                                and r.get("mode") == fk._MODES[mode_n]
                                and r.get("obs") == obs_name))
                        check("coverage_daltonng", f"{kernel} {config} "
                              "bitwise", entry["bitwise"])
                        check("coverage_daltonng", f"{kernel} {config} cut "
                              "holds a step with data",
                              entry["cut_holds_data"])
                        cn_kernels.setdefault(kernel, []).append(entry)
                    entry["values_bitwise"] = check(
                        "coverage_daltonng", f"filter_nn_batch_tan {config} "
                        "values K9's", all(
                            torch.equal(a[:, :k], v) for a, v, k in zip(
                                outs["filter_nn_batch_tan"],
                                outs["filter_nn_batch"],
                                (q_n, nt_n, q_n, nt_n))))
                    del outs, nn_kw
            del ops_n, grid_n, grids, args_n
            emit({"phase": "coverage_daltonng", "part": "kernels",
                  "fixture": name_n,
                  "kernels": {k: [e for e in v if e["model"] == model_n
                                  and e["q"] == q_n]
                              for k, v in cn_kernels.items()},
                  "seconds": time.perf_counter() - t_part})

        # lane 0 against the float64 truths, and the float64 witnesses,
        # computed meanwhile
        t_w = time.perf_counter()
        witness_n = {}
        for label_n, row in rows_n.items():
            ctrl_n = DALTONNG_F32_CPU_ERR[label_n]
            truth_n = truths.pop(label_n).result()
            value, grad = row.pop("lane0")
            row["truth_device"] = "cpu" if cn_unusable(label_n) else "cuda"
            row["value"] = lane0_audit(label_n, value, truth_n[0],
                                       ctrl_n["value"],
                                       phase="coverage_daltonng")
            if "grad" not in row:
                row["grad"] = cg_audit(label_n, grad, truth_n[1],
                                       ctrl_n["grad"],
                                       phase="coverage_daltonng")
            if row["value"]["f32_unusable"] or \
                    row["grad"].get("f32_unusable"):
                got = label_n in witnesses
                check("coverage_daltonng", f"{label_n} float64 witness "
                      "submitted", got)
                if got:
                    witness_n[label_n] = cd_witness(
                        label_n, witnesses.pop(label_n).result(), truth_n,
                        ctrl_n["f64_twins"], phase="coverage_daltonng")
            emit({"phase": "coverage_daltonng", "part": "calls", **row})
        check("coverage_daltonng", "every witness submitted is read",
              not witnesses)
        emit({"phase": "coverage_daltonng", "part": "float64_witness",
              "workers": DALTONNG_WORKERS,
              "checked_calls_s": checked_s,
              "truth_wait_s": truth_wait_s,
              "wait_s": time.perf_counter() - t_w, "witness": witness_n})
    finally:
        daltonng_pool.shutdown(wait=True, cancel_futures=True)
    for key_n, entries_n in cn_kernels.items():
        kernels[key_n].setdefault("instances", []).extend(entries_n)
    daltonng_s = time.perf_counter() - t_phase
    check("coverage_daltonng",
          f"phase within {COVERAGE_DALTONNG_PHASE_S} s",
          daltonng_s <= COVERAGE_DALTONNG_PHASE_S)
    emit({"phase": "coverage_daltonng", "seconds": daltonng_s,
          "limit_s": COVERAGE_DALTONNG_PHASE_S})

    # ---- summary --------------------------------------------------------
    # the card and its power limit again, beside the numbers at the end
    print(smi, flush=True)
    emit({"phase": "seconds", "phases": dict(_CLOCK["phases"]),
          "total": time.perf_counter() - t_start})
    emit({"kernels": [kernels[name] for name in
                      VALUE_KERNELS + TAN_KERNELS + SINGLE_KERNELS
                      + MEAN_KERNELS + MAGI_KERNELS + NN_KERNELS]})
    if failures:
        print("chip_smoke.py: failed: " + "; ".join(failures),
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for started_pool in _POOLS:
            started_pool.shutdown(wait=True, cancel_futures=True)
    sys.exit(code)
