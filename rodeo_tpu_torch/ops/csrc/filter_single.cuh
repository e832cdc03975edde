// K3: the single-solve forward filter of the probabilistic ODE solver,
// storing the filtered and predicted moments of steps 1..N: mf, mp
// (N, NB, q) and packed pf, pp (N, NB, n_tri).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py: _filter_kernel:
// the interrogations kramer, rodeo, schober and chkrebtii (the normals eps
// (N, NB, q) under chkrebtii), the first-order models at q = 3 and the
// second-order Chkrebtii at q = 4 and 5, as K1 (dispatch.cuh's
// with_filter_instance).  Plain PyTorch twin: _filter_single_plain in
// ops/fused_kalman.py.  The C entry points are filter_single.cu's; the
// instances are compiled with K1's, filter_instances_*.cu.
//
// What bounds it on the card.  One solve is one chain of ~1e3 float
// operations a step through N steps, far above its byte bound (54 floats
// stored per step at 3 blocks, 2.2 MB at 10 000 steps, 0.65 us at 3.35
// TB/s): nothing in one solve runs beside the chain, so the kernel runs at
// the pace at which one warp issues the step's instructions and waits on
// their latencies.  Many solves at once are the lane-batched K1's work.
//
// Design.  K1's step split over the blocks (block_step.cuh's
// split_filter_steps) at a single lane: one CTA of NB threads (3 for
// Lorenz63), one per block of the solve, all in one warp.  Each thread
// predicts its own block, publishes its predicted mean, and after the
// step's one exchange evaluates the ODE on the gathered means (identical
// bits in every thread) and updates its own block
// (interrogate_update_block), so a thread's stream of instructions is
// about a third of the one thread's that carried all blocks; each thread
// stores its block's four moments of each step in the JAX package's (N,
// NB, d) layout, which the stores drain while the next step computes.  The
// means go from thread to thread by warp shuffles (ShuffleExchange): on the
// card, shared memory behind __syncwarp took 16 % longer (PERF.md).  The
// values are the twin's bitwise.  The TPU kernel's chunk grid (which streamed
// VMEM blocks to HBM) and its unroll option have no counterpart here.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "filter_instances.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(Model::NB, 1)
    filter_single_kernel(QConst<Q> qc, int n_steps,
                         const float* __restrict__ R_in,
                         const float* __restrict__ W_in,
                         const float* __restrict__ tv_in,
                         const float* __restrict__ x0,
                         const float* __restrict__ theta,
                         const float* __restrict__ tgrid,
                         const float* __restrict__ eps,
                         float* __restrict__ mf, float* __restrict__ pf,
                         float* __restrict__ mp_out, float* __restrict__ pp_out) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  const int b = threadIdx.x;
  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[b * Q + j];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;

  // block b's moments of step n (row n of the outputs)
  auto store = [&](float* mo, float* po, int n,
                   const float (&mv)[Q], const float (&Pv)[NT]) {
    const size_t row = static_cast<size_t>(n) * NB + b;
#pragma unroll
    for (int j = 0; j < Q; ++j) mo[row * Q + j] = mv[j];
#pragma unroll
    for (int k = 0; k < NT; ++k) po[row * NT + k] = Pv[k];
  };
  auto predicted = [&](int n, const float (&)[Q], const float (&)[NT],
                       const float (&mp)[Q], const float (&pp)[NT]) {
    store(mp_out, pp_out, n, mp, pp);
  };
  auto filtered = [&](int n, const float (&mv)[Q], const float (&Pv)[NT]) {
    store(mf, pf, n, mv, Pv);
  };
  ShuffleExchange<NB, Q> ex;
  split_filter_steps<Model, Q>(
      c, tgrid, n_steps, b, ex, m, P,
      ode_point<Q, MODE>([eps, b](int n, int j) {
        return eps[(static_cast<size_t>(n) * NB + b) * Q + j];
      }),
      ode_update<Model, Q, MODE>(c, th, b), predicted, filtered);
}

// one CTA of NB threads, a thread per block
template <class Model>
SplitGeometry single_geometry() {
  return {dim3(1), dim3(Model::NB)};
}


// K3's instances of one (model, q), one for each interrogation mode
// (with_mode); a translation unit filter_instances_*.cu instantiates them.
template <class Model, int Q>
cudaError_t FilterSingleInstances<Model, Q>::launch(int mode,
                                                    const FilterSingleArgs& a,
                                                    cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  const SplitGeometry geo = single_geometry<Model>();
  return with_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    filter_single_kernel<Model, Q, MODE><<<geo.grid, geo.block, 0, stream>>>(
        qc, a.n_steps, a.R, a.W, a.tv, a.x0, a.theta, a.tgrid, a.eps, a.mf,
        a.pf, a.mp, a.pp);
    return cudaGetLastError();
  });
}

template <class Model, int Q>
cudaError_t FilterSingleInstances<Model, Q>::geometry(int mode, int* out) {
  return with_mode(mode, [&](auto md) {
    return report_geometry(filter_single_kernel<Model, Q, decltype(md)::value>,
                           single_geometry<Model>(), out);
  });
}

}  // namespace rodeo
