// K1: lane-batched forward filter of the probabilistic ODE solver, emitting
// the per-step smoothing gains (G, g, L) and the last filtered state.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _filter_kernel_batch (emit="gains"): the interrogations kramer, rodeo,
// schober and chkrebtii, the first-order models at q = 3 and the
// second-order Chkrebtii at q = 4 and 5 (dispatch.cuh's
// with_filter_instance).  Plain PyTorch twin: _filter_batch_plain in
// ops/fused_kalman.py.  The C entry points are filter_batch.cu's; the
// instances are compiled in one translation unit per (model, q),
// filter_instances_*.cu, which nvcc builds in parallel.
//
// Design.  One thread per (lane, block) carries its block of one lane (one
// independent solve) through all N steps in a single launch, split over the
// blocks as the tangent kernel K11a is, on block_step.cuh's step loop
// (split_filter_steps, which K3 runs on one lane).  The ODE
// right-hand side couples the blocks (Lorenz's f_y needs x and z), while the
// EK1 Jacobian is block-diagonal, so everything but the ODE evaluation runs
// block by block.  Each step a thread predicts its block through the
// constant scaled Pascal transition (kernel arguments, the float32 values
// the wrapper computed) plus the process noise, publishes its predicted mean
// to shared memory, forms and stores its block's smoothing gain of the
// transition n-1 -> n from the carry and the fresh prediction, and, after
// one barrier a step with the other blocks of its lane, evaluates the ODE
// (and column 0 of its Jacobian) at their gathered predicted means and does
// its block's scalar-innovation Joseph update.  The arithmetic is the
// twin's, operation for operation, so the outputs are the twin's bitwise.  Outputs are laid out (N, d,
// NB, B) with lanes innermost: a CTA holds 16 lanes, so a warp is 16
// consecutive lanes of each of two blocks, and each store is two coalesced
// 64-byte segments.  The arithmetic is float32 throughout, as on the TPU.
//
// What bounds it on the card.  A step is a chain of dependent float
// operations on one block, with the ODE at the gathered means, against 18
// floats stored per (block, lane), so the kernel is bound by the latency of
// that chain, not by device memory (its bound is the 18 x NB floats a step
// written per lane).  At 2048 lanes Lorenz63 runs 128 CTAs of 16 x 3 = 48
// threads, one on each of 128 of the card's 132 SMs.
//
// Under chkrebtii each thread draws its block's interrogation point from
// the predictive distribution with the streamed normals eps (N, q, NB, B)
// (block_step.cuh's draw_point) and publishes the draw in place of the
// predicted mean: the ODE couples the blocks, so every thread evaluates it
// at all blocks' draws.
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

// Lanes per CTA: 16, faster than 32 on the card (PERF.md)
constexpr int kFilterLanes = 16;

// At 2048 lanes the launch has 128 CTAs, fewer than the SMs, so an SM never
// holds a second one: the launch bounds ask for one CTA per SM, and ptxas
// spends registers on the chain instead of spilling to fit more CTAs.
template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(kFilterLanes * Model::NB, 1)
    filter_batch_kernel(QConst<Q> qc, int n_steps, int n_lane,
                        const float* __restrict__ R_in,
                        const float* __restrict__ W_in,
                        const float* __restrict__ tv_in,
                        const float* __restrict__ x0,
                        const float* __restrict__ theta,
                        const float* __restrict__ tgrid,
                        const float* __restrict__ eps,
                        float* __restrict__ G_out, float* __restrict__ g_out,
                        float* __restrict__ L_out, float* __restrict__ m_last,
                        float* __restrict__ p_last) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  __shared__ SharedMeans<float, NB, Q, kFilterLanes> xs;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int lane = blockIdx.x * kFilterLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no stores
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  // stride between consecutive rows of one (step, d) slab: NB blocks x B
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t base = b * static_cast<size_t>(n_lane) + off;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k * static_cast<size_t>(n_lane) + off];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[j * col + base];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;

  SharedExchange<NB, Q, kFilterLanes> ex{xs, tx};
  split_filter_steps<Model, Q>(
      c, tgrid, n_steps, b, ex, m, P,
      ode_point<Q, MODE>([eps, col, base](int n, int j) {
        return eps[(static_cast<size_t>(n) * Q + j) * col + base];
      }),
      ode_update<Model, Q, MODE>(c, th, b),
      // the gain of the transition n-1 -> n needs only the carry (filtered
      // n-1) and the fresh prediction (n)
      [&](int n, const float (&mc)[Q], const float (&Pc)[NT],
          const float (&mp)[Q], const float (&pp)[NT]) {
        float G[Q][Q], g[Q], L[NT];
        gain_cols<Q>(c.Qm, c.R, mc, Pc, mp, pp, G, g, L);
        if (live) {
#pragma unroll
          for (int i = 0; i < Q; ++i)
#pragma unroll
            for (int j = 0; j < Q; ++j)
              G_out[(static_cast<size_t>(n) * Q * Q + i * Q + j) * col + base] = G[i][j];
#pragma unroll
          for (int i = 0; i < Q; ++i)
            g_out[(static_cast<size_t>(n) * Q + i) * col + base] = g[i];
#pragma unroll
          for (int k = 0; k < NT; ++k)
            L_out[(static_cast<size_t>(n) * NT + k) * col + base] = L[k];
        }
      },
      [](int, const float (&)[Q], const float (&)[NT]) {});

  if (live) {
#pragma unroll
    for (int j = 0; j < Q; ++j) m_last[j * col + base] = m[j];
#pragma unroll
    for (int k = 0; k < NT; ++k) p_last[k * col + base] = P[k];
  }
}

// K1's instances of one (model, q), one for each interrogation mode
// (with_mode); a translation unit filter_instances_*.cu instantiates them.
template <class Model, int Q>
cudaError_t FilterBatchInstances<Model, Q>::launch(int mode,
                                                   const FilterBatchArgs& a,
                                                   cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  const SplitGeometry geo = split_geometry<Model, kFilterLanes>(a.n_lane, 1);
  return with_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    filter_batch_kernel<Model, Q, MODE><<<geo.grid, geo.block, 0, stream>>>(
        qc, a.n_steps, a.n_lane, a.R, a.W, a.tv, a.x0, a.theta, a.tgrid,
        a.eps, a.G, a.g, a.L, a.m_last, a.p_last);
    return cudaGetLastError();
  });
}

template <class Model, int Q>
cudaError_t FilterBatchInstances<Model, Q>::geometry(int mode, int n_lane,
                                                     int* out) {
  return with_mode(mode, [&](auto md) {
    return report_geometry(filter_batch_kernel<Model, Q, decltype(md)::value>,
                           split_geometry<Model, kFilterLanes>(n_lane, 1),
                           out);
  });
}

}  // namespace rodeo
