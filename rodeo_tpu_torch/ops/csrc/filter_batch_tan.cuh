// K11a: the tangent twin of K1.  The lane-batched forward filter carries the
// derivative of its state along each theta direction and emits the
// smoothing gains (G, g, L) and the last filtered state with their
// tangents, stacked on the d axis as the TPU kernel stacks them: A (N,
// NAUG Q Q, NB, B), b (N, NAUG Q, ..), C (N, NAUG Tri, ..), m_last (NAUG Q,
// NB, B), p_last (NAUG Tri, NB, B), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _filter_kernel_batch_tan (emit="gains"), under kramer and rodeo on K1's
// (model, q): the first-order models at q = 3, FitzHugh-Nagumo also at q =
// 4 and 5, and the second-order Chkrebtii at q = 4 and 5 (dispatch.cuh's
// with_filter_instance).  Plain PyTorch twin: _filter_batch_tan_plain in
// ops/fused_kalman.py, which runs K1's twin on Duals (ops/dual.py).  The C
// entry points are filter_batch_tan.cu's; the instances are compiled in one
// translation unit per (model, q), filter_tan_instances_*.cu, which nvcc
// builds in parallel.
//
// Design.  K1's step on the forward-mode number Dual (dual.cuh), a value
// and one tangent, with theta seeded along the thread's direction and the
// initial state exact (zero tangent), split over the blocks of a lane
// (block_step.cuh): one thread per (lane, direction, block), which predicts
// its block, forms and stores its block's gains, and, after one barrier a
// step with the other blocks of its (lane, direction), evaluates the ODE at
// their gathered predicted means and updates its block.  The value part of
// each Dual is K1's float arithmetic, so the values equal K1's bitwise; the
// threads of direction 0 store them.  The earlier design ran one thread per
// (lane, direction) with all NB blocks in its registers: at 2048 lanes 64
// CTAs of 96 threads on 64 of the 132 SMs, 168 registers, and a chain of
// ~3e3 dependent operations a step; the split gives NB times the threads,
// each with a chain about 1/NB as long.  Under kramer a model without a
// hand-written Jacobian (Hes1, SEIRAH) takes its column on nested Duals,
// DualT<Dual> (jac0_own of block_step.cuh), as the twin's nested Duals do,
// where the TPU kernel nests jax.jvp.
//
// What bounds it on the card.  A step stores NAUG (Q Q + Q + Tri<Q>::N)
// floats per (block, lane), 72 at q = 3 and NAUG = 4 (A 36, b 12, C 24):
// 7.08 GB at 4000 steps x 3 blocks x 2048 lanes, 2.11 ms at 3.35 TB/s.  The kernel is still bound by the latency of
// each thread's chain (K1's step on one block and its tangent, and the ODE
// at the gathered means): at 2048 lanes Lorenz63 runs grid (64, 3) = 192
// CTAs of 32 x 3 = 96 threads, 18 432 threads, every CTA resident at once
// and every SM with one or two.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "dual.cuh"
#include "filter_instances.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 on the card (PERF.md)
constexpr int kFilterTanLanes = 32;

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(kFilterTanLanes * Model::NB)
    filter_batch_tan_kernel(QConst<Q> qc, int n_steps, int n_lane,
                            const float* __restrict__ R_in,
                            const float* __restrict__ W_in,
                            const float* __restrict__ tv_in,
                            const float* __restrict__ x0,
                            const float* __restrict__ theta,
                            const float* __restrict__ tgrid,
                            float* __restrict__ A_out,
                            float* __restrict__ b_out,
                            float* __restrict__ C_out,
                            float* __restrict__ m_last,
                            float* __restrict__ p_last) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  constexpr int NAUG = 1 + NTH;
  __shared__ SharedMeans<Dual, NB, Q, kFilterTanLanes> xs;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int dir = blockIdx.y;
  const int lane = blockIdx.x * kFilterTanLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no stores
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t base = b * static_cast<size_t>(n_lane) + off;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  Dual th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k)
    th[k] = Dual(theta[k * static_cast<size_t>(n_lane) + off], k == dir ? 1.0f : 0.0f);

  Dual m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = Dual(x0[j * col + base]);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = Dual(0.0f);

  for (int n = 0; n < n_steps; ++n) {
    Dual mp[Q], pp[NT];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    publish_mean<NB, Q>(xs, n, b, tx, mp, c.tv);
    Dual G[Q][Q], g[Q], L[NT];
    gain_cols<Q>(c.Qm, c.R, m, P, mp, pp, G, g, L);
    if (live) {
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          store_aug(A_out, n, Q * Q, NAUG, i * Q + j, col, base, dir, G[i][j]);
#pragma unroll
      for (int i = 0; i < Q; ++i) store_aug(b_out, n, Q, NAUG, i, col, base, dir, g[i]);
#pragma unroll
      for (int k = 0; k < NT; ++k) store_aug(C_out, n, NT, NAUG, k, col, base, dir, L[k]);
    }
    __syncthreads();
    Dual x[NB][Q], z, S, inv_S;
    gather_means<NB, Q>(xs, n, tx, x);
    interrogate_update_block<Model, Q, MODE>(c, th, tgrid[n], x, b, mp, pp, m,
                                             P, z, S, inv_S);
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < Q; ++j) store_aug(m_last, 0, Q, NAUG, j, col, base, dir, m[j]);
#pragma unroll
    for (int k = 0; k < NT; ++k) store_aug(p_last, 0, NT, NAUG, k, col, base, dir, P[k]);
  }
}

// K11a's instances of one (model, q), under kramer and rodeo
// (with_ek_mode); a translation unit filter_tan_instances_*.cu instantiates
// them.
template <class Model, int Q>
cudaError_t FilterBatchTanInstances<Model, Q>::launch(
    int mode, const FilterBatchTanArgs& a, cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  const SplitGeometry geo =
      split_geometry<Model, kFilterTanLanes>(a.n_lane, Model::NTHETA);
  return with_ek_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    filter_batch_tan_kernel<Model, Q, MODE>
        <<<geo.grid, geo.block, 0, stream>>>(
            qc, a.n_steps, a.n_lane, a.R, a.W, a.tv, a.x0, a.theta, a.tgrid,
            a.A, a.b, a.C, a.m_last, a.p_last);
    return cudaGetLastError();
  });
}

template <class Model, int Q>
cudaError_t FilterBatchTanInstances<Model, Q>::geometry(int mode, int n_lane,
                                                        int* out) {
  return with_ek_mode(mode, [&](auto md) {
    return report_geometry(
        filter_batch_tan_kernel<Model, Q, decltype(md)::value>,
        split_geometry<Model, kFilterTanLanes>(n_lane, Model::NTHETA), out);
  });
}

}  // namespace rodeo
