// K11d: the tangent twin of K9.  The Laplace-linearised filter of
// non-Gaussian DALTON carries the derivative of its state along each theta
// direction and stores the filtered and predicted moments with their
// tangents, stacked on the d axis as the TPU kernel stacks them: mf (N,
// NAUG Q, NB, B), pf (N, NAUG Tri, ..), mp (N, NAUG Q, ..), pp (N, NAUG
// Tri, ..), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_daltonng.py:
// _filter_nn_kernel_batch_tan, on K9's instances (filter_nn_batch.cuh).
// Plain PyTorch twin: _filter_nn_batch_tan_plain in ops/fused_daltonng.py,
// which runs K9's twin on Duals (ops/dual.py).  The C entry points are
// filter_nn_batch_tan.cu's; the instances are compiled in one translation
// unit per (model, q), filter_nn_tan_instances_*.cu, which nvcc builds in
// parallel.
//
// Design.  K9's step on the forward-mode number Dual (dual.cuh), with theta
// seeded along the thread's direction and the initial state exact (zero
// tangent), split over the blocks of a lane (block_step.cuh) as K11a splits
// K1's: one thread per (lane, direction, block), which predicts its block,
// publishes its predicted mean to shared memory, and after one barrier a
// step with the other blocks of its (lane, direction) evaluates the ODE at
// the gathered means, updates its block and, at a step with data, runs its
// block's Laplace pseudo-observation updates (filter_nn_update_block).  The
// Laplace derivatives come from the observation functor evaluated on a
// Jet2 of Duals (jet.cuh), so the tangent of the Hessian -- the third
// derivative of the observation log-likelihood -- needs no code of its
// own.  The value part of each Dual is K9's float arithmetic on the same
// split step, so the values equal K9's bitwise; the threads of direction 0
// store them.  Under kramer a model without a hand-written Jacobian (Hes1,
// SEIRAH) takes its column on nested Duals, DualT<Dual> (jac0_own of
// block_step.cuh), as the twin's nested Duals do.  One thread per (lane,
// direction) with all NB blocks in its
// registers (the design of both before each was split) put 64 CTAs of 96
// threads on 64 of the 132 SMs at 2048 lanes, with a chain of ~3e3
// dependent operations a step in 254 registers; the split gives NB times
// the threads, each with a chain about 1/NB as long.
//
// What bounds it on the card.  A step stores 72 floats per (block, lane) at
// NAUG = 4 (mf 12, pf 24, mp 12, pp 24): 7.08 GB at 4000 steps x 3 blocks x
// 2048 lanes, 2.11 ms at 3.35 TB/s.  The kernel is still bound by the
// latency of each thread's chain (K9's step on one block and its tangent,
// and the ODE at the gathered means): at 2048 lanes Lorenz63 runs grid (64,
// 3) = 192 CTAs of 32 x 3 = 96 threads, every CTA resident at once and
// every SM with one or two.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "dual.cuh"
#include "filter_nn_instances.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"
#include "obs_models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 for every split tangent kernel (PERF.md)
constexpr int kNnTanLanes = 32;

template <class Model, class Obs, int Q, int MODE>
__global__ void __launch_bounds__(kNnTanLanes * Model::NB)
    filter_nn_batch_tan_kernel(QConst<Q> qc, ObsPars pars, int obs_dims,
                               int n_steps, int n_lane,
                               const float* __restrict__ R_in,
                               const float* __restrict__ W_in,
                               const float* __restrict__ tv_in,
                               const float* __restrict__ x0,
                               const float* __restrict__ theta,
                               const float* __restrict__ tgrid,
                               const float* __restrict__ y,
                               const float* __restrict__ iobs,
                               const float* __restrict__ mask,
                               float* __restrict__ mf_out,
                               float* __restrict__ pf_out,
                               float* __restrict__ mp_out,
                               float* __restrict__ pp_out) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  constexpr int NAUG = 1 + NTH;
  __shared__ SharedMeans<Dual, NB, Q, kNnTanLanes> xs;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int dir = blockIdx.y;
  const int lane = blockIdx.x * kNnTanLanes + tx;
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
    __syncthreads();
    Dual x[NB][Q];
    gather_means<NB, Q>(xs, n, tx, x);
    filter_nn_update_block<Model, Obs, Q, MODE>(c, th, n, tgrid[n], x, b,
                                                obs_dims, pars, y, iobs, mask,
                                                mp, pp, m, P);
    if (live) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        store_aug(mf_out, n, Q, NAUG, i, col, base, dir, m[i]);
        store_aug(mp_out, n, Q, NAUG, i, col, base, dir, mp[i]);
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        store_aug(pf_out, n, NT, NAUG, k, col, base, dir, P[k]);
        store_aug(pp_out, n, NT, NAUG, k, col, base, dir, pp[k]);
      }
    }
  }
}

// K11d's instances of one (model, q), one for each of Gauss and Poisson
// and each of kramer and rodeo (with_ek_mode); a translation unit
// filter_nn_tan_instances_*.cu instantiates them.
template <class Model, int Q>
cudaError_t NnFilterTanInstances<Model, Q>::launch(int obs_model, int mode,
                                                   const NnFilterArgs& a,
                                                   cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  ObsPars pars;
  std::memcpy(pars.p, a.pars_host, sizeof(pars.p));
  const SplitGeometry g =
      split_geometry<Model, kNnTanLanes>(a.n_lane, Model::NTHETA);
  return with_functor<Gauss, Poisson>(obs_model, [&](auto ob) {
    using Obs = typename decltype(ob)::type;
    return with_ek_mode(mode, [&](auto md) {
      constexpr int MODE = decltype(md)::value;
      filter_nn_batch_tan_kernel<Model, Obs, Q, MODE>
          <<<g.grid, g.block, 0, stream>>>(
              qc, pars, a.obs_dims, a.n_steps, a.n_lane, a.R, a.W, a.tv,
              a.x0, a.theta, a.tgrid, a.y, a.iobs, a.mask, a.mf, a.pf, a.mp,
              a.pp);
      return cudaGetLastError();
    });
  });
}

template <class Model, int Q>
cudaError_t NnFilterTanInstances<Model, Q>::geometry(int obs_model, int mode,
                                                     int n_lane, int* out) {
  const SplitGeometry g =
      split_geometry<Model, kNnTanLanes>(n_lane, Model::NTHETA);
  return with_functor<Gauss, Poisson>(obs_model, [&](auto ob) {
    using Obs = typename decltype(ob)::type;
    return with_ek_mode(mode, [&](auto md) {
      constexpr int MODE = decltype(md)::value;
      return report_geometry(filter_nn_batch_tan_kernel<Model, Obs, Q, MODE>,
                             g, out);
    });
  });
}

}  // namespace rodeo
