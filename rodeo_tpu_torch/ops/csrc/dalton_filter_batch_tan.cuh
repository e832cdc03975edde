// K11c: the tangent twin of K8.  DALTON's forward filter carries the
// derivative of its state and log-density along each theta direction and
// writes the log-density with its tangents, (NAUG, B), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel_tan, under kramer and rodeo on K1's (model, q): the
// first-order models at q = 3, FitzHugh-Nagumo also at q = 4 and 5, and the
// second-order Chkrebtii at q = 4 and 5 (dispatch.cuh's
// with_filter_instance).  Plain PyTorch twin: _dalton_filter_tan_plain in
// ops/fused_dalton.py, which runs K8's twin on Duals (ops/dual.py).  The C
// entry points are dalton_filter_batch_tan.cu's; the instances are compiled
// in one translation unit per (model, q), dalton_tan_instances_*.cu, which
// nvcc builds in parallel.
//
// Design.  K8's step on the forward-mode number Dual (dual.cuh), theta
// seeded along the thread's direction, the initial state exact (zero
// tangent), the seed log-density's tangent read from ld0, split over the
// blocks of a lane as K8 is (block_step.cuh), with a grid row per
// direction: one thread per (lane, direction, block) predicts, interrogates
// and updates its block, and with WITH_OBS runs its block's masked
// observation update at a step with data (dalton_update_block).  Each
// thread leaves its block's log-density terms in shared memory; the thread
// of block 0 adds them in block order, one step late, after the next
// step's barrier (add_step_terms; the terms are double buffered), and
// holds ld.  The values are K8's bitwise; the threads of direction 0 store
// them.  Under kramer a model without a hand-written Jacobian (Hes1,
// SEIRAH) takes its column on nested Duals, DualT<Dual> (jac0_own of
// block_step.cuh), as the twin's nested Duals do.
//
// What bounds it on the card.  Nothing is streamed per lane; a step is K8's
// chain of float operations on one block and its tangent, with the ODE at
// the gathered means, so the kernel is bound by the latency of that chain.
// At 2048 lanes Lorenz63 runs grid (64, 3) = 192 CTAs of 32 x 3 = 96
// threads, every CTA resident at once and every SM with one or two;
// Chkrebtii's ODE (one block, no parameter but its one direction) 64 CTAs
// of 32 threads.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dalton_instances.cuh"
#include "dispatch.cuh"
#include "dual.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 on the card (PERF.md)
constexpr int kDaltonTanLanes = 32;

template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kDaltonTanLanes * Model::NB)
    dalton_filter_tan_kernel(QConst<Q> qc, int n_steps, int n_lane,
                             const float* __restrict__ R_in,
                             const float* __restrict__ W_in,
                             const float* __restrict__ tv_in,
                             const float* __restrict__ x0,
                             const float* __restrict__ theta,
                             const float* __restrict__ tgrid,
                             const float* __restrict__ d,
                             const float* __restrict__ y,
                             const float* __restrict__ om,
                             const float* __restrict__ mask,
                             const float* __restrict__ ld0,
                             float* __restrict__ ld_out) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  constexpr int NAUG = 1 + NTH;
  __shared__ SharedMeans<Dual, NB, Q, kDaltonTanLanes> xs;
  // each block's terms of a step: the ODE's and the data's
  __shared__ StepTerms<Dual, NB, kDaltonTanLanes> ode_terms, obs_terms;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int dir = blockIdx.y;
  const int lane = blockIdx.x * kDaltonTanLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no store
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  const size_t col = static_cast<size_t>(NB) * n_lane;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  Dual th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k)
    th[k] = Dual(theta[k * static_cast<size_t>(n_lane) + off], k == dir ? 1.0f : 0.0f);

  Dual m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = Dual(x0[j * col + b * static_cast<size_t>(n_lane) + off]);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = Dual(0.0f);
  Dual ld(ld0[off], ld0[(1 + dir) * static_cast<size_t>(n_lane) + off]);

  for (int n = 0; n < n_steps; ++n) {
    Dual mp[Q], pp[NT];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    publish_mean<NB, Q>(xs, n, b, tx, mp, c.tv);
    __syncthreads();
    if (b == 0 && n > 0)
      ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n - 1, tx, mask);
    Dual x[NB][Q];
    gather_means<NB, Q>(xs, n, tx, x);
    dalton_update_block<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], x, b,
                                                  tx, mp, pp, d, y, om, mask,
                                                  m, P, ode_terms, obs_terms);
  }
  __syncthreads();
  if (b == 0) {
    ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n_steps - 1, tx, mask);
    if (live) store_aug(ld_out, 0, 1, NAUG, 0, n_lane, off, dir, ld);
  }
}

// K11c's instances of one (model, q), one for each of kramer and rodeo and
// each of with_obs (with_ek_mode); a translation unit
// dalton_tan_instances_*.cu instantiates them.
template <class Model, int Q>
cudaError_t DaltonFilterTanInstances<Model, Q>::launch(
    int mode, bool with_obs, const DaltonFilterArgs& a, cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  const SplitGeometry g =
      split_geometry<Model, kDaltonTanLanes>(a.n_lane, Model::NTHETA);
  return with_ek_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    auto* kernel = with_obs ? &dalton_filter_tan_kernel<Model, Q, MODE, true>
                            : &dalton_filter_tan_kernel<Model, Q, MODE, false>;
    kernel<<<g.grid, g.block, 0, stream>>>(
        qc, a.n_steps, a.n_lane, a.R, a.W, a.tv, a.x0, a.theta, a.tgrid, a.d,
        a.y, a.om, a.mask, a.ld0, a.ld);
    return cudaGetLastError();
  });
}

template <class Model, int Q>
cudaError_t DaltonFilterTanInstances<Model, Q>::geometry(int mode,
                                                         bool with_obs,
                                                         int n_lane,
                                                         int* out) {
  const SplitGeometry g =
      split_geometry<Model, kDaltonTanLanes>(n_lane, Model::NTHETA);
  return with_ek_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    return with_obs
               ? report_geometry(
                     dalton_filter_tan_kernel<Model, Q, MODE, true>, g, out)
               : report_geometry(
                     dalton_filter_tan_kernel<Model, Q, MODE, false>, g, out);
  });
}

}  // namespace rodeo
