// K8: lane-batched forward filter of the DALTON likelihood, summing the
// forecast log-density of the ODE's pseudo-observations and, with WITH_OBS,
// that of the data through a masked scalar observation update after each
// ODE update.  Only the (B,) log-density leaves the kernel.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel, under kramer and rodeo on K1's (model, q): the
// first-order models at q = 3, FitzHugh-Nagumo also at q = 4 and 5, and the
// second-order Chkrebtii at q = 4 and 5 (dispatch.cuh's
// with_filter_instance).  Plain PyTorch twin:
// _dalton_filter_plain in ops/fused_dalton.py.  The C entry points are
// dalton_filter_batch.cu's; the instances are compiled in one translation
// unit per (model, q), dalton_instances_*.cu, which nvcc builds in
// parallel.
//
// Design.  As K1 (filter_batch.cu), one thread per (lane, block), the
// threads of a lane meeting once a step in shared memory (block_step.cuh),
// because the ODE right-hand side couples the blocks; each step is K1's
// predict, interrogate and update without K1's gains
// (dalton_update_block).  Each thread leaves its block's log-density terms
// in shared memory, and the thread of block 0 adds them in block order as
// the twin adds them, one step late, after the next step's barrier
// (add_step_terms; the terms are double buffered), and holds ld.  With
// WITH_OBS each thread runs its block's masked observation update at a step
// with data and skips it at a step without (mask 0), where it is an exact
// identity; the twin skips it too.  The observation grid (N, .., NB) is
// shared by all lanes and comes from cache; nothing is streamed per lane,
// and one float per lane is written at the end.  WITH_OBS is a template
// parameter, so the launch without data carries no observation code.  The
// tangent kernel K11c runs the same step on Dual numbers.
//
// What bounds it on the card.  Nothing is streamed per lane; a step is a
// chain of dependent float operations on one block, with the ODE at the
// gathered means, so the kernel is bound by the latency of that chain.  At
// 2048 lanes Lorenz63 runs 64 CTAs of 32 x 3 = 96 threads, one on each of
// 64 of the card's 132 SMs; 128 CTAs of 16 lanes were slower.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dalton_instances.cuh"
#include "dispatch.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 on the card (PERF.md)
constexpr int kDaltonLanes = 32;

// At 2048 lanes the launch has 64 CTAs, fewer than the SMs, so an SM never
// holds a second one: the launch bounds ask for one CTA per SM, and ptxas
// spends registers on the chain instead of spilling to fit more CTAs.
template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kDaltonLanes * Model::NB, 1)
    dalton_filter_kernel(QConst<Q> qc, int n_steps, int n_lane,
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
  __shared__ SharedMeans<float, NB, Q, kDaltonLanes> xs;
  // each block's terms of a step: the ODE's and the data's
  __shared__ StepTerms<float, NB, kDaltonLanes> ode_terms, obs_terms;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int lane = blockIdx.x * kDaltonLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no store
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  const size_t col = static_cast<size_t>(NB) * n_lane;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k * static_cast<size_t>(n_lane) + off];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[j * col + b * static_cast<size_t>(n_lane) + off];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;
  float ld = ld0[off];

  for (int n = 0; n < n_steps; ++n) {
    float mp[Q], pp[NT];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    publish_mean<NB, Q>(xs, n, b, tx, mp, c.tv);
    __syncthreads();
    if (b == 0 && n > 0)
      ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n - 1, tx, mask);
    float x[NB][Q];
    gather_means<NB, Q>(xs, n, tx, x);
    dalton_update_block<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], x, b,
                                                  tx, mp, pp, d, y, om, mask,
                                                  m, P, ode_terms, obs_terms);
  }
  __syncthreads();
  if (b == 0) {
    ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n_steps - 1, tx, mask);
    if (live) ld_out[off] = ld;
  }
}

// K8's instances of one (model, q), one for each of kramer and rodeo and
// each of with_obs (with_ek_mode); a translation unit dalton_instances_*.cu
// instantiates them.
template <class Model, int Q>
cudaError_t DaltonFilterInstances<Model, Q>::launch(
    int mode, bool with_obs, const DaltonFilterArgs& a, cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  const SplitGeometry g = split_geometry<Model, kDaltonLanes>(a.n_lane, 1);
  return with_ek_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    auto* kernel = with_obs ? &dalton_filter_kernel<Model, Q, MODE, true>
                            : &dalton_filter_kernel<Model, Q, MODE, false>;
    kernel<<<g.grid, g.block, 0, stream>>>(
        qc, a.n_steps, a.n_lane, a.R, a.W, a.tv, a.x0, a.theta, a.tgrid, a.d,
        a.y, a.om, a.mask, a.ld0, a.ld);
    return cudaGetLastError();
  });
}

template <class Model, int Q>
cudaError_t DaltonFilterInstances<Model, Q>::geometry(int mode, bool with_obs,
                                                      int n_lane, int* out) {
  const SplitGeometry g = split_geometry<Model, kDaltonLanes>(n_lane, 1);
  return with_ek_mode(mode, [&](auto md) {
    constexpr int MODE = decltype(md)::value;
    return with_obs
               ? report_geometry(dalton_filter_kernel<Model, Q, MODE, true>, g,
                                 out)
               : report_geometry(dalton_filter_kernel<Model, Q, MODE, false>,
                                 g, out);
  });
}

}  // namespace rodeo
