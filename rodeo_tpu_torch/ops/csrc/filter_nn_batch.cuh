// K9: the Laplace-linearised forward filter of non-Gaussian DALTON,
// lane-batched, storing the filtered and predicted moments of every step.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_daltonng.py:
// _filter_nn_kernel_batch, under kramer and rodeo on K1's (model, q): the
// first-order models at q = 3, FitzHugh-Nagumo also at q = 4 and 5 (its
// weight and initial state padded with zeros past the third derivative),
// and the second-order Chkrebtii at q = 4 and 5 (dispatch.cuh's
// with_filter_instance), each with the observation functors Gauss and
// Poisson.  Plain PyTorch twin: _filter_nn_batch_plain in
// ops/fused_daltonng.py.  The C entry points are filter_nn_batch.cu's; the
// instances are compiled in one translation unit per (model, q),
// filter_nn_instances_*.cu, which nvcc builds in parallel.
//
// Design.  One thread per (lane, block) carries its block of one lane (one
// parameter candidate) through all N steps in a single launch, on
// block_step.cuh's step loop (split_filter_steps), as K1 and K3 are.  Each
// step a thread predicts its block, stores its predicted moments, publishes
// its predicted mean to shared memory and, after one barrier a step with
// the other blocks of its lane, evaluates the ODE at their gathered means
// and updates its block (filter_nn_update_block): K1's scalar-innovation
// update, then, at a step with data, one masked scalar pseudo-observation
// update per observed component.  The user's observation log-likelihood is
// compiled in as a functor (obs_models.cuh) and linearised at the predicted
// mean in original coordinates by evaluating it on a second-order forward
// number (jet.cuh) -- the nested jax.jvp of the TPU kernel.  The TPU kernel
// runs the masked update at every step; this one skips it where the mask is
// 0, where it is an exact identity, and so does its twin.  The arithmetic
// is the twin's operation for operation, so the outputs are the twin's
// bitwise, and the tangent twin K11d (filter_nn_batch_tan.cuh), which runs
// the same block update on Duals, has K9's values bitwise.  Outputs are
// laid out (N, d, NB, B) with lanes innermost: mf (N, Q, ..), pf (N, Tri,
// ..), mp (N, Q, ..), pp (N, Tri, ..), the four streams the smoothing
// passes read; each thread stores its block's entries, coalesced on the
// lane axis.  Float32 throughout.
//
// What bounds it on the card.  A step is a chain of dependent float
// operations on one block, with the ODE at the gathered means, against 18
// floats stored per (block, lane): 1.77 GB at 4000 steps x 3 blocks x 2048
// lanes, 0.53 ms at 3.35 TB/s, below the latency of the chain.  One thread
// per lane with all NB blocks in its registers would pay the latency of
// every block's chain (1.8x the time on the card, PERF.md); the split
// gives NB times the threads, each with a chain about 1/NB as long.
#pragma once

#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "filter_nn_instances.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"
#include "obs_models.cuh"

namespace rodeo {

// Lanes per CTA: 32, the fastest of 8, 16 and 32 on the card, by 1 %
// (PERF.md): the time is each thread's chain through the steps, whether
// its warps share SMs (64 CTAs of 96 threads at 2048 lanes) or not (256
// of 24 at 8 lanes).
constexpr int kNnLanes = 32;

// One CTA per SM in the launch bounds, as K1's: ptxas spends registers on
// the chain instead of spilling to fit more CTAs.
template <class Model, class Obs, int Q, int MODE>
__global__ void __launch_bounds__(kNnLanes * Model::NB, 1)
    filter_nn_batch_kernel(QConst<Q> qc, ObsPars pars, int obs_dims,
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
  __shared__ SharedMeans<float, NB, Q, kNnLanes> xs;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int lane = blockIdx.x * kNnLanes + tx;
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

  // block b's moments of step n
  auto store = [&](float* mo, float* po, int n, const float (&mv)[Q],
                   const float (&Pv)[NT]) {
    if (!live) return;
#pragma unroll
    for (int i = 0; i < Q; ++i)
      mo[(static_cast<size_t>(n) * Q + i) * col + base] = mv[i];
#pragma unroll
    for (int k = 0; k < NT; ++k)
      po[(static_cast<size_t>(n) * NT + k) * col + base] = Pv[k];
  };
  SharedExchange<NB, Q, kNnLanes> ex{xs, tx};
  split_filter_steps<Model, Q>(
      c, tgrid, n_steps, b, ex, m, P, AtMean{},
      [&](int n, float t, const float (&x)[NB][Q], const float (&mp)[Q],
          const float (&pp)[NT], float (&mv)[Q], float (&Pv)[NT]) {
        filter_nn_update_block<Model, Obs, Q, MODE>(c, th, n, t, x, b,
                                                    obs_dims, pars, y, iobs,
                                                    mask, mp, pp, mv, Pv);
      },
      [&](int n, const float (&)[Q], const float (&)[NT],
          const float (&mp)[Q], const float (&pp)[NT]) {
        store(mp_out, pp_out, n, mp, pp);
      },
      [&](int n, const float (&mv)[Q], const float (&Pv)[NT]) {
        store(mf_out, pf_out, n, mv, Pv);
      });
}

// K9's instances of one (model, q), one for each of Gauss and Poisson and
// each of kramer and rodeo (with_ek_mode); a translation unit
// filter_nn_instances_*.cu instantiates them.
template <class Model, int Q>
cudaError_t NnFilterInstances<Model, Q>::launch(int obs_model, int mode,
                                                const NnFilterArgs& a,
                                                cudaStream_t stream) {
  QConst<Q> qc;
  std::memcpy(qc.q, a.q_host, sizeof(qc.q));
  ObsPars pars;
  std::memcpy(pars.p, a.pars_host, sizeof(pars.p));
  const SplitGeometry g = split_geometry<Model, kNnLanes>(a.n_lane, 1);
  return with_functor<Gauss, Poisson>(obs_model, [&](auto ob) {
    using Obs = typename decltype(ob)::type;
    return with_ek_mode(mode, [&](auto md) {
      constexpr int MODE = decltype(md)::value;
      filter_nn_batch_kernel<Model, Obs, Q, MODE>
          <<<g.grid, g.block, 0, stream>>>(
              qc, pars, a.obs_dims, a.n_steps, a.n_lane, a.R, a.W, a.tv,
              a.x0, a.theta, a.tgrid, a.y, a.iobs, a.mask, a.mf, a.pf, a.mp,
              a.pp);
      return cudaGetLastError();
    });
  });
}

template <class Model, int Q>
cudaError_t NnFilterInstances<Model, Q>::geometry(int obs_model, int mode,
                                                  int n_lane, int* out) {
  const SplitGeometry g = split_geometry<Model, kNnLanes>(n_lane, 1);
  return with_functor<Gauss, Poisson>(obs_model, [&](auto ob) {
    using Obs = typename decltype(ob)::type;
    return with_ek_mode(mode, [&](auto md) {
      constexpr int MODE = decltype(md)::value;
      return report_geometry(filter_nn_batch_kernel<Model, Obs, Q, MODE>, g,
                             out);
    });
  });
}

}  // namespace rodeo
