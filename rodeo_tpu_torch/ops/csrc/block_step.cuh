// The filter step split over the blocks of a solve: one thread per (lane,
// block), or per (lane, direction, block) in a tangent kernel, the threads of
// one (lane, direction) meeting once a step.  Run by the value kernels K1
// (filter_batch.cu), K3 (filter_single.cu, one lane), K8
// (dalton_filter_batch.cu) and K9 (filter_nn_batch.cuh) on float, and by the
// tangent kernels K11a (filter_batch_tan.cuh), K11c
// (dalton_filter_batch_tan.cu) and K11d (filter_nn_batch_tan.cuh) on Dual.
//
// The blocks of a lane's state are independent in every part of the step
// but one: the ODE is evaluated at the predicted mean of all blocks
// (Model::f and jac0 read every block).  So each thread predicts its own
// block (predict_block of filter_step.cuh), publishes its predicted mean in
// original coordinates to the other threads of its lane, and after a
// barrier evaluates f and jac0 on the gathered means -- the same arithmetic
// in every thread of the lane, so the same bits -- keeping its own block's
// entries, and updates its block (interrogate_update_block).  The
// arithmetic follows the plain PyTorch twins operation for operation, so
// the kernels' outputs are theirs bitwise.
//
// A thread's block number is a runtime value: its constants are loaded once
// by that index from device memory (BlockConsts), and an entry of a
// per-block register array is picked by a chain of selects (own_block),
// never by indexing the array, which would put it in local memory.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#include "filter_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

// The launch of a split kernel: CTA (LANES lanes, NB blocks), grid (lane
// groups, n_dir), n_dir the tangent directions of a tangent kernel and 1
// for a value kernel.  Each kernel file fixes its LANES, the fastest of
// those measured on the card (PERF.md).  At 32 a warp is 32 consecutive
// lanes of one (block, direction), at 16 two blocks' 16, at 8 three
// blocks' (or four) 8; either way the stores of a step are coalesced on
// the lane axis.  The threads of lanes >= n_lane
// in the last lane group run masked.
struct SplitGeometry {
  dim3 grid, block;
};

template <class Model, int LANES>
SplitGeometry split_geometry(int n_lane, int n_dir) {
  return {dim3((n_lane + LANES - 1) / LANES, n_dir), dim3(LANES, Model::NB)};
}

// What the card makes of a kernel's launch, for the record: out = CTA x and
// y, grid x and y, registers per thread, local memory bytes per thread,
// shared memory bytes per CTA (static, plus dyn_smem bytes of dynamic shared
// memory that the launch asks for), CTAs resident per SM at most, SMs of the
// current device.
template <class Kernel>
cudaError_t report_geometry(Kernel* kernel, const SplitGeometry& g, int* out,
                            size_t dyn_smem = 0) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, g.block.x * g.block.y, dyn_smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vals[] = {static_cast<int>(g.block.x), static_cast<int>(g.block.y),
                      static_cast<int>(g.grid.x), static_cast<int>(g.grid.y),
                      attr.numRegs, static_cast<int>(attr.localSizeBytes),
                      static_cast<int>(attr.sharedSizeBytes + dyn_smem),
                      per_sm, sms};
  for (int k = 0; k < 9; ++k) out[k] = vals[k];
  return cudaSuccess;
}

// The operands of one block, in registers: the scaled transition, the
// block's process noise and weight, and the Taylor scales.
template <int Q>
struct BlockConsts {
  float Qm[Q][Q];
  float R[Tri<Q>::N];
  float W[Q];
  float tv[Q];
};

template <int Q>
__device__ __forceinline__ void load_block_consts(
    const QConst<Q>& qc, const float* __restrict__ R_in,
    const float* __restrict__ W_in, const float* __restrict__ tv_in, int b,
    BlockConsts<Q>& c) {
  constexpr int NT = Tri<Q>::N;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) c.Qm[i][j] = qc.q[i * Q + j];
#pragma unroll
  for (int k = 0; k < NT; ++k) c.R[k] = R_in[b * NT + k];
#pragma unroll
  for (int j = 0; j < Q; ++j) c.W[j] = W_in[b * Q + j];
#pragma unroll
  for (int j = 0; j < Q; ++j) c.tv[j] = tv_in[j];
}

// a[b] for a runtime b, by selects
template <int NB, class T>
__device__ __forceinline__ T own_block(const T (&a)[NB], int b) {
  T r = a[0];
#pragma unroll
  for (int k = 1; k < NB; ++k)
    if (b == k) r = a[k];
  return r;
}

// The predicted means of one step in original coordinates, (NB, Q) per
// lane of the CTA; two buffers, by the parity of the step, so that one
// barrier a step suffices: a buffer is written again only after every
// thread has passed the next step's barrier, and so has read it.
template <class T, int NB, int Q, int LANES>
using SharedMeans = T[2][NB][Q][LANES];

template <int NB, int Q, class T, int LANES>
__device__ __forceinline__ void publish_mean(
    SharedMeans<T, NB, Q, LANES>& xs, int n, int b, int tx, const T (&mp)[Q],
    const float (&tv)[Q]) {
#pragma unroll
  for (int j = 0; j < Q; ++j) xs[n & 1][b][j][tx] = mp[j] * tv[j];
}

template <int NB, int Q, class T, int LANES>
__device__ __forceinline__ void gather_means(
    const SharedMeans<T, NB, Q, LANES>& xs, int n, int tx, T (&x)[NB][Q]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) x[b][j] = xs[n & 1][b][j][tx];
}

// Column 0 of block b's row of the block-diagonal Jacobian, d f_b / d x[b][0],
// at the gathered means x: the functor's hand-written jac0, or, for a
// functor without one (kDualJacobian), f evaluated on DualT<T> with block
// b's entry x[b][0] seeded alone, as the twin's jac_flat evaluates it
// (own_block_jacobian of rodeo_tpu_torch/models/__init__.py).  On the
// tangent kernel's Dual states (T = Dual) the numbers are nested: the
// outer direction is the Jacobian's, each component carries theta's
// tangent, and the seed is a constant to theta (DualT's T(1)).
template <class Model, int Q, class T>
__device__ __forceinline__ T jac0_own(const T (&x)[Model::NB][Q],
                                      const T (&th)[Model::NTHETA], float t,
                                      int b) {
  constexpr int NB = Model::NB;
  if constexpr (Model::kDualJacobian) {
    using J = DualT<T>;
    J xd[NB][Q];
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int j = 0; j < Q; ++j)
        xd[k][j] = J(x[k][j], T((j == 0 && k == b) ? 1.0f : 0.0f));
    J fd[NB];
    Model::template f<Q>(xd, th, t, fd);
    return own_block(fd, b).d;
  } else {
    T jd_all[NB];
    Model::template jac0<Q>(x, th, t, jd_all);
    return own_block(jd_all, b);
  }
}

// Interrogate the ODE at the gathered points x of all blocks and update
// block b from (mp, pp) into (m, P) (the column step of
// _interrogate_update_cols, ops/fused_kalman.py).  x is the predicted mean
// in original coordinates, except under chkrebtii, where it is the
// predictive draw (draw_point); under EK1 x[b][0] is recomputed from mp,
// as the gathered value was.  Returns the block's innovation z, its
// variance S (doubled under rodeo and chkrebtii) and 1 / S, the terms of
// the forecast log-density.  The measurement row is H = W - J diag(tv),
// where the block-diagonal Jacobian J has only column 0: its entries j > 0
// are W's constants, and H[0] depends on theta under EK1 (type T) and is
// W's constant otherwise, as in the twin.  schober is rodeo without the
// measurement noise: S not doubled and no K V K' term.
template <class Model, int Q, int MODE, class T>
__device__ __forceinline__ void interrogate_update_block(
    const BlockConsts<Q>& c, const T (&th)[Model::NTHETA], float t,
    const T (&x)[Model::NB][Q], int b, const T (&mp)[Q],
    const T (&pp)[Tri<Q>::N], T (&m)[Q], T (&P)[Tri<Q>::N], T& z_out,
    T& S_out, T& inv_S_out) {
  constexpr int NB = Model::NB;
  using TH = std::conditional_t<MODE == kKramer, T, float>;
  T fx_all[NB];
  Model::template f<Q>(x, th, t, fx_all);
  const T fx = own_block(fx_all, b);
  const float (&W)[Q] = c.W;  // H[j] for j > 0
  TH H0;                       // H[0]
  T mm = -fx;
  if constexpr (MODE == kKramer) {
    const T jd = jac0_own<Model, Q>(x, th, t, b);
    H0 = W[0] - jd * c.tv[0];
    mm = mm + jd * (mp[0] * c.tv[0]);
  } else {
    H0 = W[0];
  }
  T hm = H0 * mp[0];
#pragma unroll
  for (int j = 1; j < Q; ++j) hm = hm + W[j] * mp[j];
  const T z = -(hm + mm);
  T PH[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = pp[Tri<Q>::at(i, 0)] * H0;
#pragma unroll
    for (int j = 1; j < Q; ++j) acc = acc + pp[Tri<Q>::at(i, j)] * W[j];
    PH[i] = acc;
  }
  T S = H0 * PH[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) S = S + W[i] * PH[i];
  constexpr bool kNoise = MODE == kRodeo || MODE == kChkrebtii;
  if constexpr (kNoise) S = S + S;  // V = W Sigma_pred W' doubles S
  const T inv_S = 1.0f / S;
  T gain[Q], IKW[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) gain[i] = PH[i] * inv_S;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = mp[i] + gain[i] * z;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    IKW[i][0] = (i == 0 ? 1.0f : 0.0f) - gain[i] * H0;
#pragma unroll
    for (int j = 1; j < Q; ++j)
      IKW[i][j] = (i == j ? 1.0f : 0.0f) - gain[i] * W[j];
  }
  sym_quadform<Q>(IKW, pp, P);
  if constexpr (kNoise) {
    const T V = S * 0.5f;
    int k = 0;
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
      for (int j = i; j < Q; ++j, ++k) P[k] = P[k] + gain[i] * gain[j] * V;
  }
  z_out = z;
  S_out = S;
  inv_S_out = inv_S;
}

// The exchange of a step's predicted means between the threads of a lane,
// for split_filter_steps: publish(n, b, mp, tv) puts block b's mean, then
// gather(n, x) waits for the lane's other threads and reads all blocks'.
// Through shared memory (SharedMeans) behind the CTA's barrier, for lanes
// whose threads span warps (K1).
template <int NB, int Q, int LANES>
struct SharedExchange {
  SharedMeans<float, NB, Q, LANES>& xs;
  int tx;
  __device__ __forceinline__ void publish(int n, int b, const float (&mp)[Q],
                                          const float (&tv)[Q]) {
    publish_mean<NB, Q>(xs, n, b, tx, mp, tv);
  }
  __device__ __forceinline__ void gather(int n, float (&x)[NB][Q]) {
    __syncthreads();
    gather_means<NB, Q>(xs, n, tx, x);
  }
};

// The same exchange by warp shuffles, for a lane whose NB threads are lanes
// base .. base + NB - 1 of one warp: no shared memory and no barrier of its
// own.  K3 and K5b run one solve on lanes 0 .. NB-1 (the defaults); K5c
// runs 8 groups a warp, group g' on lanes 4 g' + b, each thread's base its
// group's first lane, and every lane of the warp in the mask.  On K3,
// shared memory behind __syncwarp took 16 % longer (PERF.md).  Only the
// first J entries of each block's mean are exchanged, the others gathered
// as zeros: K5a-c pass J = 1, since the first-order vector fields of
// models.cuh read x[b][0] alone and a shuffle's result is not left out when
// unused.
template <int NB, int Q, int J = Q>
struct ShuffleExchange {
  float xv[J];
  int base = 0;                    // the lane of block 0
  unsigned mask = (1u << NB) - 1;  // the lanes that shuffle together
  __device__ __forceinline__ void publish(int, int, const float (&mp)[Q],
                                          const float (&tv)[Q]) {
#pragma unroll
    for (int j = 0; j < J; ++j) xv[j] = mp[j] * tv[j];
  }
  __device__ __forceinline__ void gather(int, float (&x)[NB][Q]) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        x[b][j] = __shfl_sync(mask, xv[j], base + b);
#pragma unroll
      for (int j = J; j < Q; ++j) x[b][j] = 0.0f;
    }
  }
};

// The point at which step n interrogates the ODE, in scaled coordinates,
// before the exchange: the predicted mean (xs = mp), or under chkrebtii the
// draw xs = mp + L eps from the predictive distribution N(mp, pp), L the
// lower Cholesky factor of pp (chol_cols) and eps the step's standard
// normals for this block (the column step of _interrogate_update_cols).
template <int Q>
__device__ __forceinline__ void draw_point(const float (&mp)[Q],
                                           const float (&pp)[Tri<Q>::N],
                                           const float (&eps)[Q],
                                           float (&xs)[Q]) {
  float L[Q][Q], eta[Q];
  chol_cols<Q>(pp, L);
  chol_matvec<Q>(L, eps, eta);
#pragma unroll
  for (int j = 0; j < Q; ++j) xs[j] = mp[j] + eta[j];
}

// The interrogation point of K1 and K3 for split_filter_steps: the
// predicted mean, or under chkrebtii the draw with the normals that
// eps_at(n, j) reads for this thread's block.
template <int Q, int MODE, class EpsAt>
__device__ __forceinline__ auto ode_point(EpsAt eps_at) {
  return [eps_at](int n, const float (&mp)[Q], const float (&pp)[Tri<Q>::N],
                  float (&xs)[Q]) {
    if constexpr (MODE == kChkrebtii) {
      float e[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) e[j] = eps_at(n, j);
      draw_point<Q>(mp, pp, e, xs);
    } else {
#pragma unroll
      for (int j = 0; j < Q; ++j) xs[j] = mp[j];
    }
  };
}

// The interrogation point of the filters that take the predicted mean
// alone (K8, K9).
struct AtMean {
  template <int Q, int NT>
  __device__ __forceinline__ void operator()(int, const float (&mp)[Q],
                                             const float (&)[NT],
                                             float (&xs)[Q]) const {
#pragma unroll
    for (int j = 0; j < Q; ++j) xs[j] = mp[j];
  }
};

// The update of K1 and K3 at step n: the ODE's alone
// (interrogate_update_block), for split_filter_steps.
template <class Model, int Q, int MODE>
__device__ __forceinline__ auto ode_update(const BlockConsts<Q>& c,
                                           const float (&th)[Model::NTHETA],
                                           int b) {
  return [&c, &th, b](int, float t, const float (&x)[Model::NB][Q],
                      const float (&mp)[Q], const float (&pp)[Tri<Q>::N],
                      float (&m)[Q], float (&P)[Tri<Q>::N]) {
    float z, S, inv_S;
    interrogate_update_block<Model, Q, MODE>(c, th, t, x, b, mp, pp, m, P, z,
                                             S, inv_S);
  };
}

// The split filter's steps for block b of one lane, from the carry (m, P)
// through n_steps steps: predict the block, publish its interrogation point
// (point(n, mp, pp, xs): ode_point or AtMean), predicted(n, m, P, mp, pp)
// with the carry (step n-1 filtered) and the fresh prediction, gather all
// blocks' points (the step's one barrier), update(n, t, x, mp, pp, m, P)
// of the block into (m, P) from the gathered points x, then
// filtered(n, m, P).  K1 and K3 update by ode_update, K9 by
// filter_nn_update_block; K1 stores the step's smoothing gains from
// predicted, K3 and K9 the predicted and filtered moments.
template <class Model, int Q, class Exchange, class Point, class Update,
          class Predicted, class Filtered>
__device__ __forceinline__ void split_filter_steps(
    const BlockConsts<Q>& c, const float* __restrict__ tgrid, int n_steps,
    int b, Exchange& ex, float (&m)[Q], float (&P)[Tri<Q>::N],
    Point&& point, Update&& update, Predicted&& predicted,
    Filtered&& filtered) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  for (int n = 0; n < n_steps; ++n) {
    float mp[Q], pp[NT], xs[Q];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    point(n, mp, pp, xs);
    ex.publish(n, b, xs, c.tv);
    predicted(n, m, P, mp, pp);
    float x[NB][Q];
    ex.gather(n, x);
    update(n, tgrid[n], x, mp, pp, m, P);
    filtered(n, m, P);
  }
}

// Each block's log-density terms of one step, by the parity of the step:
// written by the block's thread after the step's barrier, read by block 0's
// thread after the next step's barrier.
template <class T, int NB, int LANES>
using StepTerms = T[2][NB][LANES];

// DALTON's ld plus step n's log-density terms of all blocks, in block order
// as _dalton_filter_plain (ops/fused_dalton.py) sums them: the ODE's
// pseudo-observation terms, then, at a step with data, the observation
// terms; a step without data adds none (its update was skipped).
template <int NB, bool WITH_OBS, class T, int LANES>
__device__ __forceinline__ T add_step_terms(
    T ld, const StepTerms<T, NB, LANES>& ode,
    const StepTerms<T, NB, LANES>& obs, int n, int tx,
    const float* __restrict__ mask) {
  const int p = n & 1;
  T acc = ode[p][0][tx];
#pragma unroll
  for (int b = 1; b < NB; ++b) acc = acc + ode[p][b][tx];
  ld = ld - 0.5f * acc;
  if constexpr (WITH_OBS) {
    const float mk = mask[n];
    if (mk != 0.0f) {
      T obs_acc = obs[p][0][tx];
#pragma unroll
      for (int b = 1; b < NB; ++b) obs_acc = obs_acc + obs[p][b][tx];
      ld = ld + mk * (-0.5f * obs_acc);
    }
  }
  return ld;
}

// DALTON's update of block b at step n, after the step's barrier:
// interrogate_update_block on the gathered means x, the forecast
// log-density term of the ODE's pseudo-observation, and with WITH_OBS, at a
// step with data, the block's masked observation update and its term; each
// term goes to the step's slot of ode or obs, for block 0's thread to add
// (add_step_terms).  At a step without data (mask 0) the masked update is
// an exact identity (K = 0, and ld gains 0 x a finite term), so it is
// skipped, as the twin skips it.  The observation grid (d, y, om, mask; N x
// .. x NB) is shared by all lanes.
template <class Model, int Q, int MODE, bool WITH_OBS, class T, int LANES>
__device__ __forceinline__ void dalton_update_block(
    const BlockConsts<Q>& c, const T (&th)[Model::NTHETA], int n, float t,
    const T (&x)[Model::NB][Q], int b, int tx, const T (&mp)[Q],
    const T (&pp)[Tri<Q>::N], const float* __restrict__ d,
    const float* __restrict__ y, const float* __restrict__ om,
    const float* __restrict__ mask, T (&m)[Q], T (&P)[Tri<Q>::N],
    StepTerms<T, Model::NB, LANES>& ode,
    StepTerms<T, Model::NB, LANES>& obs) {
  constexpr int NB = Model::NB;
  T z, S, inv_S;
  interrogate_update_block<Model, Q, MODE>(c, th, t, x, b, mp, pp, m, P, z,
                                           S, inv_S);
  ode[n & 1][b][tx] = z * z * inv_S + log_of(S) + kLog2Pi;
  if constexpr (WITH_OBS) {
    const float mk = mask[n];
    if (mk != 0.0f) {
      float D[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) D[j] = d[(static_cast<size_t>(n) * Q + j) * NB + b];
      const size_t o = static_cast<size_t>(n) * NB + b;
      obs[n & 1][b][tx] = masked_obs_update<Q>(D, y[o], om[o], mk, m, P);
    }
  }
}

// Non-Gaussian DALTON's update of block b at step n (the step of
// _filter_nn_batch_plain, ops/fused_daltonng.py, for one block), after the
// step's barrier: interrogate_update_block on the gathered means x, then,
// at a step with data (mask[n] != 0), the block's masked Laplace
// pseudo-observation update (laplace_update of filter_step.cuh) of each
// component j in obs_dims, in ascending j.  The Laplace updates read only
// the block's own moments and data, so the blocks stay independent there.
// A step without data skips them: there the masked update is an exact
// identity (K = 0), and the twin skips it too.  The observation grid (y: N
// x NB, iobs, mask: N) is shared by all lanes.  K9 runs it on float, K11d
// on Dual.
template <class Model, class Obs, int Q, int MODE, class T>
__device__ __forceinline__ void filter_nn_update_block(
    const BlockConsts<Q>& c, const T (&th)[Model::NTHETA], int n, float t,
    const T (&x)[Model::NB][Q], int b, int obs_dims, const ObsPars& pars,
    const float* __restrict__ y, const float* __restrict__ iobs,
    const float* __restrict__ mask, const T (&mp)[Q],
    const T (&pp)[Tri<Q>::N], T (&m)[Q], T (&P)[Tri<Q>::N]) {
  constexpr int NB = Model::NB;
  T z, S, inv_S;
  interrogate_update_block<Model, Q, MODE>(c, th, t, x, b, mp, pp, m, P, z,
                                           S, inv_S);
  const float mk = mask[n];
  if (mk == 0.0f) return;
  const float io = iobs[n];
  const float yb = y[static_cast<size_t>(n) * NB + b];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (!(obs_dims & (1 << j))) continue;
    laplace_update<Obs, Q>(c.tv, j, mp[j] * c.tv[j], yb, io, mk, th, pars, m,
                           P);
  }
}

}  // namespace rodeo
