// K5a, K5b, K5c: the mean-only chain of the stationary-gain single solve
// (solve_mv_fused_stationary).  Beyond an exact Riccati prefix (K3) the
// measurement row is constant and the gain frozen, so each step is
//   mp = Q m,  z = f(mp * tv) - W mp,  m = mp + K z
// per block (the Jacobian terms of EK1's innovation cancel, so EK0 and EK1
// share the step), with no covariance algebra.
//
//   K5a mean_gain_single      replaces _mean_gain_kernel: the chain over N
//                             steps with a gain row (NB, q) per step,
//                             writing every filtered mean (N, NB, q);
//   K5b mean_boundary_single  replaces _mean_boundary_kernel: the chain
//                             with the frozen gain K* over the tail, in
//                             groups of k_group steps, storing only each
//                             group's entry state (n_group, NB, q);
//   K5c mean_recovery_single  replaces _mean_recovery_kernel: each group's
//                             k_group steps re-run from its entry state,
//                             the groups in parallel, writing the interior
//                             means (n_group * k_group, NB, q).
//
// All three in rodeo_tpu/ops/pallas_kalman.py.  Plain PyTorch twins:
// _mean_gain_plain, _mean_boundary_plain and _mean_recovery_plain in
// ops/fused_kalman.py, which run the same step (_mean_step_cols) in the
// same order.
//
// Design.  All three split the step over the blocks of the solve, as K3
// splits its filter's (block_step.cuh): thread b carries only its block
// m[b] and runs mean_step_block.  Each step it computes its block's
// mp = Q m[b] and the scaled first entry mp[0] tv[0], which the block
// threads exchange by warp shuffles (ShuffleExchange of the first entries:
// the vector fields read no other); each evaluates Model::f on the gathered
// entries (the same bits in every thread), keeps its own block's value and
// updates its block in the twin's order.
//   K5b: one CTA of NB threads in one warp (3 for Lorenz63, 2 for
// FitzHugh-Nagumo), storing its block's row of each group's entry state.
// Its group loop is unrolled by 8 (by 1, 2 and 4 it was 3-8 % slower, by
// 16 within 0.3 %).
//   K5c: a thread per (group, block), the groups side by side in a warp,
// group g' on lanes 4 g' + b (kRecoveryGroups = 8 groups, a CTA of one
// warp, so that 155 groups take 20 CTAs on 20 SMs), for groups of at most
// kRecoveryGroupSteps steps (the schedule's 64).  The warp loads its
// groups' times into shared memory, coalesced, runs the steps staging each
// new mean in shared memory, then stores the staged rows, one contiguous
// run of the (T, NB, q) output, 16 bytes at a time where the output is
// 16-byte aligned (SlabRuns, as K5a).  Lanes past the model's blocks, and
// the groups past the last, run a live thread's chain so that every lane
// shuffles, and store nothing.  A CTA of 16 groups x NB blocks exchanging
// through shared memory behind __syncthreads, as K1 does, took 21 % longer
// (PERF.md).  The TPU kernel's (k, q, NB, G) lane layout and the transposes around it have
// no counterpart here.  K5c re-runs K5b's operations from K5b's own stored
// states, so K5b + K5c over the tail equal K5a with the constant gain from
// the same start, bit for bit.
//   K5a: a stream on stream_ring.cuh's ring: a consumer warp whose lanes 0
// .. NB-1 carry the blocks, and a producer warp that copies stages of
// kGainRows steps (the gain rows (rows, NB, q) and their times, as slabs,
// SlabRuns) by cp.async into a ring of kGainStages slots, and stores the
// means the consumers staged for each stage (16 bytes at a time where the
// gains, times and means are 16-byte aligned, else 4).  The whole gain
// array fits in shared memory at 150 steps but not at 10 000 (360 KB),
// hence the ring; of rings of 16 to 256 steps a stage, kGainStages x
// kGainRows was the fastest (PERF.md), larger stages paying fewer
// hand-overs between the warps.
//   On the TPU the store-free K5b was the point of the two-phase schedule
// (a column store cost more than the step); on the card a store drains
// while the chain goes on, and the schedule is kept because it is the JAX
// package's algorithm.
//
// The transition.  All three run the dense matvec that K3 runs, for any
// block-constant transition.  On the scaled IBM prior's unit
// upper-triangular one it gives the twin's bits on finite values, although
// the twin's _coef_mul skips the 0 and 1 coefficients: a product by one
// and the sum with a zero product are exact.
//
// What bounds them on the card.  A step's dependent chain is 10 float
// operations (Q m 3, mp tv 1, the vector field 3, z = f - W mp 1, m = mp +
// K z 2) and a shuffle's latency, far above their byte bound (K5b reads 4
// bytes of time a step and writes 36 bytes a group; K5a and K5c move 40 to
// 76 bytes a step).  One thread carrying all blocks issued ~100 float
// instructions a step, and one warp's issue, not the chain, bound K5a and
// K5c (229 ns and ~1.25 us a step).  Split over the blocks, a Lorenz63
// thread issues only its block's share (the shuffles, the vector field, its
// block's update and the loop), and a step of K5b takes ~40 ns, ~80
// cycles: the chain's 10 operations and the shuffle's latency on it
// (PERF.md).  K5c's 64 steps and K5a's ring add the loads of
// the times and gains from shared memory and the staged stores to that.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kBoundaryUnroll = 8;  // K5b's steps a group's loop unrolls
constexpr int kRecoveryGroups = 8;  // K5c's groups a CTA, 4 lanes each
constexpr int kRecoveryGroupSteps = 64;  // K5c's most steps a group
constexpr int kRecoveryUnroll = 8;
constexpr int kGainRows = 256;      // K5a's steps a stage
constexpr int kGainStages = 2;      // K5a's ring slots
constexpr int kGainUnroll = 8;

// The operands of block b's share of the step, in registers.
template <class Model, int Q>
struct MeanBlockConsts {
  float Qm[Q][Q];
  float W[Q];
  float tv[Q];
  float th[Model::NTHETA];
  float K[Q];  // the frozen gain's row (K5b, K5c)
};

// Block b's operands; the frozen gain's row from kst where WITH_K (K5b,
// K5c; K5a reads a gain row a step).
template <class Model, int Q, bool WITH_K>
__device__ __forceinline__ void load_mean_block_consts(
    const QConst<Q>& qc, const float* __restrict__ W,
    const float* __restrict__ tv, const float* __restrict__ theta,
    const float* __restrict__ kst, int b, MeanBlockConsts<Model, Q>& c) {
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) c.Qm[i][j] = qc.q[i * Q + j];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    c.W[j] = W[b * Q + j];
    c.tv[j] = tv[j];
    if constexpr (WITH_K) c.K[j] = kst[b * Q + j];
  }
#pragma unroll
  for (int k = 0; k < Model::NTHETA; ++k) c.th[k] = theta[k];
}

// Block b's share of the mean step n at time t with gain row K, in place on
// its mean m: the blocks' scaled first entries exchanged by ex, the vector
// field evaluated on them in every thread, its own block's entry kept.
template <class Model, int Q, class Exchange>
__device__ __forceinline__ void mean_step_block(
    const MeanBlockConsts<Model, Q>& c, Exchange& ex, int b, int n, float t,
    const float (&K)[Q], float (&m)[Q]) {
  constexpr int NB = Model::NB;
  float mp[Q], x[NB][Q], fx[NB];
  matvec<Q>(c.Qm, m, mp);
  ex.publish(n, b, mp, c.tv);
  ex.gather(n, x);
  Model::template f<Q>(x, c.th, t, fx);
  float wm = c.W[0] * mp[0];
#pragma unroll
  for (int j = 1; j < Q; ++j) wm = wm + c.W[j] * mp[j];
  const float z = own_block(fx, b) - wm;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = mp[i] + K[i] * z;
}

// K5a: the chain over n_steps from x0, the gain of step n read from
// gains[n], every filtered mean stored; V floats a copy (4 or 1).
template <class Model, int Q, int V>
__global__ void __launch_bounds__(2 * 32)
    mean_gain_kernel(QConst<Q> qc, int n_steps, const float* __restrict__ W,
                     const float* __restrict__ tv,
                     const float* __restrict__ x0,
                     const float* __restrict__ theta,
                     const float* __restrict__ tgrid,
                     const float* __restrict__ gains, float* __restrict__ mf) {
  constexpr int NB = Model::NB, NBQ = NB * Q;
  constexpr int S = kGainRows, K = kGainStages;
  static_assert(S % 4 == 0, "a stage's slabs start 16-byte aligned");
  // a slot: the stage's gain rows [s][b][j], then its times [s]
  __shared__ __align__(16) float ring[K][S * NBQ + S];
  __shared__ __align__(16) float out[2][S * NBQ];
  const int n_stage = (n_steps + S - 1) / S;
  // stage k holds rows k S .. hi(k), the last one the rows left over
  auto hi_of = [&](int k) { return min(n_steps - 1, k * S + S - 1); };

  if (threadIdx.x < 32) {
    // the consumer thread of block b
    const int b = threadIdx.x;
    const bool live = b < NB;
    MeanBlockConsts<Model, Q> c;
    float m[Q];
    if (live) {
      load_mean_block_consts<Model, Q, false>(qc, W, tv, theta, nullptr, b,
                                              c);
#pragma unroll
      for (int j = 0; j < Q; ++j) m[j] = x0[b * Q + j];
    }
    ShuffleExchange<NB, Q, 1> ex;
    ring_consume<1, K>(n_stage, [&](int k, int slot) {
      if (!live) return;
      const float* in = ring[slot];
      float* o = out[k & 1];
      const int top = hi_of(k) - k * S;
#pragma unroll (kGainUnroll)
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        float Kg[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) Kg[j] = in[(s * NB + b) * Q + j];
        mean_step_block<Model, Q>(c, ex, b, s, in[S * NBQ + s], Kg, m);
#pragma unroll
        for (int j = 0; j < Q; ++j) o[(s * NB + b) * Q + j] = m[j];
      }
    });
    return;
  }
  // the producer warp
  const int lane = threadIdx.x % 32;
  const SlabRuns<V> rows{NB, 0, NB};
  const SlabRuns<V> steps{1, 0, 1};  // the times, one float a step
  ring_produce<1, K>(
      n_stage,
      [&](int k, int slot) {
        if (k < n_stage) {
          const int lo = k * S, hi = hi_of(k);
          rows.each(Q, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(ring[slot], gains, s, at, v);
          });
          steps.each(1, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(ring[slot] + S * NBQ, tgrid, s, at, v);
          });
        }
        commit_async();
      },
      [&](int k) {  // the means of stage k
        rows.each(Q, k * S, hi_of(k), lane, [&](int s, long long at, int v) {
          store_chunk(mf, out[k & 1], s, at, v);
        });
      });
}

// a CTA of a consumer and a producer warp, for the solve's blocks
inline SplitGeometry gain_geometry() { return {dim3(1), dim3(2 * 32)}; }

// K5b: the chain with the frozen gain over n_group groups of k_group steps
// of the tail grid tg, from m0, thread b carrying block b; group g's entry
// state goes to bnd[g].
template <class Model, int Q>
__global__ void __launch_bounds__(Model::NB, 1)
    mean_boundary_kernel(QConst<Q> qc, int n_group, int k_group,
                         const float* __restrict__ W,
                         const float* __restrict__ tv,
                         const float* __restrict__ m0,
                         const float* __restrict__ theta,
                         const float* __restrict__ tg,
                         const float* __restrict__ kst,
                         float* __restrict__ bnd) {
  constexpr int NB = Model::NB;
  const int b = threadIdx.x;
  MeanBlockConsts<Model, Q> c;
  load_mean_block_consts<Model, Q, true>(qc, W, tv, theta, kst, b, c);
  float m[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = m0[b * Q + j];
  ShuffleExchange<NB, Q, 1> ex;
  for (int g = 0; g < n_group; ++g) {
    float* entry = bnd + (static_cast<size_t>(g) * NB + b) * Q;
#pragma unroll
    for (int j = 0; j < Q; ++j) entry[j] = m[j];
    const float* t_g = tg + static_cast<size_t>(g) * k_group;
#pragma unroll (kBoundaryUnroll)
    for (int r = 0; r < k_group; ++r)
      mean_step_block<Model, Q>(c, ex, b, r, t_g[r], c.K, m);
  }
}

// one CTA of NB threads, a thread per block
template <class Model>
SplitGeometry boundary_geometry() {
  return {dim3(1), dim3(Model::NB)};
}

// K5c: the threads of group g re-run its k_group steps from bnd[g] and
// write rows g * k_group + r of the tail's means; k_group is at most
// kRecoveryGroupSteps.  A CTA is one warp of kRecoveryGroups groups, group
// g' on lanes 4 g' + b; V floats a store (4 or 1).
template <class Model, int Q, int V>
__global__ void __launch_bounds__(32)
    mean_recovery_kernel(QConst<Q> qc, int n_group, int k_group,
                         const float* __restrict__ W,
                         const float* __restrict__ tv,
                         const float* __restrict__ bnd,
                         const float* __restrict__ theta,
                         const float* __restrict__ tg,
                         const float* __restrict__ kst,
                         float* __restrict__ mf) {
  constexpr int NB = Model::NB, NBQ = NB * Q, G = kRecoveryGroups;
  constexpr int C = kRecoveryGroupSteps;
  static_assert(NB <= 4, "a group takes 4 lanes");
  // the times [g'][r] and staged means [g'][r][b][j] of the CTA's rows
  __shared__ __align__(16) float ts[G * C];
  __shared__ __align__(16) float os[G * C * NBQ];
  const int lane = threadIdx.x, gi = lane / 4;
  const int g0 = blockIdx.x * G;
  const int n_live = min(G, n_group - g0);  // the CTA's groups
  const int lo = g0 * k_group, n_row = n_live * k_group;  // and rows
  // a thread past the model's blocks or the last group runs a live
  // thread's chain (block NB-1, the CTA's last group), stores nothing
  const bool stages = lane % 4 < NB;
  const int b = min(lane % 4, NB - 1);
  const int gl = min(gi, n_live - 1);
  MeanBlockConsts<Model, Q> c;
  load_mean_block_consts<Model, Q, true>(qc, W, tv, theta, kst, b, c);
  float m[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    m[j] = bnd[(static_cast<size_t>(g0 + gl) * NB + b) * Q + j];
  ShuffleExchange<NB, Q, 1> ex;
  ex.base = lane & ~3;
  ex.mask = 0xffffffffu;  // every lane runs every step
  for (int i = lane; i < n_row; i += 32) ts[i] = tg[lo + i];
  __syncwarp();
  const float* t_g = ts + gl * k_group;
  float* o_g = os + gi * k_group * NBQ + b * Q;
#pragma unroll (kRecoveryUnroll)
  for (int r = 0; r < k_group; ++r) {
    mean_step_block<Model, Q>(c, ex, b, r, t_g[r], c.K, m);
    if (stages) {
#pragma unroll
      for (int j = 0; j < Q; ++j) o_g[r * NBQ + j] = m[j];
    }
  }
  __syncwarp();
  const SlabRuns<V> rows{NB, 0, NB};
  rows.each(Q, lo, lo + n_row - 1, lane, [&](int s, long long at, int v) {
    store_chunk(mf, os, s, at, v);
  });
}

// ceil(n_group / kRecoveryGroups) CTAs of a warp
inline SplitGeometry recovery_geometry(int n_group) {
  return {dim3((n_group + kRecoveryGroups - 1) / kRecoveryGroups), dim3(32)};
}

}  // namespace rodeo

namespace {

rodeo::QConst<3> host_qconst(const void* q_host) {
  rodeo::QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  return qc;
}

const float* in(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// model: 0 Lorenz63, 1 FitzHughNagumo.  q_host points to the 3 x 3 scaled
// transition in host memory, any matrix but the same for every block;
// every other pointer is device memory laid out as mean_gain_chain,
// mean_boundary_chain and mean_recovery_chain document.  Each returns a
// cudaError_t.
extern "C" int rodeo_mean_gain_single(int model, int n_steps,
                                      const void* q_host, const void* W,
                                      const void* tv, const void* x0,
                                      const void* theta, const void* tgrid,
                                      const void* gains, void* mf,
                                      void* stream) {
  using namespace rodeo;
  if (n_steps < 1) return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(mf);
  const bool vec = aligned16(in(gains), in(tgrid), out);
  return with_mean_instance(model, [&](auto m) {
    using M = typename decltype(m)::type;
    const SplitGeometry geo = gain_geometry();
    if (vec)
      mean_gain_kernel<M, 3, 4><<<geo.grid, geo.block, 0, s>>>(
          qc, n_steps, in(W), in(tv), in(x0), in(theta), in(tgrid),
          in(gains), out);
    else
      mean_gain_kernel<M, 3, 1><<<geo.grid, geo.block, 0, s>>>(
          qc, n_steps, in(W), in(tv), in(x0), in(theta), in(tgrid),
          in(gains), out);
    return cudaGetLastError();
  });
}

// The launch rodeo_mean_gain_single makes for the model with aligned
// operands on the current device, as report_geometry's nine ints
// (block_step.cuh), then the ring's stages and the steps a stage holds, in
// out.  Returns a cudaError_t.
extern "C" int rodeo_mean_gain_single_geometry(int model, void* out) {
  using namespace rodeo;
  auto* o = static_cast<int*>(out);
  o[9] = kGainStages;
  o[10] = kGainRows;
  return with_mean_instance(model, [&](auto m) {
    return report_geometry(
        mean_gain_kernel<typename decltype(m)::type, 3, 4>, gain_geometry(),
        o);
  });
}

extern "C" int rodeo_mean_boundary_single(int model, int n_group,
                                          int k_group, const void* q_host,
                                          const void* W, const void* tv,
                                          const void* m0, const void* theta,
                                          const void* tg, const void* kst,
                                          void* bnd, void* stream) {
  using namespace rodeo;
  if (n_group < 1 || k_group < 1) return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(bnd);
  return with_mean_instance(model, [&](auto m) {
    using M = typename decltype(m)::type;
    const SplitGeometry geo = boundary_geometry<M>();
    mean_boundary_kernel<M, 3><<<geo.grid, geo.block, 0, s>>>(
        qc, n_group, k_group, in(W), in(tv), in(m0), in(theta), in(tg),
        in(kst), out);
    return cudaGetLastError();
  });
}

// The launch rodeo_mean_boundary_single makes for the model on the current
// device, as nine ints in out.  Returns a cudaError_t.
extern "C" int rodeo_mean_boundary_single_geometry(int model, void* out) {
  using namespace rodeo;
  return with_mean_instance(model, [&](auto m) {
    using M = typename decltype(m)::type;
    return report_geometry(mean_boundary_kernel<M, 3>, boundary_geometry<M>(),
                           static_cast<int*>(out));
  });
}

// k_group at most kRecoveryGroupSteps (64, the stationary schedule's).
extern "C" int rodeo_mean_recovery_single(int model, int n_group,
                                          int k_group, const void* q_host,
                                          const void* W, const void* tv,
                                          const void* bnd, const void* theta,
                                          const void* tg, const void* kst,
                                          void* mf, void* stream) {
  using namespace rodeo;
  if (n_group < 1 || k_group < 1 || k_group > kRecoveryGroupSteps)
    return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(mf);
  const bool vec = aligned16(out);
  return with_mean_instance(model, [&](auto m) {
    using M = typename decltype(m)::type;
    const SplitGeometry geo = recovery_geometry(n_group);
    if (vec)
      mean_recovery_kernel<M, 3, 4><<<geo.grid, geo.block, 0, s>>>(
          qc, n_group, k_group, in(W), in(tv), in(bnd), in(theta), in(tg),
          in(kst), out);
    else
      mean_recovery_kernel<M, 3, 1><<<geo.grid, geo.block, 0, s>>>(
          qc, n_group, k_group, in(W), in(tv), in(bnd), in(theta), in(tg),
          in(kst), out);
    return cudaGetLastError();
  });
}

// The launch rodeo_mean_recovery_single makes for the model and n_group
// groups with an aligned output on the current device, as nine ints, then
// the groups a CTA holds and the most steps a group may have, in out.
// Returns a cudaError_t.
extern "C" int rodeo_mean_recovery_single_geometry(int model, int n_group,
                                                   void* out) {
  using namespace rodeo;
  if (n_group < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  o[9] = kRecoveryGroups;
  o[10] = kRecoveryGroupSteps;
  return with_mean_instance(model, [&](auto m) {
    return report_geometry(
        mean_recovery_kernel<typename decltype(m)::type, 3, 4>,
        recovery_geometry(n_group), o);
  });
}
