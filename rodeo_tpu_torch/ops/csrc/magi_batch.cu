// K10a: lane-batched MAGI filter on exact pseudo-observations.  From the seed
// state (m0, P = 0), for each step n = 1..N: predict through the constant
// scaled transition, mp = Q m, pp = Q P Q' + R; add the forecast log-density
// of the active block,
//   -0.5 (z' S^{-1} z + log det S + ACT log 2 pi),  S = pp[:ACT, :ACT],
//   z = x_n - mp[:ACT];
// then condition on the exact data: the active rows of the mean become x_n,
// the inactive ones mp[i] + G[i] z with G = P_ia S^{-1}, and the covariance
// keeps pp_ii - G P_ai on the inactive block and exact zeros elsewhere.  With
// EMIT_ADJOINT, each step's z, packed S^{-1} and G are stored for the adjoint
// K10b (magi_adjoint_batch.cu).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_magi.py: _magi_kernel_batch.
// Plain PyTorch twin: _magi_batch_plain in ops/fused_magi.py.
//
// What bounds it on the card.  MAGI has no ODE callback, so the blocks of a
// lane are independent: NB x B (block, lane) columns (6144 at 3 blocks x 2048
// lanes), each a serial chain.  The carry's dependent chain at ACT = 2 is 14
// float operations a step (the one carried entry of P through Q P Q' + R, S's
// inverse, G, and P's update; the others are exact zeros), 0.11 ms over 4000
// steps.  Its bytes: with emit "ld" each step reads ACT floats per column,
// 196.6 MB at 4000 steps x 6144 columns, 0.059 ms at 3.35 TB/s; with
// EMIT_ADJOINT it also writes 7 floats per step (ACT = 2), 0.264 ms.  One
// thread per column loading x a few steps ahead, 32 columns a CTA, waited
// for device memory every few steps with no other warp on its SM to hide
// it: ~200 ns a step.
//
// Design.  A forward column stream on stream_ring.cuh's ring (FWD): CTAs of
// kStreamCols (block, lane) columns (192 CTAs at 3 x 2048), one consumer warp
// and a producer warp.  The producer fills a ring of shared-memory stages
// with x's ACT rows of each step by cp.async, 16 bytes a copy where the rows
// are 16-byte aligned, else 4 (StageCopies), the last stage holding the
// steps left over.  The consumer thread of column t carries its mean, packed
// covariance and its block's log-density sum in registers from step 0 up to
// N - 1, reading x from the stage, and runs magi_step in the twin's order;
// R (one column per block, or per (block, lane)) is read once.  With
// EMIT_ADJOINT the consumer stages each step's z, S^{-1} and G rows in
// shared memory and the producer stores them, 16 bytes at a time where
// aligned (stream_stages, as K6 and K2r store theirs).  Each consumer
// thread writes its block's sum to (NB, B); the wrapper adds the blocks in
// block order (the JAX kernel adds them every step, which differs only by
// rounding).  The exact zeros of the update are kept: they make the
// adjoint's coefficients independent of the data.  The TPU kernel's chunk
// grid and lane fold are gone.  On the card a step then takes ~340 cycles
// of the consumer warp's ~125 instructions, one warp to a scheduler: the
// in-order issue of the step's division, logarithm and chain, not the
// loads, which most rings of 2-8 stages of 4-16 steps hide alike (within 3
// % of the fastest, each emit's fastest kept; PERF.md).  CTAs of 16
// columns (384 CTAs) were 24 % slower, and leaving P's exact zeros out of
// Q P Q' saved ~10 instructions a step (the compiler drops most of them)
// and no time.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

// the rings, steps per stage and stages: emit "ld", emit "adjoint" (the
// fastest of each sweep on the card, PERF.md)
constexpr int kMagiLdSteps = 8;
constexpr int kMagiLdStages = 8;
constexpr int kMagiAdjSteps = 8;
constexpr int kMagiAdjStages = 3;

// the output rows of a step with EMIT_ADJOINT: z (ACT), packed S^{-1},
// G ((Q - ACT) ACT, row-major in (i - ACT, a))
template <int Q, int ACT>
constexpr int kMagiOutRows = ACT + Tri<ACT>::N + (Q - ACT) * ACT;

// One MAGI step of one column: m, P updated in place, the block's term
// -0.5 (quad + log det + ACT log 2 pi) added to ld; the step's z, packed
// S^{-1} and G (the adjoint's streams) in z, inv_S and G.
template <int Q, int ACT>
__device__ __forceinline__ void magi_step(
    const float (&Qm)[Q][Q], const float (&R)[Tri<Q>::N],
    const float (&xr)[ACT], float (&m)[Q], float (&P)[Tri<Q>::N], float& ld,
    float (&z)[ACT], float (&inv_S)[Tri<ACT>::N],
    float (&G)[Q > ACT ? Q - ACT : 1][ACT]) {
  constexpr int NT = Tri<Q>::N;
  constexpr int NTA = Tri<ACT>::N;
  // ACT log 2 pi, rounded to float32 as PyTorch rounds the Python float
  constexpr float kActLog2Pi = static_cast<float>(ACT * 1.8378770664093453);
  float mp[Q], pp[NT];
  matvec<Q>(Qm, m, mp);
  sym_quadform<Q>(Qm, P, pp);
#pragma unroll
  for (int k = 0; k < NT; ++k) pp[k] = pp[k] + R[k];
  float S[NTA];
#pragma unroll
  for (int i = 0; i < ACT; ++i)
#pragma unroll
    for (int j = i; j < ACT; ++j) S[Tri<ACT>::at(i, j)] = pp[Tri<Q>::at(i, j)];
#pragma unroll
  for (int j = 0; j < ACT; ++j) z[j] = xr[j] - mp[j];
  sym_inv<ACT>(S, inv_S);
  float quad = z[0] * inv_S[0] * z[0];
#pragma unroll
  for (int i = 0; i < ACT; ++i)
#pragma unroll
    for (int j = 0; j < ACT; ++j)
      if (i > 0 || j > 0) quad = quad + z[i] * inv_S[Tri<ACT>::at(i, j)] * z[j];
  const float det = sym_det<ACT>(S);
  ld = ld + (-0.5f) * (quad + logf(det) + kActLog2Pi);
  // the exact-observation update
#pragma unroll
  for (int i = ACT; i < Q; ++i)
#pragma unroll
    for (int a = 0; a < ACT; ++a) {
      float acc = pp[Tri<Q>::at(i, 0)] * inv_S[Tri<ACT>::at(0, a)];
#pragma unroll
      for (int b = 1; b < ACT; ++b) acc = acc + pp[Tri<Q>::at(i, b)] * inv_S[Tri<ACT>::at(b, a)];
      G[i - ACT][a] = acc;
    }
#pragma unroll
  for (int j = 0; j < ACT; ++j) m[j] = xr[j];
#pragma unroll
  for (int i = ACT; i < Q; ++i) {
    float acc = mp[i];
#pragma unroll
    for (int a = 0; a < ACT; ++a) acc = acc + G[i - ACT][a] * z[a];
    m[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = i; j < Q; ++j) {
      float acc = 0.0f;
      if (i >= ACT) {  // then j >= ACT too
        acc = pp[Tri<Q>::at(i, j)];
#pragma unroll
        for (int a = 0; a < ACT; ++a) acc = acc - G[i - ACT][a] * pp[Tri<Q>::at(a, j)];
      }
      P[Tri<Q>::at(i, j)] = acc;
    }
}

template <int Q, int ACT, bool EMIT, int V>
__global__ void __launch_bounds__(2 * kStreamCols)
    magi_kernel(QConst<Q> qc, int n_steps, int n_block, int n_lane, int r_lanes,
                const float* __restrict__ x, const float* __restrict__ R_in,
                const float* __restrict__ m0, float* __restrict__ ld_blocks,
                float* __restrict__ z_out, float* __restrict__ s_out,
                float* __restrict__ g_out) {
  using Rows = StreamRows<ACT>;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTA = Tri<ACT>::N;
  constexpr int S = EMIT ? kMagiAdjSteps : kMagiLdSteps;
  constexpr int K = EMIT ? kMagiAdjStages : kMagiLdStages;
  __shared__ __align__(16) float ring[K][S][Rows::R][kStreamCols];
  const int n_col_i = n_block * n_lane;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  // the consumer thread t < width carries column col0 + t; the others (and
  // the producer warp) shadow the CTA's first column
  const int t = threadIdx.x;
  const bool live = t < width;
  const size_t c = col0 + (live ? t : 0);
  const int ci = static_cast<int>(c);
  const int blk = ci / n_lane, lane = ci % n_lane;
  float Qm[Q][Q], R[NT];
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) Qm[i][j] = qc.q[i * Q + j];
  // R is (NT, NB, r_lanes): one column per block, or one per (block, lane)
  const size_t r_off = r_lanes > 1 ? static_cast<size_t>(blk) * n_lane + lane : blk;
  const size_t r_stride = static_cast<size_t>(n_block) * r_lanes;
#pragma unroll
  for (int k = 0; k < NT; ++k) R[k] = R_in[k * r_stride + r_off];
  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = m0[j * n_col + c];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;
  float ld = 0.0f;
  const float* const ops[] = {x};

  if constexpr (EMIT) {
    constexpr int O = kMagiOutRows<Q, ACT>;
    __shared__ __align__(16) float out[2][S][O][kStreamCols];
    // the producer thread's chunk of a row
    const size_t chunk = col0 + chunk_col<V>(threadIdx.x % kStreamCols);
    stream_stages<Rows, O, V, S, K, true>(
        ring, out, n_steps, n_col, col0, width, ops,
        [&](int, const float (&v)[Rows::R], float (&o)[O][kStreamCols],
            int tc) {
          float z[ACT], inv_S[NTA], G[Q > ACT ? Q - ACT : 1][ACT];
          magi_step<Q, ACT>(Qm, R, v, m, P, ld, z, inv_S, G);
#pragma unroll
          for (int j = 0; j < ACT; ++j) o[j][tc] = z[j];
#pragma unroll
          for (int k = 0; k < NTA; ++k) o[ACT + k][tc] = inv_S[k];
#pragma unroll
          for (int i = ACT; i < Q; ++i)
#pragma unroll
            for (int a = 0; a < ACT; ++a)
              o[ACT + NTA + (i - ACT) * ACT + a][tc] = G[i - ACT][a];
        },
        // output row o of step n: a row of z, of s_inv or of G
        [&](int n, int o) {
          if (o < ACT)
            return z_out + (static_cast<size_t>(n) * ACT + o) * n_col + chunk;
          if (o < ACT + NTA)
            return s_out + (static_cast<size_t>(n) * NTA + o - ACT) * n_col +
                   chunk;
          return g_out +
                 (static_cast<size_t>(n) * (Q - ACT) * ACT + o - ACT - NTA) *
                     n_col +
                 chunk;
        });
    if (live) ld_blocks[c] = ld;
    return;
  } else {
    const int n_stage = (n_steps + S - 1) / S;
    if (threadIdx.x < kStreamCols) {
      ring_consume<1, K>(n_stage, [&](int k, int slot) {
        if (!live) return;
        const float(&in)[S][Rows::R][kStreamCols] = ring[slot];
        const int top = n_steps - 1 - k * S;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s > top) break;
          float xr[ACT], z[ACT], inv_S[NTA], G[Q > ACT ? Q - ACT : 1][ACT];
#pragma unroll
          for (int j = 0; j < ACT; ++j) xr[j] = in[s][j][t];
          magi_step<Q, ACT>(Qm, R, xr, m, P, ld, z, inv_S, G);
        }
      });
      if (live) ld_blocks[c] = ld;
      return;
    }
    // the producer warp
    const StageCopies<Rows, V> w(threadIdx.x % kStreamCols, n_col, col0, ops);
    ring_produce<1, K>(
        n_stage,
        [&](int k, int slot) {
          fill_stage<Rows, V, S, true>(ring[slot], k, n_stage, n_steps, width,
                                       w);
        },
        [](int) {});
  }
}

inline SplitGeometry magi_geometry(int n_col) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols), stream_cta()};
}

template <int ACT, bool EMIT, int V>
cudaError_t magi_launch(const QConst<3>& qc, int n_steps, int n_block,
                        int n_lane, int r_lanes, const float* x,
                        const float* R, const float* m0, float* ld_blocks,
                        float* z, float* s_inv, float* G,
                        cudaStream_t stream) {
  const SplitGeometry geo = magi_geometry(n_block * n_lane);
  magi_kernel<3, ACT, EMIT, V><<<geo.grid, geo.block, 0, stream>>>(
      qc, n_steps, n_block, n_lane, r_lanes, x, R, m0, ld_blocks, z, s_inv, G);
  return cudaGetLastError();
}

template <int ACT, bool EMIT>
cudaError_t magi_dispatch(bool vec, const QConst<3>& qc, int n_steps,
                        int n_block, int n_lane, int r_lanes, const float* x,
                        const float* R, const float* m0, float* ld_blocks,
                        float* z, float* s_inv, float* G,
                        cudaStream_t stream) {
  auto* launch = vec ? &magi_launch<ACT, EMIT, 4> : &magi_launch<ACT, EMIT, 1>;
  return launch(qc, n_steps, n_block, n_lane, r_lanes, x, R, m0, ld_blocks, z,
                s_inv, G, stream);
}

template <int ACT, bool EMIT>
cudaError_t magi_geometry_of(int n_col, int* out) {
  return n_col % 4 == 0
             ? report_geometry(magi_kernel<3, ACT, EMIT, 4>,
                               magi_geometry(n_col), out)
             : report_geometry(magi_kernel<3, ACT, EMIT, 1>,
                               magi_geometry(n_col), out);
}

}  // namespace rodeo

// act: 1, 2 or 3; emit_adjoint: 0 or 1; r_lane_stride: 0 when R is shared by
// the lanes, 1 when it has one column per lane.  q_host points to the 3 x 3
// scaled transition in host memory; every other pointer is device memory
// laid out as magi_filter_batch (ops/fused_magi.py) documents, ld_blocks is
// (n_block, B), and z, s_inv and G are written only with emit_adjoint (G
// only when act < 3).  Rows go 16 bytes at a time where n_block x B is a
// multiple of 4 and x (and the streams written) are 16-byte aligned, else 4
// bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_magi_batch(int act, int emit_adjoint, int n_steps,
                                int n_block, int n_lane, int r_lane_stride,
                                const void* q_host, const void* x,
                                const void* R, const void* m0,
                                void* ld_blocks, void* z, void* s_inv,
                                void* G, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  if (emit_adjoint && (z == nullptr || s_inv == nullptr || (act < 3 && G == nullptr)))
    return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  const int r_lanes = r_lane_stride ? n_lane : 1;
  const auto* xp = static_cast<const float*>(x);
  const auto* rp = static_cast<const float*>(R);
  const auto* mp = static_cast<const float*>(m0);
  auto* lp = static_cast<float*>(ld_blocks);
  auto* zp = static_cast<float*>(z);
  auto* sp = static_cast<float*>(s_inv);
  auto* gp = static_cast<float*>(G);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_col = n_block * n_lane;
  const bool vec = emit_adjoint ? stream_aligned(n_col, xp, zp, sp, gp)
                                : stream_aligned(n_col, xp);
  switch (act * 2 + (emit_adjoint ? 1 : 0)) {
    case 2:
      return magi_dispatch<1, false>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 3:
      return magi_dispatch<1, true>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 4:
      return magi_dispatch<2, false>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 5:
      return magi_dispatch<2, true>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 6:
      return magi_dispatch<3, false>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 7:
      return magi_dispatch<3, true>(vec, qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch rodeo_magi_batch makes for act, emit_adjoint and n_block x
// n_lane columns with aligned operands on the current device, as
// report_geometry's nine ints (block_step.cuh), then the ring's stages, the
// steps a stage holds and the columns a CTA holds, in out.  Returns a
// cudaError_t.
extern "C" int rodeo_magi_batch_geometry(int act, int emit_adjoint,
                                         int n_block, int n_lane, void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const int n_col = n_block * n_lane;
  cudaError_t err;
  switch (act * 2 + (emit_adjoint ? 1 : 0)) {
    case 2: err = magi_geometry_of<1, false>(n_col, o); break;
    case 3: err = magi_geometry_of<1, true>(n_col, o); break;
    case 4: err = magi_geometry_of<2, false>(n_col, o); break;
    case 5: err = magi_geometry_of<2, true>(n_col, o); break;
    case 6: err = magi_geometry_of<3, false>(n_col, o); break;
    case 7: err = magi_geometry_of<3, true>(n_col, o); break;
    default: return cudaErrorInvalidValue;
  }
  o[9] = emit_adjoint ? kMagiAdjStages : kMagiLdStages;
  o[10] = emit_adjoint ? kMagiAdjSteps : kMagiLdSteps;
  o[11] = kStreamCols;
  return err;
}
