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
// Design.  MAGI has no ODE callback, so the blocks of a lane are independent:
// one thread carries one (block, lane) column, its mean (Q floats), packed
// covariance (Tri<Q>::N floats) and its block's log-density sum in registers
// through all N steps, as K7b does.  That gives NB x B threads (6144 at 3
// blocks x 2048 lanes).  Each thread writes its block's sum to (NB, B); the
// wrapper adds the blocks in block order (the JAX kernel adds them every
// step, which differs only by rounding).  The data x and the streams are
// (N, d, NB, B) with lanes innermost (chain_step.cuh's BatchLayout), so a
// warp reads and writes 32 neighbouring floats.  The exact zeros of the
// update are kept: they make the adjoint's coefficients independent of the
// data.  The TPU kernel's chunk grid and lane fold are gone.
//
// What bounds it on the card.  With emit "ld" each step reads ACT floats per
// column for ~100 float operations: 196.6 MB at 4000 steps x 3 blocks x 2048
// lanes, a bound of 0.059 ms at 3.35 TB/s, far below one thread's serial
// chain of dependent operations, so the kernel is latency-bound.  With
// EMIT_ADJOINT it also writes 9 floats per step (ACT = 2): 688.1 MB, 0.264 ms.
// The loads of x do not depend on the carry, so the loop issues the loads of
// kMagiUnroll steps before it computes them.
#include <cstring>

#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kMagiThreads = 32;
constexpr int kMagiUnroll = 4;

// One MAGI step of one column: m, P updated in place, the block's term
// -0.5 (quad + log det + ACT log 2 pi) added to ld; the adjoint's streams
// of step n stored when EMIT.
template <int Q, int ACT, bool EMIT>
__device__ __forceinline__ void magi_step(const float (&Qm)[Q][Q],
                                          const float (&R)[Tri<Q>::N],
                                          const float (&xr)[ACT], int n,
                                          const BatchLayout& lay, size_t c,
                                          float (&m)[Q], float (&P)[Tri<Q>::N],
                                          float& ld, float* __restrict__ z_out,
                                          float* __restrict__ s_out,
                                          float* __restrict__ g_out) {
  constexpr int NT = Tri<Q>::N;
  constexpr int NTA = Tri<ACT>::N;
  // ACT log 2 pi, rounded to float32 as PyTorch rounds the Python float
  constexpr float kActLog2Pi = static_cast<float>(ACT * 1.8378770664093453);
  float mp[Q], pp[NT];
  matvec<Q>(Qm, m, mp);
  sym_quadform<Q>(Qm, P, pp);
#pragma unroll
  for (int k = 0; k < NT; ++k) pp[k] = pp[k] + R[k];
  float S[NTA], inv_S[NTA], z[ACT];
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
  float G[Q > ACT ? Q - ACT : 1][ACT];
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
  if constexpr (EMIT) {
#pragma unroll
    for (int j = 0; j < ACT; ++j) z_out[lay(n, j, c, ACT)] = z[j];
#pragma unroll
    for (int k = 0; k < NTA; ++k) s_out[lay(n, k, c, NTA)] = inv_S[k];
#pragma unroll
    for (int i = ACT; i < Q; ++i)
#pragma unroll
      for (int a = 0; a < ACT; ++a)
        g_out[lay(n, (i - ACT) * ACT + a, c, (Q - ACT) * ACT)] = G[i - ACT][a];
  }
}

template <int Q, int ACT, bool EMIT>
__global__ void __launch_bounds__(kMagiThreads)
    magi_kernel(QConst<Q> qc, int n_steps, int n_block, int n_lane, int r_lanes,
                const float* __restrict__ x, const float* __restrict__ R_in,
                const float* __restrict__ m0, float* __restrict__ ld_blocks,
                float* __restrict__ z_out, float* __restrict__ s_out,
                float* __restrict__ g_out) {
  constexpr int NT = Tri<Q>::N;
  const int n_col_i = n_block * n_lane;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  const int blk = ci / n_lane, lane = ci % n_lane;
  const BatchLayout lay{n_col};
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
  int n = 0;
  for (; n + kMagiUnroll <= n_steps; n += kMagiUnroll) {
    float xr[kMagiUnroll][ACT];
#pragma unroll
    for (int u = 0; u < kMagiUnroll; ++u)
#pragma unroll
      for (int j = 0; j < ACT; ++j) xr[u][j] = __ldg(x + lay(n + u, j, c, ACT));
#pragma unroll
    for (int u = 0; u < kMagiUnroll; ++u)
      magi_step<Q, ACT, EMIT>(Qm, R, xr[u], n + u, lay, c, m, P, ld, z_out, s_out, g_out);
  }
  for (; n < n_steps; ++n) {
    float xr[ACT];
#pragma unroll
    for (int j = 0; j < ACT; ++j) xr[j] = __ldg(x + lay(n, j, c, ACT));
    magi_step<Q, ACT, EMIT>(Qm, R, xr, n, lay, c, m, P, ld, z_out, s_out, g_out);
  }
  ld_blocks[c] = ld;
}

template <int ACT, bool EMIT>
cudaError_t magi_launch(const QConst<3>& qc, int n_steps, int n_block,
                        int n_lane, int r_lanes, const float* x,
                        const float* R, const float* m0, float* ld_blocks,
                        float* z, float* s_inv, float* G,
                        cudaStream_t stream) {
  const int n_col = n_block * n_lane;
  const dim3 block(kMagiThreads);
  const dim3 grid((n_col + kMagiThreads - 1) / kMagiThreads);
  magi_kernel<3, ACT, EMIT><<<grid, block, 0, stream>>>(
      qc, n_steps, n_block, n_lane, r_lanes, x, R, m0, ld_blocks, z, s_inv, G);
  return cudaGetLastError();
}

}  // namespace rodeo

// act: 1, 2 or 3; emit_adjoint: 0 or 1; r_lane_stride: 0 when R is shared by
// the lanes, 1 when it has one column per lane.  q_host points to the 3 x 3
// scaled transition in host memory; every other pointer is device memory
// laid out as magi_filter_batch (ops/fused_magi.py) documents, ld_blocks is
// (n_block, B), and z, s_inv and G are written only with emit_adjoint (G
// only when act < 3).  Returns a cudaError_t.
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
  switch (act * 2 + (emit_adjoint ? 1 : 0)) {
    case 2:
      return magi_launch<1, false>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 3:
      return magi_launch<1, true>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 4:
      return magi_launch<2, false>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 5:
      return magi_launch<2, true>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 6:
      return magi_launch<3, false>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    case 7:
      return magi_launch<3, true>(qc, n_steps, n_block, n_lane, r_lanes, xp, rp, mp, lp, zp, sp, gp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
