// K10b: exact reverse adjoint of the MAGI filter's log-density (K10a,
// magi_batch.cu) in the scaled path.  The filter's covariances never see the
// data, so the adjoint is a linear backward recursion over the coefficients
// K10a streamed: with lam the gradient in the state, zero after step N, for
// n = N..1,
//   v = S^{-1} z,   t_a = sum_{i >= ACT} G[i][a] lam[i],
//   dL/dx_n = lam[:ACT] + t - v,   lam <- Q' [v - t ; lam[ACT:]],
// and the gradient in the seed state is the final lam.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_magi.py:
// _magi_adjoint_kernel_batch.  Plain PyTorch twin: _magi_adjoint_batch_plain
// in ops/fused_magi.py.
//
// Design.  As K10a: one thread per (block, lane) column (the blocks are
// independent), lam (Q floats) in registers through all N steps, the streams
// (N, d, NB, B) with lanes innermost (BatchLayout), read last step first.
// When Q == ACT there is no G stream and t is zero.  The transposed constant
// transition is built from the host constant once per thread.
//
// What bounds it on the card.  Each step reads ACT + Tri<ACT>::N +
// (Q - ACT) ACT floats per column (9 at ACT = 2) and writes ACT, for ~30
// float operations: 688.1 MB read and 196.6 MB written at 4000 steps x 3
// blocks x 2048 lanes, a bound of 0.264 ms at 3.35 TB/s.  A streaming kernel
// bound by device-memory bandwidth, if enough loads are in flight; the loads
// of a step do not depend on lam, so the loop issues kAdjUnroll steps' loads
// before it computes them.
#include <cstring>

#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kAdjThreads = 32;
constexpr int kAdjUnroll = 4;

template <int Q, int ACT>
struct AdjRow {
  float z[ACT];
  float s[Tri<ACT>::N];
  float G[Q > ACT ? (Q - ACT) * ACT : 1];
};

template <int Q, int ACT>
__device__ __forceinline__ void load_adj_row(int n, const BatchLayout& lay, size_t c,
                                             const float* __restrict__ z,
                                             const float* __restrict__ s_inv,
                                             const float* __restrict__ G,
                                             AdjRow<Q, ACT>& row) {
  constexpr int NTA = Tri<ACT>::N;
  constexpr int NG = (Q - ACT) * ACT;
#pragma unroll
  for (int j = 0; j < ACT; ++j) row.z[j] = __ldg(z + lay(n, j, c, ACT));
#pragma unroll
  for (int k = 0; k < NTA; ++k) row.s[k] = __ldg(s_inv + lay(n, k, c, NTA));
#pragma unroll
  for (int k = 0; k < NG; ++k) row.G[k] = __ldg(G + lay(n, k, c, NG));
}

// One reverse step: gx of step n written, lam carried, in the twin's order.
template <int Q, int ACT>
__device__ __forceinline__ void adjoint_step(const float (&Qt)[Q][Q], const AdjRow<Q, ACT>& row,
                                             int n, const BatchLayout& lay, size_t c,
                                             float (&lam)[Q], float* __restrict__ gx) {
  float v[ACT], t[ACT];
#pragma unroll
  for (int a = 0; a < ACT; ++a) {
    float acc = row.s[Tri<ACT>::at(a, 0)] * row.z[0];
#pragma unroll
    for (int b = 1; b < ACT; ++b) acc = acc + row.s[Tri<ACT>::at(a, b)] * row.z[b];
    v[a] = acc;
  }
#pragma unroll
  for (int a = 0; a < ACT; ++a) {
    float acc = 0.0f;
    if constexpr (Q > ACT) {
      acc = row.G[a] * lam[ACT];
#pragma unroll
      for (int i = ACT + 1; i < Q; ++i) acc = acc + row.G[(i - ACT) * ACT + a] * lam[i];
    }
    t[a] = acc;
  }
#pragma unroll
  for (int a = 0; a < ACT; ++a) gx[lay(n, a, c, ACT)] = lam[a] + t[a] - v[a];
  float u[Q];
#pragma unroll
  for (int a = 0; a < ACT; ++a) u[a] = v[a] - t[a];
#pragma unroll
  for (int i = ACT; i < Q; ++i) u[i] = lam[i];
  matvec<Q>(Qt, u, lam);
}

template <int Q, int ACT>
__global__ void __launch_bounds__(kAdjThreads)
    magi_adjoint_kernel(QConst<Q> qc, int n_steps, int n_block, int n_lane,
                        const float* __restrict__ z, const float* __restrict__ s_inv,
                        const float* __restrict__ G, float* __restrict__ gx,
                        float* __restrict__ lam0) {
  const int n_col_i = n_block * n_lane;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  const BatchLayout lay{n_col};
  // the transposed transition: Qt[i][j] = Q[j][i]
  float Qt[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) Qt[i][j] = qc.q[j * Q + i];
  float lam[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) lam[j] = 0.0f;
  int n = n_steps - 1;
  for (; n >= kAdjUnroll - 1; n -= kAdjUnroll) {
    AdjRow<Q, ACT> rows[kAdjUnroll];
#pragma unroll
    for (int u = 0; u < kAdjUnroll; ++u) load_adj_row<Q, ACT>(n - u, lay, c, z, s_inv, G, rows[u]);
#pragma unroll
    for (int u = 0; u < kAdjUnroll; ++u) adjoint_step<Q, ACT>(Qt, rows[u], n - u, lay, c, lam, gx);
  }
  for (; n >= 0; --n) {
    AdjRow<Q, ACT> row;
    load_adj_row<Q, ACT>(n, lay, c, z, s_inv, G, row);
    adjoint_step<Q, ACT>(Qt, row, n, lay, c, lam, gx);
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) lam0[j * n_col + c] = lam[j];
}

template <int ACT>
cudaError_t magi_adjoint_launch(const QConst<3>& qc, int n_steps, int n_block,
                                int n_lane, const float* z, const float* s_inv,
                                const float* G, float* gx, float* lam0,
                                cudaStream_t stream) {
  const int n_col = n_block * n_lane;
  const dim3 block(kAdjThreads);
  const dim3 grid((n_col + kAdjThreads - 1) / kAdjThreads);
  magi_adjoint_kernel<3, ACT><<<grid, block, 0, stream>>>(
      qc, n_steps, n_block, n_lane, z, s_inv, G, gx, lam0);
  return cudaGetLastError();
}

}  // namespace rodeo

// act: 1, 2 or 3.  q_host points to the 3 x 3 scaled transition (not
// transposed) in host memory; every other pointer is device memory laid out
// as magi_adjoint_batch (ops/fused_magi.py) documents (G is read only when
// act < 3).  Returns a cudaError_t.
extern "C" int rodeo_magi_adjoint_batch(int act, int n_steps, int n_block,
                                        int n_lane, const void* q_host,
                                        const void* z, const void* s_inv,
                                        const void* G, void* gx, void* lam0,
                                        void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  if (act < 3 && G == nullptr) return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  const auto* zp = static_cast<const float*>(z);
  const auto* sp = static_cast<const float*>(s_inv);
  const auto* gp = static_cast<const float*>(G);
  auto* xp = static_cast<float*>(gx);
  auto* lp = static_cast<float*>(lam0);
  auto s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 1:
      return magi_adjoint_launch<1>(qc, n_steps, n_block, n_lane, zp, sp, gp, xp, lp, s);
    case 2:
      return magi_adjoint_launch<2>(qc, n_steps, n_block, n_lane, zp, sp, gp, xp, lp, s);
    case 3:
      return magi_adjoint_launch<3>(qc, n_steps, n_block, n_lane, zp, sp, gp, xp, lp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
