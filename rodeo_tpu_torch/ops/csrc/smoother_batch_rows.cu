// K2r: the lane-batched reverse affine recursion of the smoother,
//   m_n = g_n + G_n m_{n+1},   P_n = L_n + G_n P_{n+1} G_n',
// writing the public rows of the solve, already scaled to original
// coordinates: mean (N+1, NB, q, B) and packed covariance (N+1, NB, n_tri,
// B), rows 0 .. N.
//
// Replaces the TPU kernels rodeo_tpu/ops/pallas_kalman.py:
// _smoother_kernel_batch (the bare recursion, whose rows the JAX package
// assembles in XLA) and _smoother_kernel_batch_rows (the recursion writing
// the rows, at fold = 1: the port never folds lanes).  Plain PyTorch twin:
// _smoother_batch_rows_plain in ops/fused_kalman.py.
//
// Design.  One thread per (block, lane) column carries m (Q floats) and the
// packed P (Tri<Q>::N floats) in registers through all rows of one launch,
// reading the gains (T, d, NB, B) that K1 emits, lanes innermost, so a warp
// reads 32 neighbouring floats; the step and the loop are chain_step.cuh's,
// shared with K4.  The boundary rows ride the recursion as synthetic
// elements built in registers, not in device memory: first a trailing
// (G = 0, g = mN, L = pN), which emits row N and seeds the carry with the
// last filtered state exactly, and last a leading (G = 0, g = m0, L = 0),
// which emits row 0, the exact initial state with zero covariance.  Each
// row is multiplied by its scale (t_vec for the mean, t_i t_j for the packed
// covariance, float32 products as the twin forms them) and stored at
// (r, block, d, lane): neighbouring lanes are neighbouring addresses, so a
// warp's stores coalesce.  The TPU kernel's identity front-padding was
// there for its grid's divisibility and is gone.
//
// What bounds it on the card.  Device-memory bandwidth: 18 floats read and
// 9 written per step and column, plus the boundary rows (6.6 GB at 10 000
// steps x 3 blocks x 2048 lanes).  The loads of a step do not depend on the
// carry, so the loop issues the loads of kRowsUnroll steps before it
// computes them, which keeps that many steps of loads in flight per thread.
#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kRowsThreads = 64;
constexpr int kRowsUnroll = 8;

template <int Q>
__global__ void __launch_bounds__(kRowsThreads)
    smoother_batch_rows_kernel(int n_steps, int n_block, int n_lane,
                               const float* __restrict__ g,
                               const float* __restrict__ G,
                               const float* __restrict__ L,
                               const float* __restrict__ mN,
                               const float* __restrict__ pN,
                               const float* __restrict__ m0,
                               const float* __restrict__ scales,
                               float* __restrict__ mean,
                               float* __restrict__ cov) {
  constexpr int NT = Tri<Q>::N;
  const int n_col_i = n_block * n_lane;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  const size_t blk = ci / n_lane, lane = ci % n_lane;
  float sc[Q + NT];
#pragma unroll
  for (int k = 0; k < Q + NT; ++k) sc[k] = scales[k];
  // entry j of D of row r, block blk, this lane, in (N+1, NB, D, B)
  auto out = [&](int r, int j, int D) {
    return ((static_cast<size_t>(r) * n_block + blk) * D + j) * n_lane + lane;
  };
  auto store = [&](int r, const float (&mv)[Q], const float (&Pv)[NT]) {
#pragma unroll
    for (int j = 0; j < Q; ++j) mean[out(r, j, Q)] = mv[j] * sc[j];
#pragma unroll
    for (int k = 0; k < NT; ++k) cov[out(r, k, NT)] = Pv[k] * sc[Q + k];
  };

  // the trailing synthetic element onto a zero carry: row N
  float m[Q], P[NT];
  ChainRow<float, Q> row;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    m[i] = 0.0f;
    row.b[i] = mN[i * n_col + c];
#pragma unroll
    for (int j = 0; j < Q; ++j) row.A[i][j] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    P[k] = 0.0f;
    row.C[k] = pN[k * n_col + c];
  }
  chain_step<Q>(row, m, P);
  store(n_steps + 1, m, P);
  // the interior: gain row n emits public row n + 1
  smoother_recursion<Q, kRowsUnroll>(
      n_steps, BatchLayout{n_col}, c, g, G, L, m, P,
      [&](int n, const float (&mv)[Q], const float (&Pv)[NT]) { store(n + 1, mv, Pv); });
  // the leading synthetic element: row 0
#pragma unroll
  for (int i = 0; i < Q; ++i) row.b[i] = m0[i * n_col + c];
#pragma unroll
  for (int k = 0; k < NT; ++k) row.C[k] = 0.0f;
  chain_step<Q>(row, m, P);
  store(0, m, P);
}

}  // namespace rodeo

// n_steps counts the interior rows (T = N - 1); scales holds the q mean and
// n_tri covariance scales.  Every pointer is device memory laid out as
// smoother_recursion_batch_rows (ops/fused_kalman.py) documents.  Returns a
// cudaError_t.
extern "C" int rodeo_smoother_batch_rows(int n_steps, int n_block, int n_lane,
                                         const void* g, const void* G,
                                         const void* L, const void* mN,
                                         const void* pN, const void* m0,
                                         const void* scales, void* mean,
                                         void* cov, void* stream) {
  using namespace rodeo;
  if (n_steps < 0 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const int n_col = n_block * n_lane;
  const dim3 block(kRowsThreads);
  const dim3 grid((n_col + kRowsThreads - 1) / kRowsThreads);
  smoother_batch_rows_kernel<3><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_block, n_lane, static_cast<const float*>(g),
      static_cast<const float*>(G), static_cast<const float*>(L),
      static_cast<const float*>(mN), static_cast<const float*>(pN),
      static_cast<const float*>(m0), static_cast<const float*>(scales),
      static_cast<float*>(mean), static_cast<float*>(cov));
  return cudaGetLastError();
}
