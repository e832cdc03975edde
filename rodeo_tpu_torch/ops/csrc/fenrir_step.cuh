// One step of fenrir's backward filter for a thread that carries one (block,
// lane) column: predict through the backward chain row (A_n, b_n, C_n), then
// the masked scalar observation update of step n, adding the observation's
// log-density.  Shared by K7b (fenrir_backward_batch.cu, on float) and its
// tangent twin K11b (fenrir_backward_batch_tan.cu, on Dual), so the values
// of K11b are K7b's bitwise.  The plain PyTorch version is
// _fenrir_backward_plain of ops/fused_fenrir.py, in the same order.
#pragma once

#include <cuda_runtime.h>

#include "kalman_cols.cuh"

namespace rodeo {

// One row of the backward chain, as float or Dual.
template <class T, int Q>
struct ChainRow {
  T A[Q][Q];
  T b[Q];
  T C[Tri<Q>::N];
};

// Row n of the chain (N, d, n_col) for column c.
template <int Q>
__device__ __forceinline__ void load_chain_row(int n, size_t n_col, size_t c,
                                               const float* __restrict__ A,
                                               const float* __restrict__ b,
                                               const float* __restrict__ C,
                                               ChainRow<float, Q>& row) {
  constexpr int NT = Tri<Q>::N;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j)
      row.A[i][j] = __ldg(A + (static_cast<size_t>(n) * Q * Q + i * Q + j) * n_col + c);
#pragma unroll
  for (int i = 0; i < Q; ++i)
    row.b[i] = __ldg(b + (static_cast<size_t>(n) * Q + i) * n_col + c);
#pragma unroll
  for (int k = 0; k < NT; ++k)
    row.C[k] = __ldg(C + (static_cast<size_t>(n) * NT + k) * n_col + c);
}

// One backward step of one column: predict, then the masked observation
// update of step n of block blk.  The observation grid (d, y, om, mask;
// N x .. x n_block) is shared by all lanes.
template <int Q, class T>
__device__ __forceinline__ void fenrir_step(int n, int n_block, int blk,
                                            const ChainRow<T, Q>& row,
                                            const float* __restrict__ d,
                                            const float* __restrict__ y,
                                            const float* __restrict__ om,
                                            const float* __restrict__ mask,
                                            T (&m)[Q], T (&P)[Tri<Q>::N],
                                            T& ld) {
  constexpr int NT = Tri<Q>::N;
  T mp[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = row.b[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.A[i][j] * m[j];
    mp[i] = acc;
  }
  T app[NT];
  sym_quadform<Q>(row.A, P, app);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = row.C[k] + app[k];
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = mp[i];
  float D[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) D[j] = __ldg(d + (static_cast<size_t>(n) * Q + j) * n_block + blk);
  const size_t o = static_cast<size_t>(n) * n_block + blk;
  const float mk = __ldg(mask + n);
  const T term = masked_obs_update<Q>(D, __ldg(y + o), __ldg(om + o), mk, m, P);
  ld = ld + mk * (-0.5f * term);
}

}  // namespace rodeo
