// One step of fenrir's backward filter for a thread that carries one (block,
// lane) column: predict through the backward chain row (A_n, b_n, C_n), then
// the masked scalar observation update of step n, adding the observation's
// log-density.  Shared by K7b (fenrir_backward_batch.cu, on float), its
// single-solve counterpart K7a (fenrir_backward_single.cu) and its tangent
// twin K11b (fenrir_backward_batch_tan.cu, on Dual); K7b and K11b skip the
// update at steps without data, so the values of K11b are K7b's bitwise.
// The plain PyTorch version is _fenrir_backward_plain of
// ops/fused_fenrir.py, in the same order.
#pragma once

#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

// One backward step of one column: predict, then the masked observation
// update of step n of block blk.  The observation grid (d, y, om, mask;
// N x .. x n_block) is shared by all lanes.  With SKIP (K7b, K11b) a step whose
// mask is 0 stops after the prediction: there (D = 0, y = 0, om = 1) the
// update and its term leave m, P and ld as they were (kalman_cols.cuh), and
// the branch is the same for every thread.
template <int Q, bool SKIP = false, class T>
__device__ __forceinline__ void fenrir_step(int n, int n_block, int blk,
                                            const ChainRow<T, Q>& row,
                                            const float* __restrict__ d,
                                            const float* __restrict__ y,
                                            const float* __restrict__ om,
                                            const float* __restrict__ mask,
                                            T (&m)[Q], T (&P)[Tri<Q>::N],
                                            T& ld) {
  chain_step<Q>(row, m, P);
  if constexpr (SKIP) {
    if (__ldg(mask + n) == 0.0f) return;
  }
  float D[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) D[j] = __ldg(d + (static_cast<size_t>(n) * Q + j) * n_block + blk);
  const size_t o = static_cast<size_t>(n) * n_block + blk;
  const float mk = __ldg(mask + n);
  const T term = masked_obs_update<Q>(D, __ldg(y + o), __ldg(om + o), mk, m, P);
  ld = ld + mk * (-0.5f * term);
}

// The backward filter of one column from the seed (m, P) down through steps
// n_steps-1 .. 0, adding the log-densities to ld, for K7a.  The chain's
// loads do not depend on the carry, so the loop issues those of UNROLL
// steps before it computes them.
template <int Q, int UNROLL, class Layout>
__device__ __forceinline__ void fenrir_recursion(int n_steps, const Layout& lay, size_t c,
                                                 int n_block, int blk,
                                                 const float* __restrict__ A,
                                                 const float* __restrict__ b,
                                                 const float* __restrict__ C,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ y,
                                                 const float* __restrict__ om,
                                                 const float* __restrict__ mask,
                                                 float (&m)[Q], float (&P)[Tri<Q>::N],
                                                 float& ld) {
  int n = n_steps - 1;
  for (; n >= UNROLL - 1; n -= UNROLL) {
    ChainRow<float, Q> rows[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_chain_row<Q>(n - u, lay, c, A, b, C, rows[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      fenrir_step<Q>(n - u, n_block, blk, rows[u], d, y, om, mask, m, P, ld);
  }
  for (; n >= 0; --n) {
    ChainRow<float, Q> row;
    load_chain_row<Q>(n, lay, c, A, b, C, row);
    fenrir_step<Q>(n, n_block, blk, row, d, y, om, mask, m, P, ld);
  }
}

}  // namespace rodeo
