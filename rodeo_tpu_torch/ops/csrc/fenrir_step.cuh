// One step of fenrir's backward filter for a thread that carries one (block,
// lane) column: predict through the backward chain row (A_n, b_n, C_n), then
// the masked scalar observation update of step n, adding the observation's
// log-density.  Shared by K7b (fenrir_backward_batch.cu, on float) and its
// tangent twin K11b (fenrir_backward_batch_tan.cuh, on Dual); both skip the
// update at steps without data, so the values of K11b are K7b's bitwise.
// The single-solve K7a (fenrir_backward_single.cu) runs the same two halves
// (chain_step, fenrir_update) on the mask it stages with its chain.
// The plain PyTorch version is _fenrir_backward_plain of
// ops/fused_fenrir.py, in the same order.
#pragma once

#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

// The masked observation update of step n of block blk, whose mask is mk,
// adding its log-density term to ld.  The observation grid (d, y, om;
// N x .. x n_block) is shared by all lanes.
template <int Q, class T>
__device__ __forceinline__ void fenrir_update(int n, int n_block, int blk,
                                              float mk,
                                              const float* __restrict__ d,
                                              const float* __restrict__ y,
                                              const float* __restrict__ om,
                                              T (&m)[Q], T (&P)[Tri<Q>::N],
                                              T& ld) {
  float D[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) D[j] = __ldg(d + (static_cast<size_t>(n) * Q + j) * n_block + blk);
  const size_t o = static_cast<size_t>(n) * n_block + blk;
  const T term = masked_obs_update<Q>(D, __ldg(y + o), __ldg(om + o), mk, m, P);
  ld = ld + mk * (-0.5f * term);
}

// One backward step of one column: predict, then the masked observation
// update of step n.  A step whose mask is 0 stops after the prediction:
// there (D = 0, y = 0, om = 1) the update and its term leave m, P and ld as
// they were (kalman_cols.cuh), and the branch is the same for every thread.
template <int Q, class T>
__device__ __forceinline__ void fenrir_step(int n, int n_block, int blk,
                                            const ChainRow<T, Q>& row,
                                            const float* __restrict__ d,
                                            const float* __restrict__ y,
                                            const float* __restrict__ om,
                                            const float* __restrict__ mask,
                                            T (&m)[Q], T (&P)[Tri<Q>::N],
                                            T& ld) {
  chain_step<Q>(row, m, P);
  if (__ldg(mask + n) == 0.0f) return;
  fenrir_update<Q>(n, n_block, blk, __ldg(mask + n), d, y, om, m, P, ld);
}

}  // namespace rodeo
