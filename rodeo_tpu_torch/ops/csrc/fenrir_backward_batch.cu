// K7b: lane-batched backward filter of the fenrir likelihood.  From the seed
// at step N, for n = N-1 down to 0: predict through the backward chain,
//   m = A_n m + b_n,   P = A_n P A_n' + C_n,
// then the masked scalar observation update with (d_n, y_n, om_n, mask_n),
// summing the observations' log-densities.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _fenrir_backward_kernel_batch.  Plain PyTorch twin: _fenrir_backward_plain
// in ops/fused_fenrir.py.
//
// Design.  The backward chain and the observation model are block-diagonal,
// so one thread carries one (block, lane) column: m (Q floats), the packed
// P (Tri<Q>::N floats) and its block's log-density sum, in registers through
// all N steps of one launch, as K2r (smoother_batch_rows.cu) does.  That gives
// NB x B threads (6144 at 3 blocks x 2048 lanes) where one thread per lane
// would give B.  Each thread writes its block's sum to (NB, B); the wrapper
// adds the blocks in block order.  The step and the loop (fenrir_step.cuh)
// are shared with the single-solve K7a and, the step, with the tangent
// kernel K11b.  The chain (A, b, C) is (N, d, NB, B) with lanes innermost,
// so a warp reads 32 neighbouring floats; the observation grid (N, .., NB)
// is shared by all lanes and comes from cache.  The TPU kernel's chunk grid
// and lane fold are gone.
//
// What bounds it on the card.  Each step reads 18 floats per column (A 9,
// b 3, C 6) for ~200 float operations, and writes nothing: a streaming
// kernel bound by device-memory bandwidth (18 x 4 B x N x NB x B, 1.77 GB at
// 4000 steps x 3 blocks x 2048 lanes).  The loads of a step do not depend on
// the carry, so the loop issues the loads of kFenrirUnroll steps before it
// computes them, which keeps that many steps of loads in flight per thread.
#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kFenrirThreads = 64;
constexpr int kFenrirUnroll = 8;

template <int Q>
__global__ void __launch_bounds__(kFenrirThreads)
    fenrir_backward_kernel(int n_steps, int n_block, int n_lane,
                           const float* __restrict__ A,
                           const float* __restrict__ b,
                           const float* __restrict__ C,
                           const float* __restrict__ d,
                           const float* __restrict__ y,
                           const float* __restrict__ om,
                           const float* __restrict__ mask,
                           const float* __restrict__ m_seed,
                           const float* __restrict__ p_seed,
                           float* __restrict__ ld_blocks) {
  constexpr int NT = Tri<Q>::N;
  const int n_col_i = n_block * n_lane;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  const int blk = ci / n_lane;
  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = m_seed[j * n_col + c];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = p_seed[k * n_col + c];
  float ld = 0.0f;
  fenrir_recursion<Q, kFenrirUnroll>(n_steps, BatchLayout{n_col}, c, n_block, blk, A, b, C,
                                     d, y, om, mask, m, P, ld);
  ld_blocks[c] = ld;
}

}  // namespace rodeo

// Every pointer is device memory laid out as fenrir_backward_batch
// (ops/fused_fenrir.py) documents; ld_blocks is (n_block, B).  Returns a
// cudaError_t.
extern "C" int rodeo_fenrir_backward_batch(int n_steps, int n_block,
                                           int n_lane, const void* A,
                                           const void* b, const void* C,
                                           const void* d, const void* y,
                                           const void* om, const void* mask,
                                           const void* m_seed,
                                           const void* p_seed,
                                           void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const int n_col = n_block * n_lane;
  const dim3 block(kFenrirThreads);
  const dim3 grid((n_col + kFenrirThreads - 1) / kFenrirThreads);
  fenrir_backward_kernel<3><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_block, n_lane, static_cast<const float*>(A),
      static_cast<const float*>(b), static_cast<const float*>(C),
      static_cast<const float*>(d), static_cast<const float*>(y),
      static_cast<const float*>(om), static_cast<const float*>(mask),
      static_cast<const float*>(m_seed), static_cast<const float*>(p_seed),
      static_cast<float*>(ld_blocks));
  return cudaGetLastError();
}
