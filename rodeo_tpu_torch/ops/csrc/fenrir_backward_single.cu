// K7a: the single-solve backward filter of the fenrir likelihood.  From the
// seed at step N, for n = N-1 down to 0: predict through the backward chain,
//   m = A_n m + b_n,   P = A_n P A_n' + C_n,
// then the masked scalar observation update with (d_n, y_n, om_n, mask_n),
// summing the observations' log-densities.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _backward_kernel_global_mask.  Plain PyTorch twin:
// _fenrir_backward_single_plain in ops/fused_fenrir.py.
//
// Design.  K7b's step (fenrir_step.cuh) and its loop on one solve: the chain and
// the observation model are block-diagonal, so one thread per block carries
// that block's m, packed P and log-density sum through all N steps, reading
// the chain (A, b, C) in the JAX package's (N, NB, D) layout (no transposed
// copy) and the mask of each step at its global row, as the TPU kernel did
// across its chunks.  Each thread writes its block's sum; the wrapper adds
// the blocks in block order, as for K7b.  (The TPU kernel summed the blocks
// of each step first and then the steps; the order here is fixed, and the
// twin follows it.)
//
// What bounds it on the card.  NB threads (3 for Lorenz63): a dependency
// chain of ~200 float operations per step and block, so the kernel runs at
// that chain's latency, far above its byte bound (23 floats read per step
// and block, the chain's and the observation grid's, 1.1 MB at 4000 steps).
// The loads of kFenrirSingleUnroll steps are issued before they are used.
#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kFenrirSingleUnroll = 8;

template <int Q>
__global__ void fenrir_backward_single_kernel(int n_steps, int n_block,
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
  const int blk = threadIdx.x;
  if (blk >= n_block) return;
  const size_t c = blk;
  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = m_seed[c * Q + j];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = p_seed[c * NT + k];
  float ld = 0.0f;
  fenrir_recursion<Q, kFenrirSingleUnroll>(n_steps,
                                           SingleLayout{static_cast<size_t>(n_block)}, c,
                                           n_block, blk, A, b, C, d, y, om, mask, m, P, ld);
  ld_blocks[c] = ld;
}

}  // namespace rodeo

// Every pointer is device memory laid out as fenrir_backward_single
// (ops/fused_fenrir.py) documents; ld_blocks is (n_block,).  Returns a
// cudaError_t.
extern "C" int rodeo_fenrir_backward_single(int n_steps, int n_block,
                                            const void* A, const void* b,
                                            const void* C, const void* d,
                                            const void* y, const void* om,
                                            const void* mask,
                                            const void* m_seed,
                                            const void* p_seed,
                                            void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_block > 1024) return cudaErrorInvalidValue;
  fenrir_backward_single_kernel<3><<<1, n_block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_block, static_cast<const float*>(A),
      static_cast<const float*>(b), static_cast<const float*>(C),
      static_cast<const float*>(d), static_cast<const float*>(y),
      static_cast<const float*>(om), static_cast<const float*>(mask),
      static_cast<const float*>(m_seed), static_cast<const float*>(p_seed),
      static_cast<float*>(ld_blocks));
  return cudaGetLastError();
}
