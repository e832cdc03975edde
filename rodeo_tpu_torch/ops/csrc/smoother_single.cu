// K4: the single-solve reverse affine recursion of the smoother,
//   m_n = g_n + G_n m_{n+1},   P_n = L_n + G_n P_{n+1} G_n',
// from the terminal (mN, pN) down to row 0, over (g, G, L) in the JAX
// package's (T, NB, q | q*q | n_tri) layout.  fused_smoother runs it over
// every step, fused_smoother_composed over the boundary steps of its
// k-step groups.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _smoother_recursion_kernel.  Plain PyTorch twin: _smoother_single_plain
// in ops/fused_kalman.py.
//
// Design.  The smoother's step and loop (chain_step.cuh) on the
// single-solve layout: one thread per block carries m and the packed P in
// registers through all T rows of one launch, reading and writing (T, NB,
// D) with the entries of a block innermost, so the host makes no
// transposed copy.  The TPU kernel's
// reverse-streamed chunk grid is a loop inside the thread.
//
// What bounds it on the card.  NB threads (3 for Lorenz63) on one SM: the
// recursion is a dependency chain of ~60 float operations per row, and the
// kernel runs at the latency of that chain, far above its byte bound (27
// floats per block and row, 3.2 MB at 10 000 rows, 1 us at 3.35 TB/s).  The
// loads of kSingleUnroll rows are issued before they are used, so memory
// latency is paid once per kSingleUnroll rows.  The composed smoother is the
// remedy the JAX package already has: it runs this kernel over N/k rows.
#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kSingleUnroll = 8;

template <int Q>
__global__ void smoother_single_kernel(int n_steps, int n_block,
                                       const float* __restrict__ g,
                                       const float* __restrict__ G,
                                       const float* __restrict__ L,
                                       const float* __restrict__ mN,
                                       const float* __restrict__ pN,
                                       float* __restrict__ ms,
                                       float* __restrict__ ps) {
  constexpr int NT = Tri<Q>::N;
  const int blk = threadIdx.x;
  if (blk >= n_block) return;
  const size_t c = blk;
  const SingleLayout lay{static_cast<size_t>(n_block)};
  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = mN[c * Q + j];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = pN[c * NT + k];
  smoother_recursion<Q, kSingleUnroll>(
      n_steps, lay, c, g, G, L, m, P, [&](int n, const float (&mv)[Q], const float (&Pv)[NT]) {
#pragma unroll
        for (int i = 0; i < Q; ++i) ms[lay(n, i, c, Q)] = mv[i];
#pragma unroll
        for (int k = 0; k < NT; ++k) ps[lay(n, k, c, NT)] = Pv[k];
      });
}

}  // namespace rodeo

// Every pointer is device memory laid out as smoother_recursion
// (ops/fused_kalman.py) documents.  Returns a cudaError_t.
extern "C" int rodeo_smoother_single(int n_steps, int n_block, const void* g,
                                     const void* G, const void* L,
                                     const void* mN, const void* pN, void* ms,
                                     void* ps, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_block > 1024) return cudaErrorInvalidValue;
  smoother_single_kernel<3><<<1, n_block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_block, static_cast<const float*>(g),
      static_cast<const float*>(G), static_cast<const float*>(L),
      static_cast<const float*>(mN), static_cast<const float*>(pN),
      static_cast<float*>(ms), static_cast<float*>(ps));
  return cudaGetLastError();
}
