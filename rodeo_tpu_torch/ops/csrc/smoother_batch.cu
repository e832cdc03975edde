// K2: lane-batched reverse affine recursion of the smoother,
//   m_n = g_n + G_n m_{n+1},   P_n = L_n + G_n P_{n+1} G_n',
// from the terminal (mN, pN) down to row 0.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _smoother_kernel_batch.  Plain PyTorch twin: _smoother_batch_plain in
// ops/fused_kalman.py.
//
// Design.  One thread per (block, lane) column carries m (Q floats) and the
// packed P (Tri<Q>::N floats) in registers through all T steps of a single
// launch.  The inputs and outputs are (T, d, n_block, B) with lanes
// innermost; a thread's column index c runs over the flattened
// (n_block, B), so a warp reads and writes 32 neighbouring floats.
//
// What bounds it on the card.  Each step reads 18 and writes 9 floats per
// thread (at q = 3) for ~60 float operations: a pure streaming kernel,
// bound by device-memory bandwidth (27 x 4 B x T x n_block x B, 6.6 GB at
// the benchmark's 10k steps x 3 blocks x 2048 lanes).  The loads of a step
// do not depend on the carry, so the loop issues the loads of kUnroll
// steps before it computes them, which keeps kUnroll steps of loads in
// flight per thread instead of one.
#include <cuda_runtime.h>

#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kSmootherThreads = 64;
constexpr int kUnroll = 8;

template <int Q>
struct SmootherRow {
  float G[Q][Q];
  float g[Q];
  float L[Tri<Q>::N];
};

template <int Q>
__device__ __forceinline__ void load_row(int n, size_t n_col, size_t c,
                                         const float* __restrict__ g,
                                         const float* __restrict__ G,
                                         const float* __restrict__ L,
                                         SmootherRow<Q>& row) {
  constexpr int NT = Tri<Q>::N;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j)
      row.G[i][j] = __ldg(G + (static_cast<size_t>(n) * Q * Q + i * Q + j) * n_col + c);
#pragma unroll
  for (int i = 0; i < Q; ++i)
    row.g[i] = __ldg(g + (static_cast<size_t>(n) * Q + i) * n_col + c);
#pragma unroll
  for (int k = 0; k < NT; ++k)
    row.L[k] = __ldg(L + (static_cast<size_t>(n) * NT + k) * n_col + c);
}

template <int Q>
__device__ __forceinline__ void step(int n, size_t n_col, size_t c,
                                     const SmootherRow<Q>& row, float (&m)[Q],
                                     float (&P)[Tri<Q>::N],
                                     float* __restrict__ ms,
                                     float* __restrict__ ps) {
  constexpr int NT = Tri<Q>::N;
  float m_out[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = row.g[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.G[i][j] * m[j];
    m_out[i] = acc;
  }
  float gpg[NT];
  sym_quadform<Q>(row.G, P, gpg);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = row.L[k] + gpg[k];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    m[i] = m_out[i];
    ms[(static_cast<size_t>(n) * Q + i) * n_col + c] = m[i];
  }
#pragma unroll
  for (int k = 0; k < NT; ++k)
    ps[(static_cast<size_t>(n) * NT + k) * n_col + c] = P[k];
}

template <int Q>
__global__ void __launch_bounds__(kSmootherThreads)
    smoother_batch_kernel(int n_steps, int n_col_i,
                          const float* __restrict__ g,
                          const float* __restrict__ G,
                          const float* __restrict__ L,
                          const float* __restrict__ mN,
                          const float* __restrict__ pN,
                          float* __restrict__ ms, float* __restrict__ ps) {
  constexpr int NT = Tri<Q>::N;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = mN[j * n_col + c];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = pN[k * n_col + c];

  int n = n_steps - 1;
  for (; n >= kUnroll - 1; n -= kUnroll) {
    SmootherRow<Q> rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row<Q>(n - u, n_col, c, g, G, L, rows[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step<Q>(n - u, n_col, c, rows[u], m, P, ms, ps);
  }
  for (; n >= 0; --n) {
    SmootherRow<Q> row;
    load_row<Q>(n, n_col, c, g, G, L, row);
    step<Q>(n, n_col, c, row, m, P, ms, ps);
  }
}

}  // namespace rodeo

// n_col = n_block * B; every pointer is device memory laid out as
// smoother_recursion_batch documents.  Returns a cudaError_t.
extern "C" int rodeo_smoother_batch(int n_steps, int n_col, const void* g,
                                    const void* G, const void* L,
                                    const void* mN, const void* pN, void* ms,
                                    void* ps, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_col < 1) return cudaErrorInvalidValue;
  const dim3 block(kSmootherThreads);
  const dim3 grid((n_col + kSmootherThreads - 1) / kSmootherThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  smoother_batch_kernel<3><<<grid, block, 0, s>>>(
      n_steps, n_col, static_cast<const float*>(g),
      static_cast<const float*>(G), static_cast<const float*>(L),
      static_cast<const float*>(mN), static_cast<const float*>(pN),
      static_cast<float*>(ms), static_cast<float*>(ps));
  return cudaGetLastError();
}
