// K6: lane-batched reverse affine recursion of the posterior path draw,
//   x_n = c_n + G_n x_{n+1},
// from the terminal draw xN down to row 0; c_n already holds the offset and
// its Cholesky-correlated noise.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_sim.py:
// _sampler_kernel_batch.  Plain PyTorch twin: _sampler_batch_plain in
// ops/fused_sim.py.
//
// Design.  One thread per (block, lane) column carries x (Q floats) in
// registers through all T steps of one launch; the recursion is
// block-diagonal, so NB x B threads run independently.  Inputs and outputs
// are (T, d, NB, B) with lanes innermost, so a warp reads and writes 32
// neighbouring floats.  The TPU kernel's chunk grid and its front padding
// are gone: the loop runs over any T.
//
// What bounds it on the card.  Each step reads 12 floats (c 3, G 9) and
// writes 3 per column for 18 float operations: a pure streaming kernel,
// bound by device-memory bandwidth (15 x 4 B x T x NB x B, 3.7 GB at the
// main path's 10 000 steps x 3 blocks x 2048 lanes).  The loads of a step do
// not depend on the carry, so the loop issues the loads of kUnroll steps
// before it computes them, keeping kUnroll steps of loads in flight.
#include <cuda_runtime.h>

namespace rodeo {

constexpr int kSamplerThreads = 64;
constexpr int kSamplerUnroll = 8;

template <int Q>
struct SamplerRow {
  float c[Q];
  float G[Q][Q];
};

template <int Q>
__device__ __forceinline__ void load_sampler_row(int n, size_t n_col,
                                                 size_t col,
                                                 const float* __restrict__ c,
                                                 const float* __restrict__ G,
                                                 SamplerRow<Q>& row) {
#pragma unroll
  for (int i = 0; i < Q; ++i)
    row.c[i] = __ldg(c + (static_cast<size_t>(n) * Q + i) * n_col + col);
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j)
      row.G[i][j] = __ldg(G + (static_cast<size_t>(n) * Q * Q + i * Q + j) * n_col + col);
}

template <int Q>
__device__ __forceinline__ void sampler_step(int n, size_t n_col, size_t col,
                                             const SamplerRow<Q>& row,
                                             float (&x)[Q],
                                             float* __restrict__ xs) {
  float out[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = row.c[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.G[i][j] * x[j];
    out[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    x[i] = out[i];
    xs[(static_cast<size_t>(n) * Q + i) * n_col + col] = x[i];
  }
}

template <int Q>
__global__ void __launch_bounds__(kSamplerThreads)
    sampler_batch_kernel(int n_steps, int n_col_i,
                         const float* __restrict__ c,
                         const float* __restrict__ G,
                         const float* __restrict__ xN,
                         float* __restrict__ xs) {
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= n_col_i) return;
  const size_t col = ci, n_col = n_col_i;
  float x[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) x[j] = xN[j * n_col + col];

  int n = n_steps - 1;
  for (; n >= kSamplerUnroll - 1; n -= kSamplerUnroll) {
    SamplerRow<Q> rows[kSamplerUnroll];
#pragma unroll
    for (int u = 0; u < kSamplerUnroll; ++u) load_sampler_row<Q>(n - u, n_col, col, c, G, rows[u]);
#pragma unroll
    for (int u = 0; u < kSamplerUnroll; ++u) sampler_step<Q>(n - u, n_col, col, rows[u], x, xs);
  }
  for (; n >= 0; --n) {
    SamplerRow<Q> row;
    load_sampler_row<Q>(n, n_col, col, c, G, row);
    sampler_step<Q>(n, n_col, col, row, x, xs);
  }
}

}  // namespace rodeo

// n_col = n_block * B; every pointer is device memory laid out as
// sampler_batch (ops/fused_sim.py) documents.  Returns a cudaError_t.
extern "C" int rodeo_sampler_batch(int n_steps, int n_col, const void* c,
                                   const void* G, const void* xN, void* xs,
                                   void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_col < 1) return cudaErrorInvalidValue;
  const dim3 block(kSamplerThreads);
  const dim3 grid((n_col + kSamplerThreads - 1) / kSamplerThreads);
  sampler_batch_kernel<3><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_col, static_cast<const float*>(c),
      static_cast<const float*>(G), static_cast<const float*>(xN),
      static_cast<float*>(xs));
  return cudaGetLastError();
}
