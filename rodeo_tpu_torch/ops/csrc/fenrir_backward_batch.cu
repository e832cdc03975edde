// K7b: lane-batched backward filter of the fenrir likelihood.  From the seed
// at step N, for n = N-1 down to 0: predict through the backward chain,
//   m = A_n m + b_n,   P = A_n P A_n' + C_n,
// then the masked scalar observation update with (d_n, y_n, om_n, mask_n),
// summing the observations' log-densities.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _fenrir_backward_kernel_batch.  Plain PyTorch twin: _fenrir_backward_plain
// in ops/fused_fenrir.py, with skip_unobserved.  Instantiated at q = 3, 4
// and 5 (the figures below are q = 3's).
//
// What bounds it on the card.  Each step reads 18 floats per (block, lane)
// column (A 9, b 3, C 6) for ~100 float operations, and writes nothing: a
// streaming kernel bound by device-memory bandwidth (18 x 4 B x N x NB x B,
// 1.77 GB at 4000 steps x 3 blocks x 2048 lanes, 0.53 ms at 3.35 TB/s).
// One thread per column loading its rows through L1 a few steps ahead, in
// CTAs of 64 (96 CTAs for 6144 columns), keeps too few bytes in flight for
// that: 21 % of the bound on the card (PERF.md).
//
// Design.  A stream on stream_ring.cuh's ring, as its tangent twin K11b
// (fenrir_backward_batch_tan.cuh) is: CTAs of kStreamCols = 32 (block, lane)
// columns (192 CTAs at 3 x 2048), one consumer warp and a producer warp.
// The producer fills a ring of kFenrirStages shared-memory stages of
// kFenrirSteps steps with the chain's 18 rows of a step (A, b, C) by
// cp.async, 16 bytes a copy where the rows are 16-byte aligned, else 4
// (StageCopies).  The consumer thread of column t carries m, the packed P
// and its block's log-density sum in registers from step N-1 down to 0,
// reading each step's row from shared memory, and runs fenrir_step
// (fenrir_step.cuh), the step K11b runs.  It skips the observation
// update at a step whose mask is 0, an exact identity there, as the twin
// with skip_unobserved and K11b do (on the likelihood fixture 21 of 4000
// steps carry data); the branch is the same for every thread.  The
// observation grid (N, .., NB) is shared by all lanes and comes through
// the cache.  Each consumer thread writes its block's sum to (NB, B); the
// wrapper adds the blocks in block order.  The stream stages no output
// rows, so it runs the ring's two sides itself, as K11b does.  The TPU
// kernel's chunk grid and lane fold are gone.  A step's rows grow to 30 at
// q = 4 and 45 at q = 5, and the ring with them (15, 31 and 46 KB of
// static shared memory at q = 3, 4 and 5), within the 48 KB a static
// allocation may take.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "chain_step.cuh"
#include "dispatch.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

// the ring: the fastest of 2-4 stages of 2-8 steps on the card (PERF.md)
constexpr int kFenrirSteps = 4;    // steps per stage
constexpr int kFenrirStages = 2;   // stages in the ring

// the rows a step reads: A (Q Q), b (Q), C (Tri<Q>::N)
template <int Q>
using FenrirRows = StreamRows<Q * Q, Q, Tri<Q>::N>;

template <int Q, int V>
__global__ void __launch_bounds__(2 * kStreamCols)
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
  using Rows = FenrirRows<Q>;
  constexpr int NT = Tri<Q>::N;
  constexpr int S = kFenrirSteps, K = kFenrirStages;
  __shared__ __align__(16) float ring[K][S][Rows::R][kStreamCols];
  const int n_col_i = n_block * n_lane;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  const int n_stage = (n_steps + S - 1) / S;

  if (threadIdx.x < kStreamCols) {
    // the consumer thread of column col0 + t
    const int t = threadIdx.x;
    const bool live = t < width;
    const size_t c = col0 + (live ? t : 0);
    const int blk = static_cast<int>(c) / n_lane;
    float m[Q], P[NT];
#pragma unroll
    for (int j = 0; j < Q; ++j) m[j] = m_seed[j * n_col + c];
#pragma unroll
    for (int k = 0; k < NT; ++k) P[k] = p_seed[k * n_col + c];
    float ld = 0.0f;
    // the first row of b and of C in a step
    constexpr int rb = Q * Q, rC = Q * Q + Q;
    ring_consume<1, K>(n_stage, [&](int k, int slot) {
      if (!live) return;
      const float(&in)[S][Rows::R][kStreamCols] = ring[slot];
      const int top = n_steps - 1 - k * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        ChainRow<float, Q> row;
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int j = 0; j < Q; ++j) row.A[i][j] = in[s][i * Q + j][t];
#pragma unroll
        for (int i = 0; i < Q; ++i) row.b[i] = in[s][rb + i][t];
#pragma unroll
        for (int i = 0; i < NT; ++i) row.C[i] = in[s][rC + i][t];
        fenrir_step<Q>(top - s, n_block, blk, row, d, y, om, mask, m, P, ld);
      }
    });
    if (live) ld_blocks[c] = ld;
    return;
  }
  // the producer warp
  const float* const ops[] = {A, b, C};
  const StageCopies<Rows, V> w(threadIdx.x % kStreamCols, n_col, col0, ops);
  ring_produce<1, K>(
      n_stage,
      [&](int k, int slot) {
        fill_stage<Rows, V, S>(ring[slot], k, n_stage, n_steps, width, w);
      },
      [](int) {});
}

inline SplitGeometry fenrir_geometry(int n_col) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols), stream_cta()};
}

template <int Q, int V>
cudaError_t launch_fenrir(int n_steps, int n_block, int n_lane,
                          const float* A, const float* b, const float* C,
                          const float* d, const float* y, const float* om,
                          const float* mask, const float* m_seed,
                          const float* p_seed, float* ld_blocks,
                          cudaStream_t stream) {
  const SplitGeometry geo = fenrir_geometry(n_block * n_lane);
  fenrir_backward_kernel<Q, V><<<geo.grid, geo.block, 0, stream>>>(
      n_steps, n_block, n_lane, A, b, C, d, y, om, mask, m_seed, p_seed,
      ld_blocks);
  return cudaGetLastError();
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5 (any other returns
// cudaErrorInvalidValue).  Every pointer is device memory laid out as
// fenrir_backward_batch (ops/fused_fenrir.py) documents; ld_blocks is
// (n_block, B).  Rows go 16 bytes at a time where n_block x B is a
// multiple of 4 and A, b and C are 16-byte aligned, else 4 bytes at a
// time.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch(int q, int n_steps, int n_block,
                                           int n_lane, const void* A,
                                           const void* b, const void* C,
                                           const void* d, const void* y,
                                           const void* om, const void* mask,
                                           const void* m_seed,
                                           const void* p_seed,
                                           void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const bool vec = stream_aligned(n_block * n_lane, A, b, C);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    auto* launch = vec ? &launch_fenrir<Q, 4> : &launch_fenrir<Q, 1>;
    return launch(n_steps, n_block, n_lane, static_cast<const float*>(A),
                  static_cast<const float*>(b), static_cast<const float*>(C),
                  static_cast<const float*>(d), static_cast<const float*>(y),
                  static_cast<const float*>(om),
                  static_cast<const float*>(mask),
                  static_cast<const float*>(m_seed),
                  static_cast<const float*>(p_seed),
                  static_cast<float*>(ld_blocks),
                  static_cast<cudaStream_t>(stream));
  });
}

// The launch rodeo_fenrir_backward_batch makes at q for n_block x n_lane
// columns with aligned operands on the current device, as report_geometry's
// nine ints (block_step.cuh), then the ring's stages and the steps a stage
// holds, in out.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_geometry(int q, int n_block,
                                                    int n_lane, void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const int n_col = n_block * n_lane;
  const SplitGeometry geo = fenrir_geometry(n_col);
  const cudaError_t err = with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return n_col % 4 == 0
               ? report_geometry(fenrir_backward_kernel<Q, 4>, geo, o)
               : report_geometry(fenrir_backward_kernel<Q, 1>, geo, o);
  });
  o[9] = kFenrirStages;
  o[10] = kFenrirSteps;
  return err;
}
