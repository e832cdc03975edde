// K11b: the tangent twin of K7b.  Fenrir's backward filter over the
// augmented chain (A, b, C) that K11a emits, carrying the derivative of its
// state and log-density along each theta direction, and writing each
// block's log-density sum with its tangents, (NAUG, NB, B).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _fenrir_backward_kernel_batch_tan.  Plain PyTorch twin:
// _fenrir_backward_tan_plain in ops/fused_fenrir.py, which runs K7b's twin
// on Duals (ops/dual.py).
//
// What bounds it on the card.  It reads the augmented chain once, 72 floats
// per (step, block, lane) at NAUG = 4 (7.08 GB at 4000 steps x 3 blocks x
// 2048 lanes, 2.11 ms at 3.35 TB/s), and writes NAUG floats per column: a
// streaming kernel bound by device-memory bandwidth.
//
// Design.  A stream on stream_ring.cuh's ring: CTAs of kStreamCols = 32
// (block, lane) columns (6144 columns: 192 CTAs), n_tan consumer warps, one
// per theta direction, and a producer warp.  The producer fills a ring of
// kTanStages shared-memory stages of kTanSteps steps with the augmented
// chain's 18 NAUG rows of a step (TanRows) by cp.async, 16 bytes a copy
// where the rows are 16-byte aligned, else 4, so that the value rows cross
// device memory once per CTA and not once per direction.  The consumer
// thread of column t in warp dir carries m, the packed P and the block's
// log-density as Duals (dual.cuh) from step N-1 down to 0, reading the
// value rows and its direction's tangent rows of each step from shared
// memory, and runs K7b's step (fenrir_step.cuh), so its values are K7b's
// bitwise.  It skips the observation update at a step whose mask is 0, an
// exact identity there, as the twin does (on the likelihood fixture 21 of
// 4000 steps carry data); the branch is the same for every thread.  The
// observation grid is a constant shared by all lanes (zero tangent), read
// through the cache.  Each consumer thread stores its direction's tangent
// of ld, the thread of direction 0 also the value; the wrapper adds the
// blocks in block order, as for K7b.  The stream stages no output rows, so
// it runs the ring's two sides itself, without stream_stages' drain.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dual.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kTanSteps = 2;    // steps per stage
constexpr int kTanStages = 3;   // stages in the ring
constexpr int kMaxTan = 4;

// the rows a step reads: A (NAUG Q Q), b (NAUG Q), C (NAUG Tri<Q>::N), the
// values' rows of each operand first, then each direction's
template <int Q, int NTAN>
using TanRows = StreamRows<(1 + NTAN) * Q * Q, (1 + NTAN) * Q,
                           (1 + NTAN) * Tri<Q>::N>;

// dynamic shared memory of a CTA: the ring
template <int Q, int NTAN>
constexpr size_t tan_smem_bytes() {
  return sizeof(float) * kTanStages * kTanSteps * TanRows<Q, NTAN>::R *
         kStreamCols;
}

// Two CTAs an SM in the launch bounds: 192 CTAs need two on 60 of the 132
// SMs, and without them ptxas held the kernel to 64-80 registers and, at 2
// and 4 directions, spilled around its subroutine calls.
template <int Q, int NTAN, int V>
__global__ void __launch_bounds__((NTAN + 1) * kStreamCols, 2)
    fenrir_backward_tan_kernel(int n_steps, int n_block, int n_lane,
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
  using Rows = TanRows<Q, NTAN>;
  constexpr int NT = Tri<Q>::N, NAUG = 1 + NTAN;
  constexpr int S = kTanSteps, K = kTanStages;
  extern __shared__ __align__(16) float smem[];
  auto ring = reinterpret_cast<float (*)[S][Rows::R][kStreamCols]>(smem);
  const int n_col_i = n_block * n_lane;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  const int n_stage = (n_steps + S - 1) / S;

  if (threadIdx.x < NTAN * kStreamCols) {
    // column col0 + t, direction dir
    const int t = threadIdx.x % kStreamCols, dir = threadIdx.x / kStreamCols;
    const bool live = t < width;
    const int ci = static_cast<int>(col0) + (live ? t : 0);
    const size_t c = ci;
    const int blk = ci / n_lane;
    Dual m[Q], P[NT];
#pragma unroll
    for (int j = 0; j < Q; ++j)
      m[j] = Dual(m_seed[j * n_col + c], m_seed[((1 + dir) * Q + j) * n_col + c]);
#pragma unroll
    for (int k = 0; k < NT; ++k)
      P[k] = Dual(p_seed[k * n_col + c], p_seed[((1 + dir) * NT + k) * n_col + c]);
    Dual ld(0.0f);
    // the first row of b and of C in a step
    constexpr int rb = NAUG * Q * Q, rC = NAUG * (Q * Q + Q);
    ring_consume<NTAN, K>(n_stage, [&](int k, int slot) {
      if (!live) return;
      const float(&in)[S][Rows::R][kStreamCols] = ring[slot];
      const int top = n_steps - 1 - k * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        ChainRow<Dual, Q> row;
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int j = 0; j < Q; ++j)
            row.A[i][j] = Dual(in[s][i * Q + j][t],
                               in[s][(1 + dir) * Q * Q + i * Q + j][t]);
#pragma unroll
        for (int i = 0; i < Q; ++i)
          row.b[i] = Dual(in[s][rb + i][t], in[s][rb + (1 + dir) * Q + i][t]);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          row.C[i] = Dual(in[s][rC + i][t], in[s][rC + (1 + dir) * NT + i][t]);
        fenrir_step<Q>(top - s, n_block, blk, row, d, y, om, mask, m, P, ld);
      }
    });
    if (live) store_aug(ld_blocks, 0, 1, NAUG, 0, n_col, c, dir, ld);
    return;
  }
  // the producer warp
  const float* const ops[] = {A, b, C};
  const StageCopies<Rows, V> w(threadIdx.x % kStreamCols, n_col, col0, ops);
  ring_produce<NTAN, K>(
      n_stage,
      [&](int k, int slot) {
        fill_stage<Rows, V, S>(ring[slot], k, n_stage, n_steps, width, w);
      },
      [](int) {});
}

inline SplitGeometry tan_geometry(int n_col, int n_tan) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols),
          dim3((n_tan + 1) * kStreamCols)};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it.
template <int NTAN, int V>
cudaError_t allow_tan_smem() {
  return cudaFuncSetAttribute(fenrir_backward_tan_kernel<3, NTAN, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(tan_smem_bytes<3, NTAN>()));
}

template <int NTAN, int V>
cudaError_t launch_tan(int n_steps, int n_block, int n_lane, const float* A,
                       const float* b, const float* C, const float* d,
                       const float* y, const float* om, const float* mask,
                       const float* m_seed, const float* p_seed,
                       float* ld_blocks, cudaStream_t stream) {
  const cudaError_t err = allow_tan_smem<NTAN, V>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = tan_geometry(n_block * n_lane, NTAN);
  fenrir_backward_tan_kernel<3, NTAN, V>
      <<<geo.grid, geo.block, tan_smem_bytes<3, NTAN>(), stream>>>(
          n_steps, n_block, n_lane, A, b, C, d, y, om, mask, m_seed, p_seed,
          ld_blocks);
  return cudaGetLastError();
}

template <int NTAN>
cudaError_t tan_geometry_report(int n_col, bool vec, int* out) {
  const cudaError_t err =
      vec ? allow_tan_smem<NTAN, 4>() : allow_tan_smem<NTAN, 1>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = tan_geometry(n_col, NTAN);
  return vec ? report_geometry(fenrir_backward_tan_kernel<3, NTAN, 4>, geo,
                               out, tan_smem_bytes<3, NTAN>())
             : report_geometry(fenrir_backward_tan_kernel<3, NTAN, 1>, geo,
                               out, tan_smem_bytes<3, NTAN>());
}

}  // namespace rodeo

// n_tan tangent directions (1..4); every pointer is device memory laid out
// as fenrir_backward_batch_tan (ops/fused_fenrir.py) documents: the chain
// A, b, C (N, NAUG d, n_block, B), the seeds m_seed (NAUG q, n_block, B)
// and p_seed (NAUG n_tri, ..), the observation grid as for
// rodeo_fenrir_backward_batch; ld_blocks is (NAUG, n_block, B).  Rows go
// 16 bytes at a time where n_block x B is a multiple of 4 and A, b and C
// are 16-byte aligned, else 4 bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_tan(
    int n_steps, int n_block, int n_lane, int n_tan, const void* A,
    const void* b, const void* C, const void* d, const void* y,
    const void* om, const void* mask, const void* m_seed, const void* p_seed,
    void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1 || n_tan < 1 ||
      n_tan > kMaxTan)
    return cudaErrorInvalidValue;
  const bool vec = stream_aligned(n_block * n_lane, A, b, C);
  const auto* Ap = static_cast<const float*>(A);
  const auto* bp = static_cast<const float*>(b);
  const auto* Cp = static_cast<const float*>(C);
  const auto* dp = static_cast<const float*>(d);
  const auto* yp = static_cast<const float*>(y);
  const auto* omp = static_cast<const float*>(om);
  const auto* mp = static_cast<const float*>(mask);
  const auto* msp = static_cast<const float*>(m_seed);
  const auto* psp = static_cast<const float*>(p_seed);
  auto* ldp = static_cast<float*>(ld_blocks);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto ntan) {
    constexpr int NTAN = decltype(ntan)::value;
    return vec ? launch_tan<NTAN, 4>(n_steps, n_block, n_lane, Ap, bp, Cp, dp,
                                     yp, omp, mp, msp, psp, ldp, s)
               : launch_tan<NTAN, 1>(n_steps, n_block, n_lane, Ap, bp, Cp, dp,
                                     yp, omp, mp, msp, psp, ldp, s);
  };
  switch (n_tan) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 3: return launch(std::integral_constant<int, 3>());
    default: return launch(std::integral_constant<int, 4>());
  }
}

// The launch rodeo_fenrir_backward_batch_tan makes for n_block x n_lane
// columns and n_tan directions with aligned operands on the current device,
// as report_geometry's nine ints (block_step.cuh; the shared memory is the
// ring's, dynamic), then the ring's stages and the steps a stage holds, in
// out.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_tan_geometry(int n_block,
                                                        int n_lane, int n_tan,
                                                        void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1 || n_tan < 1 || n_tan > kMaxTan)
    return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const int n_col = n_block * n_lane;
  const bool vec = n_col % 4 == 0;
  cudaError_t err;
  switch (n_tan) {
    case 1: err = tan_geometry_report<1>(n_col, vec, o); break;
    case 2: err = tan_geometry_report<2>(n_col, vec, o); break;
    case 3: err = tan_geometry_report<3>(n_col, vec, o); break;
    default: err = tan_geometry_report<4>(n_col, vec, o); break;
  }
  o[9] = kTanStages;
  o[10] = kTanSteps;
  return err;
}
