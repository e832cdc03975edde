// K11b: the tangent twin of K7b.  Fenrir's backward filter over the
// augmented chain (A, b, C) that K11a emits, carrying the derivative of its
// state and log-density along each theta direction, and writing each
// block's log-density sum with its tangents, (NAUG, NB, B).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _fenrir_backward_kernel_batch_tan, at q = 3, 4 and 5 and 1 to kMaxTan = 7
// tangent directions (the most parameters of a model: Hes1's 7).  Plain
// PyTorch twin: _fenrir_backward_tan_plain in ops/fused_fenrir.py, which
// runs K7b's twin on Duals (ops/dual.py).  The C entry points are
// fenrir_backward_batch_tan.cu's; the instances of each q are compiled in a
// translation unit of their own, fenrir_tan_instances_q*.cu, which nvcc
// builds in parallel.
//
// What bounds it on the card.  It reads the augmented chain once, 72 floats
// per (step, block, lane) at NAUG = 4 (7.08 GB at 4000 steps x 3 blocks x
// 2048 lanes, 2.11 ms at 3.35 TB/s), and writes NAUG floats per column: a
// streaming kernel bound by device-memory bandwidth.
//
// Design.  A stream on stream_ring.cuh's ring: CTAs of kStreamCols = 32
// (block, lane) columns (6144 columns: 192 CTAs), n_tan consumer warps, one
// per theta direction, and a producer warp.  The producer fills a ring of
// kTanStages shared-memory stages of tan_steps<Q, NTAN>() steps with the
// augmented chain's NAUG (Q Q + Q + Tri<Q>::N) rows of a step (TanRows; 18
// NAUG at q = 3) by cp.async, 16 bytes a copy where the rows are 16-byte
// aligned, else 4, so that the value rows cross device memory once per CTA
// and not once per direction.  A stage holds 2 steps where 3 stages of 2
// fit in the 227 KB of shared memory a CTA may take (108 KB at q = 3 and 7
// directions, 180 KB at q = 4), else 1 (q = 5 at 6 or 7 directions: 118
// and 135 KB); the ring is dynamic shared memory, sized from (Q, NTAN).  The consumer
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
#pragma once

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dual.cuh"
#include "fenrir_step.cuh"
#include "fenrir_tan_instances.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kTanStages = 3;   // stages in the ring
// the shared memory a CTA may take on the card (the opt-in maximum), and
// the most each of two CTAs on one SM may take (half an SM's 228 KB, less
// the 1 KB the card keeps for each CTA)
constexpr size_t kTanSmemMax = 227 * 1024;
constexpr size_t kSmPerCta2 = (228 * 1024) / 2 - 1024;

// the rows a step reads: A (NAUG Q Q), b (NAUG Q), C (NAUG Tri<Q>::N), the
// values' rows of each operand first, then each direction's
template <int Q, int NTAN>
using TanRows = StreamRows<(1 + NTAN) * Q * Q, (1 + NTAN) * Q,
                           (1 + NTAN) * Tri<Q>::N>;

// the bytes of a ring of kTanStages stages of S steps
template <int Q, int NTAN>
__host__ __device__ constexpr size_t tan_ring_bytes(int S) {
  return sizeof(float) * kTanStages * S * TanRows<Q, NTAN>::R * kStreamCols;
}

// steps per stage: 2 where that ring fits a CTA's shared memory, else 1
template <int Q, int NTAN>
__host__ __device__ constexpr int tan_steps() {
  return tan_ring_bytes<Q, NTAN>(2) <= kTanSmemMax ? 2 : 1;
}

// dynamic shared memory of a CTA: the ring
template <int Q, int NTAN>
__host__ __device__ constexpr size_t tan_smem_bytes() {
  return tan_ring_bytes<Q, NTAN>(tan_steps<Q, NTAN>());
}

// Two CTAs an SM in the launch bounds where two rings fit an SM: 192 CTAs
// need two on 60 of the 132 SMs, and without them ptxas held the kernel to
// 64-80 registers and, at 2 and 4 directions, spilled around its
// subroutine calls; one where they do not (q = 4 from 5 directions, q = 5
// from 3), so that ptxas may spend more registers on each thread.
template <int Q, int NTAN>
__host__ __device__ constexpr int tan_min_ctas() {
  return tan_smem_bytes<Q, NTAN>() <= kSmPerCta2 ? 2 : 1;
}

template <int Q, int NTAN, int V>
__global__ void __launch_bounds__((NTAN + 1) * kStreamCols,
                                  tan_min_ctas<Q, NTAN>())
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
  constexpr int S = tan_steps<Q, NTAN>(), K = kTanStages;
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
template <int Q, int NTAN, int V>
cudaError_t allow_tan_smem() {
  return cudaFuncSetAttribute(fenrir_backward_tan_kernel<Q, NTAN, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(tan_smem_bytes<Q, NTAN>()));
}

template <int Q, int NTAN, int V>
cudaError_t launch_tan(const FenrirTanArgs& a, cudaStream_t stream) {
  const cudaError_t err = allow_tan_smem<Q, NTAN, V>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = tan_geometry(a.n_block * a.n_lane, NTAN);
  fenrir_backward_tan_kernel<Q, NTAN, V>
      <<<geo.grid, geo.block, tan_smem_bytes<Q, NTAN>(), stream>>>(
          a.n_steps, a.n_block, a.n_lane, a.A, a.b, a.C, a.d, a.y, a.om,
          a.mask, a.m_seed, a.p_seed, a.ld_blocks);
  return cudaGetLastError();
}

template <int Q, int NTAN, int V>
cudaError_t report_tan(int n_col, int* out) {
  const cudaError_t err = allow_tan_smem<Q, NTAN, V>();
  if (err != cudaSuccess) return err;
  return report_geometry(fenrir_backward_tan_kernel<Q, NTAN, V>,
                         tan_geometry(n_col, NTAN), out,
                         tan_smem_bytes<Q, NTAN>());
}

// K11b's instances at Q, one for each number of directions 1 .. kMaxTan
// (with_value) and row alignment; a translation unit
// fenrir_tan_instances_q*.cu instantiates them.
template <int Q>
cudaError_t FenrirTanInstances<Q>::launch(int n_tan, bool vec,
                                          const FenrirTanArgs& a,
                                          cudaStream_t stream) {
  return with_n_tan(n_tan, [&](auto nt) {
    constexpr int NTAN = decltype(nt)::value;
    return vec ? launch_tan<Q, NTAN, 4>(a, stream)
               : launch_tan<Q, NTAN, 1>(a, stream);
  });
}

template <int Q>
cudaError_t FenrirTanInstances<Q>::geometry(int n_tan, int n_col, bool vec,
                                            int* out) {
  return with_n_tan(n_tan, [&](auto nt) {
    constexpr int NTAN = decltype(nt)::value;
    out[9] = kTanStages;
    out[10] = tan_steps<Q, NTAN>();
    return vec ? report_tan<Q, NTAN, 4>(n_col, out)
               : report_tan<Q, NTAN, 1>(n_col, out);
  });
}

}  // namespace rodeo
