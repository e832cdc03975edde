// K6: lane-batched reverse affine recursion of the posterior path draw,
//   x_n = c_n + G_n x_{n+1},
// from the terminal draw xN down to row 0; c_n already holds the offset and
// its Cholesky-correlated noise.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_sim.py:
// _sampler_kernel_batch.  Plain PyTorch twin: _sampler_batch_plain in
// ops/fused_sim.py.
//
// What bounds it on the card.  Each step reads 12 floats (c 3, G 9) and
// writes 3 per column for 18 float operations: a pure stream, bound by
// device-memory bandwidth (15 x 4 B x T x NB x B, 3.69 GB at the main
// path's 9999 steps x 3 blocks x 2048 lanes, 1.10 ms at 3.35 TB/s).  The
// recursion is about 4 dependent float operations a step, ~0.1 ms over
// 10 000 steps, so the time axis needs no other formulation (a scan would
// change the bits); what the card needs is bytes kept in flight.  By
// Little's law, 3.35 TB/s at ~0.8 us of loaded latency asks for ~2.7 MB in
// flight, ~20 KB on each of the 132 SMs.
//
// Design.  The recursion is block-diagonal, so the n_col = NB x B (block,
// lane) columns run independently; inputs and outputs are (T, d, NB, B),
// columns innermost.  A CTA owns kSamplerCols = 32 neighbouring columns
// (6144 columns: 192 CTAs, every SM with one or two), one consumer thread
// per column carrying x (Q floats) in registers from step T-1 down to 0.
// Its loads go through a ring of kSamplerStages = 6 shared-memory stages of
// kSamplerSteps = 4 steps each: one step of the CTA is 12 runs of 32
// floats (128 B each), so a stage is 6 KB, and the CTA refills the stage
// it has just consumed while it works on the next, keeping 5 stages (30 KB)
// of cp.async loads in flight ahead of the consumer: at least 30 KB on
// every SM, ~5.9 MB on the card.  Each thread copies the same rows of
// every step, so their offsets are computed once (StageCopies) and a copy
// costs an add and a select: with the offsets recomputed per copy the
// CTA's one warp spent more time on addresses than the card on the bytes.
// A stage's 3 x 4 output rows are staged in shared memory and leave as
// coalesced 16-byte stores.  Where the rows are not 16-byte aligned (n_col
// not a multiple of 4, or an operand's address) the same pipeline copies
// and stores 4 bytes at a time; the last CTA masks the columns past n_col,
// and the last stage the steps before row 0, so any n_steps >= 1 and n_col
// >= 1 run.  The arithmetic is the twin's, sum for sum.  Of 4 to 7 stages
// of 4 steps and 3 of 8, 6 of 4 was the fastest on the card (PERF.md).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_step.cuh"

namespace rodeo {

constexpr int kSamplerCols = 32;    // columns per CTA, a consumer thread each
constexpr int kSamplerSteps = 4;    // steps per stage
constexpr int kSamplerStages = 6;   // stages in the ring

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           std::integral_constant<int, 16>) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           std::integral_constant<int, 4>) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of the copies of a stage.  A copy moves V floats, so a
// row of kSamplerCols floats is kSamplerCols / V copies and the CTA's
// threads take V rows of a step at a time: thread tx copies chunk
// tx % (kSamplerCols / V) of rows r_j = tx / (kSamplerCols / V) + j V,
// j < R / V, of every step.  Row r of step n is row n Q + r of c for r < Q,
// else row n Q Q + r - Q of G; the offsets of the thread's rows from their
// step's first row of c or G are fixed, so a copy costs an add and a
// select.
template <int Q, int V>
struct StageCopies {
  static constexpr int R = Q + Q * Q;        // rows a step reads
  static constexpr int kChunks = kSamplerCols / V;
  static constexpr int kRows = R / V;        // rows of a step a thread copies
  static_assert(R % V == 0 && kSamplerCols % V == 0, "V must divide both");
  int col;                // the thread's chunk: first column, from the CTA's
  int row0;               // the thread's first row of a step
  bool in_c[kRows];
  size_t row_off[kRows];

  __device__ StageCopies(int tx, size_t n_col)
      : col(tx % kChunks * V), row0(tx / kChunks) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = row0 + j * V;
      in_c[j] = r < Q;
      row_off[j] = (r < Q ? r : r - Q) * n_col;
    }
  }
};

// Issue the copies of stage k (steps top, top - 1, .., down to row 0 at
// most, top = n_steps - 1 - k S) into ring slot `slot`, and commit them as
// one group; past the last stage, commit an empty group, so that the count
// of groups stays the count of stages.
template <int Q, int V>
__device__ __forceinline__ void fill_stage(
    float (&slot)[kSamplerSteps][Q + Q * Q][kSamplerCols], int k, int n_stage,
    int n_steps, size_t n_col, size_t col0, int width,
    const StageCopies<Q, V>& w, const float* __restrict__ c,
    const float* __restrict__ G) {
  using Copies = StageCopies<Q, V>;
  if (k < n_stage && w.col < width) {
    const int top = n_steps - 1 - k * kSamplerSteps;
#pragma unroll
    for (int s = 0; s < kSamplerSteps; ++s) {
      if (s > top) break;  // before row 0
      const size_t n = top - s;
      const float* cs = c + n * Q * n_col + col0 + w.col;
      const float* Gs = G + n * Q * Q * n_col + col0 + w.col;
#pragma unroll
      for (int j = 0; j < Copies::kRows; ++j)
        copy_async(&slot[s][w.row0 + j * V][w.col],
                   (w.in_c[j] ? cs : Gs) + w.row_off[j],
                   std::integral_constant<int, 4 * V>());
    }
  }
  commit_async();
}

template <int Q, int V>
__global__ void __launch_bounds__(kSamplerCols)
    sampler_batch_kernel(int n_steps, int n_col_i,
                         const float* __restrict__ c,
                         const float* __restrict__ G,
                         const float* __restrict__ xN,
                         float* __restrict__ xs) {
  constexpr int R = Q + Q * Q;
  constexpr int S = kSamplerSteps, K = kSamplerStages;
  static_assert(S * Q % V == 0, "a stage's rows of xs go V at a time");
  __shared__ __align__(16) float ring[K][S][R][kSamplerCols];
  __shared__ __align__(16) float out[S][Q][kSamplerCols];
  const int tx = threadIdx.x;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kSamplerCols;
  const int width = min(kSamplerCols, n_col_i - static_cast<int>(col0));
  const int n_stage = (n_steps + S - 1) / S;
  const StageCopies<Q, V> w(tx, n_col);
  const bool live = tx < width;

  float x[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) x[j] = live ? xN[j * n_col + col0 + tx] : 0.0f;

#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    fill_stage<Q, V>(ring[k], k, n_stage, n_steps, n_col, col0, width, w, c,
                     G);
  for (int k = 0; k < n_stage; ++k) {
    // the slot of stage k - 1, consumed before the last barrier
    fill_stage<Q, V>(ring[(k + K - 1) % K], k + K - 1, n_stage, n_steps,
                     n_col, col0, width, w, c, G);
    wait_async<K - 1>();  // this thread's copies of stage k have landed
    __syncthreads();      // and every thread's
    const int top = n_steps - 1 - k * S;
    const float(&in)[S][R][kSamplerCols] = ring[k % K];
    if (live) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        float nx[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          float acc = in[s][i][tx];
#pragma unroll
          for (int j = 0; j < Q; ++j)
            acc = acc + in[s][Q + i * Q + j][tx] * x[j];
          nx[i] = acc;
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          x[i] = nx[i];
          out[s][i][tx] = nx[i];
        }
      }
    }
    __syncthreads();
    // the stage's rows of xs, as its rows of c: row (top - s) Q + i for
    // step s and component i, the thread's chunk of rows w.row0 + p V
    if (w.col < width) {
#pragma unroll
      for (int p = 0; p < S * Q / V; ++p) {
        const int row = w.row0 + p * V;
        const int s = row / Q, i = row % Q;
        if (s > top) continue;
        float* dst = xs + (static_cast<size_t>(top - s) * Q + i) * n_col +
                     col0 + w.col;
        const float* src = &out[s][i][w.col];
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        else
          *dst = *src;
      }
    }
  }
}

inline SplitGeometry sampler_geometry(int n_col) {
  return {dim3((n_col + kSamplerCols - 1) / kSamplerCols), dim3(kSamplerCols)};
}

}  // namespace rodeo

// n_col = n_block * B; every pointer is device memory laid out as
// sampler_batch (ops/fused_sim.py) documents.  Rows go 16 bytes at a time
// where n_col is a multiple of 4 and c, G and xs are 16-byte aligned, else
// 4 bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_sampler_batch(int n_steps, int n_col, const void* c,
                                   const void* G, const void* xN, void* xs,
                                   void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_col < 1) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec = n_col % 4 == 0 && aligned(c) && aligned(G) && aligned(xs);
  const auto* cp = static_cast<const float*>(c);
  const auto* Gp = static_cast<const float*>(G);
  const auto* xNp = static_cast<const float*>(xN);
  auto* xsp = static_cast<float*>(xs);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const SplitGeometry g = sampler_geometry(n_col);
    sampler_batch_kernel<3, 4><<<g.grid, g.block, 0, s>>>(n_steps, n_col, cp,
                                                          Gp, xNp, xsp);
  } else {
    const SplitGeometry g = sampler_geometry(n_col);
    sampler_batch_kernel<3, 1><<<g.grid, g.block, 0, s>>>(n_steps, n_col, cp,
                                                          Gp, xNp, xsp);
  }
  return cudaGetLastError();
}

// The launch rodeo_sampler_batch makes for n_col columns with aligned
// operands on the current device, as report_geometry's nine ints
// (block_step.cuh), then the ring's stages and the steps a stage holds, in
// out.  Returns a cudaError_t.
extern "C" int rodeo_sampler_batch_geometry(int n_col, void* out) {
  using namespace rodeo;
  if (n_col < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const cudaError_t err =
      n_col % 4 == 0
          ? report_geometry(sampler_batch_kernel<3, 4>, sampler_geometry(n_col), o)
          : report_geometry(sampler_batch_kernel<3, 1>, sampler_geometry(n_col), o);
  o[9] = kSamplerStages;
  o[10] = kSamplerSteps;
  return err;
}
