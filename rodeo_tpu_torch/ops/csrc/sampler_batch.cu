// K6: lane-batched reverse affine recursion of the posterior path draw,
//   x_n = c_n + G_n x_{n+1},
// from the terminal draw xN down to row 0; c_n already holds the offset and
// its Cholesky-correlated noise.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_sim.py:
// _sampler_kernel_batch.  Plain PyTorch twin: _sampler_batch_plain in
// ops/fused_sim.py.  Instantiated at q = 3, 4 and 5 (the figures below
// are q = 3's).
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
// Design.  stream_ring.cuh's stream, shared with K2r: CTAs of kStreamCols
// = 32 columns (6144 columns: 192 CTAs, every SM with one or two), one
// consumer thread per column carrying x (Q floats) in registers from step
// T-1 down to 0, fed by a producer warp through a ring of kSamplerStages =
// 6 shared-memory stages of kSamplerSteps = 4 steps each filled by
// cp.async (with the producer warp, K6 kept its one-warp time within 1 %).
// One step of the CTA is 12 runs of 32 floats (c 3, G 9; 128 B each), so a
// stage is 6 KB and the ring keeps 5 stages (30 KB) of loads in flight
// ahead of the consumer: at least 30 KB on every SM, ~5.9 MB on the card.
// A stage's 3 x 4 output rows are staged in shared memory (two stages'
// worth) and leave as coalesced 16-byte stores (4-byte copies and stores where n_col or an
// operand is not 16-byte aligned).  The arithmetic is the twin's, sum for
// sum.  Of 4 to 7 stages of 4 steps and 3 of 8, 6 of 4 was the fastest on
// the card, measured with one warp per CTA (PERF.md).  The ring and the
// staged rows are dynamic shared memory sized from Q, as K2r's are: 39 KB
// at q = 3, 64 KB at q = 4 (20 rows a step) and 95 KB at q = 5 (30 rows),
// which keeps two CTAs an SM there.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kSamplerSteps = 4;    // steps per stage
constexpr int kSamplerStages = 6;   // stages in the ring

// the rows a step reads: c (Q), then G (Q x Q)
template <int Q>
using SamplerRows = StreamRows<Q, Q * Q>;

// dynamic shared memory of a CTA: the ring, then two stages of staged
// output rows
template <int Q>
constexpr size_t sampler_smem_bytes() {
  return sizeof(float) * kStreamCols * kSamplerSteps *
         (kSamplerStages * SamplerRows<Q>::R + 2 * Q);
}

template <int Q, int V>
__global__ void __launch_bounds__(2 * kStreamCols)
    sampler_batch_kernel(int n_steps, int n_col_i,
                         const float* __restrict__ c,
                         const float* __restrict__ G,
                         const float* __restrict__ xN,
                         float* __restrict__ xs) {
  using Rows = SamplerRows<Q>;
  constexpr int S = kSamplerSteps, K = kSamplerStages;
  extern __shared__ __align__(16) float smem[];
  auto ring = reinterpret_cast<float (*)[S][Rows::R][kStreamCols]>(smem);
  auto& out = *reinterpret_cast<float (*)[2][S][Q][kStreamCols]>(
      smem + K * S * Rows::R * kStreamCols);
  const int tx = threadIdx.x;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  const size_t chunk = col0 + chunk_col<V>(tx % kStreamCols);

  float x[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    x[j] = tx < width ? xN[j * n_col + col0 + tx] : 0.0f;

  const float* const ops[] = {c, G};
  stream_stages<Rows, Q, V, S, K>(
      ring, out, n_steps, n_col, col0, width, ops,
      [&](int, const float (&v)[Rows::R], float (&o)[Q][kStreamCols],
          int t) {
        float nx[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          float acc = v[i];
#pragma unroll
          for (int j = 0; j < Q; ++j) acc = acc + v[Q + i * Q + j] * x[j];
          nx[i] = acc;
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          x[i] = nx[i];
          o[i][t] = nx[i];
        }
      },
      // row i of step n of xs, as its rows of c
      [&](int n, int i) {
        return xs + (static_cast<size_t>(n) * Q + i) * n_col + chunk;
      });
}

inline SplitGeometry sampler_geometry(int n_col) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols), stream_cta()};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it.
template <int Q, int V>
cudaError_t allow_sampler_smem() {
  return cudaFuncSetAttribute(sampler_batch_kernel<Q, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sampler_smem_bytes<Q>()));
}

template <int Q, int V>
cudaError_t launch_sampler(int n_steps, int n_col, const float* c,
                           const float* G, const float* xN, float* xs,
                           cudaStream_t stream) {
  const cudaError_t err = allow_sampler_smem<Q, V>();
  if (err != cudaSuccess) return err;
  const SplitGeometry g = sampler_geometry(n_col);
  sampler_batch_kernel<Q, V><<<g.grid, g.block, sampler_smem_bytes<Q>(),
                               stream>>>(n_steps, n_col, c, G, xN, xs);
  return cudaGetLastError();
}

template <int Q, int V>
cudaError_t sampler_geometry_report(int n_col, int* out) {
  const cudaError_t err = allow_sampler_smem<Q, V>();
  if (err != cudaSuccess) return err;
  return report_geometry(sampler_batch_kernel<Q, V>, sampler_geometry(n_col),
                         out, sampler_smem_bytes<Q>());
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5 (any other returns
// cudaErrorInvalidValue); n_col = n_block * B; every pointer is device
// memory laid out as sampler_batch (ops/fused_sim.py) documents.  Rows go
// 16 bytes at a time where n_col is a multiple of 4 and c, G and xs are
// 16-byte aligned, else 4 bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_sampler_batch(int q, int n_steps, int n_col,
                                   const void* c, const void* G,
                                   const void* xN, void* xs, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_col < 1) return cudaErrorInvalidValue;
  const bool vec = stream_aligned(n_col, c, G, xs);
  const auto* cp = static_cast<const float*>(c);
  const auto* Gp = static_cast<const float*>(G);
  const auto* xNp = static_cast<const float*>(xN);
  auto* xsp = static_cast<float*>(xs);
  auto s = static_cast<cudaStream_t>(stream);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return vec ? launch_sampler<Q, 4>(n_steps, n_col, cp, Gp, xNp, xsp, s)
               : launch_sampler<Q, 1>(n_steps, n_col, cp, Gp, xNp, xsp, s);
  });
}

// The launch rodeo_sampler_batch makes at q for n_col columns with aligned
// operands on the current device, as report_geometry's nine ints
// (block_step.cuh; the shared memory is the ring's and the staged rows',
// dynamic), then the ring's stages and the steps a stage holds, in out.
// Returns a cudaError_t.
extern "C" int rodeo_sampler_batch_geometry(int q, int n_col, void* out) {
  using namespace rodeo;
  if (n_col < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const cudaError_t err = with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return n_col % 4 == 0 ? sampler_geometry_report<Q, 4>(n_col, o)
                          : sampler_geometry_report<Q, 1>(n_col, o);
  });
  o[9] = kSamplerStages;
  o[10] = kSamplerSteps;
  return err;
}
