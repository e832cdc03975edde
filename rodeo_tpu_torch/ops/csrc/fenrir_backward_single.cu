// K7a: the single-solve backward filter of the fenrir likelihood.  From the
// seed at step N, for n = N-1 down to 0: predict through the backward chain,
//   m = A_n m + b_n,   P = A_n P A_n' + C_n,
// then the masked scalar observation update with (d_n, y_n, om_n, mask_n),
// summing the observations' log-densities.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _backward_kernel_global_mask.  Plain PyTorch twin:
// _fenrir_backward_single_plain in ops/fused_fenrir.py.  Instantiated at
// q = 3, 4 and 5 (the figures below are q = 3's).
//
// What bounds it on the card.  The carry's dependent chain, step after step:
// its bytes (19 floats per block and step, the chain's and the mask, 0.9 MB
// at 4000 steps) are nothing.  The chain row is 7 dependent float operations
// (P's A P product: a multiply, two adds; its (A P) A' product: a multiply,
// two adds; + C), and a step with data adds the update's 19 (P D', S, 1 / S,
// the gain, I - K D, the Joseph product, + K K' om).  On the likelihood
// fixture 21 of 4000 steps carry data.  One thread per block walking the
// steps, loading its chain rows 8 steps at a time and the observation grid
// at every step, and running the update at every step, took ~400 ns a step.
//
// Design.  A slab stream on stream_ring.cuh's ring, as K4's
// (smoother_single.cu): a CTA of a consumer warp and a producer warp holds
// up to kFenrirCtaBlocks neighbouring blocks (blocks are independent, so
// more blocks take more CTAs).  A stage is fenrir_single_rows<Q>() steps; the
// producer copies its rows of A, b and C, in the single layout (N, NB, D)
// one contiguous slab per operand where the CTA holds every block, and the
// stage's mask, by cp.async into a ring of kFenrirSingleStages slots
// (SlabRuns: 16 bytes a copy where the slabs are 16-byte aligned, else 4).
// Stages are counted from row 0, the top one holding the steps left over.
// The consumer thread of each block carries its m, packed P and log-density
// sum in registers and runs chain_step on its row in shared memory, so that
// its stream of instructions is the recursion alone.  At a step whose mask
// is 0 the observation update and its term are an exact identity (D = 0, y
// = 0, om = 1: K = 0, I - K D = I, S = 1) and are skipped, as K7b and K11b
// skip them; the mask comes with the stage, so the branch, the same for
// every thread, waits on no load.  At a step with data the thread runs
// fenrir_update (fenrir_step.cuh's update, masked_obs_update in the twin's
// order), reading d, y and om through the cache.  Each thread writes its
// block's sum; the wrapper adds the blocks in block order.  (The TPU kernel
// summed the blocks of each step first and then the steps; the order here
// is fixed, and the twin follows it.)  The ring has no output rows to
// drain.  K4's layout, each block's step spread over six lanes that trade
// the carry through shared memory, took 32 % longer here (PERF.md): without
// output rows to stage, the trade is pure latency on the chain.  Of rings of
// 2 to 8 stages of 16 to 256 steps, kFenrirSingleStages x 256
// was the fastest on the card, larger stages paying fewer hand-overs between
// the warps (PERF.md).  Four blocks a CTA keep both models (3 and 2 blocks)
// in one CTA of 16-byte copies and the ring inside the card's shared memory
// (150 KB at 4 blocks).  A step's rows grow to 30 floats a block at q = 4
// and 45 at q = 5, so there a stage holds 128 steps (fenrir_single_rows):
// 121 and 181 KB at 4 blocks, 31 and 46 KB at Chkrebtii's one.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "chain_step.cuh"
#include "dispatch.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kFenrirSingleStages = 2;   // stages in the ring

// steps per stage: 256 at q = 3, 128 at q = 4 and 5, whose rows would take
// the ring past the card's shared memory at 256
template <int Q>
__host__ __device__ constexpr int fenrir_single_rows() {
  return Q == 3 ? 256 : 128;
}

// the blocks a CTA (a consumer thread each) holds
constexpr int kFenrirCtaBlocks = 4;

// floats of a ring slot for a CTA of w blocks: A, b, C of the stage's rows,
// then its mask
template <int Q>
__host__ __device__ constexpr int fenrir_slot_floats(int w) {
  return fenrir_single_rows<Q>() * (w * (Q * Q + Q + Tri<Q>::N) + 1);
}

// dynamic shared memory of a CTA: the ring
template <int Q>
constexpr size_t fenrir_single_smem_bytes(int n_block) {
  const int w = n_block < kFenrirCtaBlocks ? n_block : kFenrirCtaBlocks;
  return sizeof(float) * kFenrirSingleStages * fenrir_slot_floats<Q>(w);
}

template <int Q, int V>
__global__ void __launch_bounds__(2 * 32)
    fenrir_backward_single_kernel(int n_steps, int n_block,
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
  constexpr int S = fenrir_single_rows<Q>(), K = kFenrirSingleStages;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * kFenrirCtaBlocks;
  const int width = min(kFenrirCtaBlocks, n_block - b0);
  // a slot: A, b, C of the stage's rows, [(n - lo) width + blk] D + e each,
  // then the mask of its rows
  const int nA = S * width * Q * Q, nb = S * width * Q, nC = S * width * NT;
  const int n_slot = fenrir_slot_floats<Q>(width);
  float* const ring = smem;
  const int n_stage = (n_steps + S - 1) / S;
  // stage k holds rows hi(k) down to lo(k), stage 0 the rows left over
  auto lo_of = [&](int k) { return (n_stage - 1 - k) * S; };
  auto hi_of = [&](int k) { return min(n_steps - 1, lo_of(k) + S - 1); };

  if (threadIdx.x < 32) {
    // the consumer thread of block b0 + t
    const int t = threadIdx.x;
    const bool live = t < width;
    const int blk = b0 + (live ? t : 0);
    float m[Q], P[NT];
#pragma unroll
    for (int j = 0; j < Q; ++j) m[j] = m_seed[blk * Q + j];
#pragma unroll
    for (int k = 0; k < NT; ++k) P[k] = p_seed[blk * NT + k];
    float ld = 0.0f;
    ring_consume<1, K>(n_stage, [&](int k, int slot) {
      if (!live) return;
      const float* in = ring + slot * n_slot;
      const int lo = lo_of(k), top = hi_of(k) - lo;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        const int r = top - s;
        const int at = r * width + t;  // the row's block
        ChainRow<float, Q> row;
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int j = 0; j < Q; ++j) row.A[i][j] = in[at * Q * Q + i * Q + j];
#pragma unroll
        for (int i = 0; i < Q; ++i) row.b[i] = in[nA + at * Q + i];
#pragma unroll
        for (int c = 0; c < NT; ++c) row.C[c] = in[nA + nb + at * NT + c];
        chain_step<Q>(row, m, P);
        const float mk = in[nA + nb + nC + r];
        if (mk != 0.0f)
          fenrir_update<Q>(lo + r, n_block, blk, mk, d, y, om, m, P, ld);
      }
    });
    if (live) ld_blocks[blk] = ld;
    return;
  }
  // the producer warp
  const int lane = threadIdx.x % 32;
  const SlabRuns<V> slab{n_block, b0, width};
  const SlabRuns<V> steps{1, 0, 1};  // the mask, one float a step
  ring_produce<1, K>(
      n_stage,
      [&](int k, int slot) {
        if (k < n_stage) {
          float* in = ring + slot * n_slot;
          const int lo = lo_of(k), hi = hi_of(k);
          slab.each(Q * Q, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in, A, s, at, v);
          });
          slab.each(Q, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in + nA, b, s, at, v);
          });
          slab.each(NT, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in + nA + nb, C, s, at, v);
          });
          steps.each(1, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in + nA + nb + nC, mask, s, at, v);
          });
        }
        commit_async();
      },
      [](int) {});
}

inline SplitGeometry fenrir_single_geometry(int n_block) {
  return {dim3((n_block + kFenrirCtaBlocks - 1) / kFenrirCtaBlocks),
          dim3(2 * 32)};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it.
template <int Q, int V>
cudaError_t allow_fenrir_single_smem(int n_block) {
  return cudaFuncSetAttribute(
      fenrir_backward_single_kernel<Q, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fenrir_single_smem_bytes<Q>(n_block)));
}

template <int Q, int V>
cudaError_t launch_fenrir_single(int n_steps, int n_block, const float* A,
                                 const float* b, const float* C,
                                 const float* d, const float* y,
                                 const float* om, const float* mask,
                                 const float* m_seed, const float* p_seed,
                                 float* ld_blocks, cudaStream_t stream) {
  const cudaError_t err = allow_fenrir_single_smem<Q, V>(n_block);
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = fenrir_single_geometry(n_block);
  fenrir_backward_single_kernel<Q, V>
      <<<geo.grid, geo.block, fenrir_single_smem_bytes<Q>(n_block), stream>>>(
          n_steps, n_block, A, b, C, d, y, om, mask, m_seed, p_seed,
          ld_blocks);
  return cudaGetLastError();
}

template <int Q, int V>
cudaError_t fenrir_single_geometry_report(int n_block, int* out) {
  const cudaError_t err = allow_fenrir_single_smem<Q, V>(n_block);
  if (err != cudaSuccess) return err;
  out[10] = fenrir_single_rows<Q>();
  return report_geometry(fenrir_backward_single_kernel<Q, V>,
                         fenrir_single_geometry(n_block), out,
                         fenrir_single_smem_bytes<Q>(n_block));
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5 (any other returns
// cudaErrorInvalidValue).  Every pointer is device memory laid out as
// fenrir_backward_single (ops/fused_fenrir.py) documents; ld_blocks is
// (n_block,).  Any n_block >= 1 runs, kFenrirCtaBlocks blocks a CTA.
// Stages move 16 bytes at a time where one CTA holds every block and A, b,
// C and mask are 16-byte aligned, else 4 bytes at a time.  Returns a
// cudaError_t.
extern "C" int rodeo_fenrir_backward_single(int q, int n_steps, int n_block,
                                            const void* A, const void* b,
                                            const void* C, const void* d,
                                            const void* y, const void* om,
                                            const void* mask,
                                            const void* m_seed,
                                            const void* p_seed,
                                            void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1) return cudaErrorInvalidValue;
  const bool vec =
      n_block <= kFenrirCtaBlocks && aligned16(A, b, C, mask);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    auto* launch =
        vec ? &launch_fenrir_single<Q, 4> : &launch_fenrir_single<Q, 1>;
    return launch(n_steps, n_block, static_cast<const float*>(A),
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

// The launch rodeo_fenrir_backward_single makes at q for n_block blocks
// with aligned operands on the current device, as report_geometry's nine
// ints (block_step.cuh; the shared memory is the ring's, dynamic), then the
// ring's stages, the steps a stage holds and the blocks a CTA holds, in
// out.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_single_geometry(int q, int n_block,
                                                     void* out) {
  using namespace rodeo;
  if (n_block < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const bool vec = n_block <= kFenrirCtaBlocks;
  const cudaError_t err = with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return vec ? fenrir_single_geometry_report<Q, 4>(n_block, o)
               : fenrir_single_geometry_report<Q, 1>(n_block, o);
  });
  o[9] = kFenrirSingleStages;
  o[11] = kFenrirCtaBlocks;
  return err;
}
