// K4: the single-solve reverse affine recursion of the smoother,
//   m_n = g_n + G_n m_{n+1},   P_n = L_n + G_n P_{n+1} G_n',
// from the terminal (mN, pN) down to row 0, over (g, G, L) in the JAX
// package's (T, NB, q | q*q | n_tri) layout.  fused_smoother runs it over
// every step, fused_smoother_composed over the boundary steps of its
// k-step groups.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _smoother_recursion_kernel.  Plain PyTorch twin: _smoother_single_plain
// in ops/fused_kalman.py.  Instantiated at q = 3, 4 and 5 (a block's row
// over Tri<Q>::N = 6, 10 and 15 lanes: 5, 3 and 2 blocks a CTA; the figures
// below are q = 3's).
//
// What bounds it on the card.  The carry's dependent chain, row after row:
// its bytes (27 floats per block and row, 3.2 MB at 10 000 rows, 1 us at
// 3.35 TB/s) are nothing.  The chain (m: a multiply and three adds; P: the
// A P products and two adds, then the (A P) A' products and two adds, then
// + C) is ~28 cycles a row, 0.14 ms at 9999 rows.  One thread per block
// carrying m and the packed P, loading its row (27 scalar loads and stores
// with their addresses) and computing it (~100 float operations), took
// 232 ns a row.
//
// Design.  A stream on stream_ring.cuh's ring, fed by slabs: a CTA of a
// consumer warp and a producer warp holds up to kCtaBlocks neighbouring
// blocks (blocks are independent in the smoother, so more blocks take more
// CTAs).  A stage is kSingleRows rows; the producer copies its rows of g,
// G and L, in the single layout one contiguous slab per operand where the
// CTA holds every block, by cp.async into a ring of kSingleStages slots
// (SlabRuns: 16 bytes a copy where the slab is 16-byte aligned, else 4),
// and stores the rows of ms and ps that the consumer staged as contiguous
// runs.  Stages are counted from row 0, so that every full stage starts on
// a multiple of kSingleRows rows; the first stage consumed, the top one,
// holds the rows left over.  The consumer warp's stream of instructions is
// the recursion alone: shared loads, the arithmetic, shared stores.  Each
// block's row is spread over Tri<Q>::N lanes, one packed entry of P each
// (sym_quadform's T = A P row and then its entry C + A T', in the same
// order), the lanes of a diagonal entry also computing a mean entry; the
// warp holds 32 / Tri<Q>::N blocks.  The staged output row is the block's
// new carry: after __syncwarp every lane of the block reads its m and P
// back from it for the next row (8.6 % faster on the card than gathering
// them by __shfl_sync, and one thread per block carrying the whole row
// was 18 % slower than the lanes).  Of stages of 8 to 128 rows and rings
// of 3 to 8 stages, 4 stages of 64 rows were the fastest (PERF.md); a
// stage's hand-over between the warps costs ~0.8 us, which smaller stages
// pay more often.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "chain_step.cuh"
#include "dispatch.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kSingleRows = 64;    // rows per stage
constexpr int kSingleStages = 4;   // stages in the ring

// the blocks a CTA (its one consumer warp, Tri<Q>::N lanes a block) holds
template <int Q>
constexpr int kCtaBlocks = 32 / Tri<Q>::N;

// floats of a ring slot (a stage of G, g, L) and of a staged output stage
// (ms, ps) for a CTA of w blocks
template <int Q>
__host__ __device__ constexpr int slot_floats(int w) {
  return kSingleRows * w * (Q * Q + Q + Tri<Q>::N);
}
template <int Q>
__host__ __device__ constexpr int out_floats(int w) {
  return kSingleRows * w * (Q + Tri<Q>::N);
}

// dynamic shared memory of a CTA: the ring, then two staged output stages
template <int Q>
constexpr size_t single_smem_bytes(int n_block) {
  const int w = n_block < kCtaBlocks<Q> ? n_block : kCtaBlocks<Q>;
  return sizeof(float) *
         (kSingleStages * slot_floats<Q>(w) + 2 * out_floats<Q>(w));
}

// The consumer lane's block and packed entry of P (i, l), i <= l.
template <int Q>
struct EntryLane {
  int blk, p, i, l;
  bool live;
  __device__ EntryLane(int lane, int width)
      : blk(lane / Tri<Q>::N), p(lane % Tri<Q>::N), i(0), l(0),
        live(lane / Tri<Q>::N < width) {
    int idx = 0;
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
      for (int b = a; b < Q; ++b, ++idx)
        if (idx == p) {
          i = a;
          l = b;
        }
    if (!live) blk = 0;  // a lane past the CTA's blocks shadows block 0
  }
};

template <int Q, int V>
__global__ void __launch_bounds__(2 * 32)
    smoother_single_kernel(int n_steps, int n_block,
                           const float* __restrict__ g,
                           const float* __restrict__ G,
                           const float* __restrict__ L,
                           const float* __restrict__ mN,
                           const float* __restrict__ pN,
                           float* __restrict__ ms, float* __restrict__ ps) {
  constexpr int NT = Tri<Q>::N;
  constexpr int S = kSingleRows, K = kSingleStages;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * kCtaBlocks<Q>;
  const int width = min(kCtaBlocks<Q>, n_block - b0);
  // a slot: G, g, L of the stage's rows, [(n - lo) width + b] D + e each;
  // a staged output stage: ms, ps alike
  const int nG = S * width * Q * Q, ng = S * width * Q;
  const int n_slot = slot_floats<Q>(width), nm = S * width * Q;
  float* const ring = smem;
  float* const out = smem + K * n_slot;
  const int n_stage = (n_steps + S - 1) / S;
  // stage k holds rows hi(k) down to lo(k), stage 0 the rows left over
  auto lo_of = [&](int k) { return (n_stage - 1 - k) * S; };
  auto hi_of = [&](int k) { return min(n_steps - 1, lo_of(k) + S - 1); };

  if (threadIdx.x < 32) {
    float m[Q], P[NT];
    // lane (blk, p): entry p = (i, l) of block blk's P, the carry of the
    // whole block in every lane of it
    const EntryLane<Q> e(threadIdx.x, width);
#pragma unroll
    for (int j = 0; j < Q; ++j) m[j] = mN[(b0 + e.blk) * Q + j];
#pragma unroll
    for (int k = 0; k < NT; ++k) P[k] = pN[(b0 + e.blk) * NT + k];
    ring_consume<1, K>(n_stage, [&](int k, int slot) {
      const float* in = ring + slot * n_slot;
      float* o = out + (k & 1) * out_floats<Q>(width);
      const int top = hi_of(k) - lo_of(k);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s > top) break;
        const int at = (top - s) * width + e.blk;  // the row's block
        // the lane's operands: rows i and l of G, entry p of L, entry i
        // of g
        float ai[Q], al[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          ai[j] = in[at * Q * Q + e.i * Q + j];
          al[j] = in[at * Q * Q + e.l * Q + j];
        }
        // sym_quadform's T[i][.] = A[i][.] P, then entry (i, l)
        float T[Q];
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          float acc = ai[0] * P[Tri<Q>::at(0, c)];
#pragma unroll
          for (int j = 1; j < Q; ++j) acc = acc + ai[j] * P[Tri<Q>::at(j, c)];
          T[c] = acc;
        }
        float quad = al[0] * T[0];
#pragma unroll
        for (int c = 1; c < Q; ++c) quad = quad + al[c] * T[c];
        const float pn = in[nG + ng + at * NT + e.p] + quad;
        // chain_step's mean entry i
        float mi = in[nG + at * Q + e.i];
#pragma unroll
        for (int j = 0; j < Q; ++j) mi = mi + ai[j] * m[j];
        // the row's staged outputs are the block's new carry: each lane
        // reads all of it back once the warp has written it
        if (e.live) {
          o[nm + at * NT + e.p] = pn;
          if (e.i == e.l) o[at * Q + e.i] = mi;
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < NT; ++c) P[c] = o[nm + at * NT + c];
#pragma unroll
        for (int j = 0; j < Q; ++j) m[j] = o[at * Q + j];
      }
    });
    return;
  }
  // the producer warp
  const int lane = threadIdx.x % 32;
  const SlabRuns<V> slab{n_block, b0, width};
  ring_produce<1, K>(
      n_stage,
      [&](int k, int slot) {
        if (k < n_stage) {
          float* in = ring + slot * n_slot;
          const int lo = lo_of(k), hi = hi_of(k);
          slab.each(Q * Q, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in, G, s, at, v);
          });
          slab.each(Q, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in + nG, g, s, at, v);
          });
          slab.each(NT, lo, hi, lane, [&](int s, long long at, int v) {
            copy_chunk(in + nG + ng, L, s, at, v);
          });
        }
        commit_async();
      },
      [&](int k) {  // the rows of ms and ps that stage k staged
        const float* o = out + (k & 1) * out_floats<Q>(width);
        const int lo = lo_of(k), hi = hi_of(k);
        slab.each(Q, lo, hi, lane, [&](int s, long long at, int v) {
          store_chunk(ms, o, s, at, v);
        });
        slab.each(NT, lo, hi, lane, [&](int s, long long at, int v) {
          store_chunk(ps, o + nm, s, at, v);
        });
      });
}

template <int Q>
SplitGeometry single_geometry(int n_block) {
  return {dim3((n_block + kCtaBlocks<Q> - 1) / kCtaBlocks<Q>), dim3(2 * 32)};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it.
template <int Q, int V>
cudaError_t allow_single_smem(int n_block) {
  return cudaFuncSetAttribute(smoother_single_kernel<Q, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(single_smem_bytes<Q>(n_block)));
}

template <int Q, int V>
cudaError_t launch_single(int n_steps, int n_block, const float* g,
                          const float* G, const float* L, const float* mN,
                          const float* pN, float* ms, float* ps,
                          cudaStream_t stream) {
  const cudaError_t err = allow_single_smem<Q, V>(n_block);
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = single_geometry<Q>(n_block);
  smoother_single_kernel<Q, V>
      <<<geo.grid, geo.block, single_smem_bytes<Q>(n_block), stream>>>(
          n_steps, n_block, g, G, L, mN, pN, ms, ps);
  return cudaGetLastError();
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5 (any other returns
// cudaErrorInvalidValue).  Every pointer is device memory laid out as
// smoother_recursion (ops/fused_kalman.py) documents.  Stages move 16 bytes
// at a time where one CTA holds every block and g, G, L, ms and ps are
// 16-byte aligned, else 4 bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_smoother_single(int q, int n_steps, int n_block,
                                     const void* g, const void* G,
                                     const void* L, const void* mN,
                                     const void* pN, void* ms, void* ps,
                                     void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1) return cudaErrorInvalidValue;
  const auto* gp = static_cast<const float*>(g);
  const auto* Gp = static_cast<const float*>(G);
  const auto* Lp = static_cast<const float*>(L);
  const auto* mNp = static_cast<const float*>(mN);
  const auto* pNp = static_cast<const float*>(pN);
  auto* msp = static_cast<float*>(ms);
  auto* psp = static_cast<float*>(ps);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(g, G, L, ms, ps);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return n_block <= kCtaBlocks<Q> && aligned
               ? launch_single<Q, 4>(n_steps, n_block, gp, Gp, Lp, mNp, pNp,
                                     msp, psp, s)
               : launch_single<Q, 1>(n_steps, n_block, gp, Gp, Lp, mNp, pNp,
                                     msp, psp, s);
  });
}

// The launch rodeo_smoother_single makes at q for n_block blocks with
// aligned operands on the current device, as report_geometry's nine ints
// (block_step.cuh; the shared memory is the ring's and the staged rows',
// dynamic), then the ring's stages, the rows a stage holds, the blocks a
// CTA holds and the lanes of a block's row, in out.  Returns a cudaError_t.
extern "C" int rodeo_smoother_single_geometry(int q, int n_block, void* out) {
  using namespace rodeo;
  if (n_block < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    const bool vec = n_block <= kCtaBlocks<Q>;
    cudaError_t err = vec ? allow_single_smem<Q, 4>(n_block)
                          : allow_single_smem<Q, 1>(n_block);
    if (err == cudaSuccess)
      err = vec ? report_geometry(smoother_single_kernel<Q, 4>,
                                  single_geometry<Q>(n_block), o,
                                  single_smem_bytes<Q>(n_block))
                : report_geometry(smoother_single_kernel<Q, 1>,
                                  single_geometry<Q>(n_block), o,
                                  single_smem_bytes<Q>(n_block));
    o[9] = kSingleStages;
    o[10] = kSingleRows;
    o[11] = kCtaBlocks<Q>;
    o[12] = Tri<Q>::N;
    return err;
  });
}
