// K2r: the lane-batched reverse affine recursion of the smoother,
//   m_n = g_n + G_n m_{n+1},   P_n = L_n + G_n P_{n+1} G_n',
// writing the public rows of the solve, already scaled to original
// coordinates: mean (N+1, NB, q, B) and packed covariance (N+1, NB, n_tri,
// B), rows 0 .. N.
//
// Replaces the TPU kernels rodeo_tpu/ops/pallas_kalman.py:
// _smoother_kernel_batch (the bare recursion, whose rows the JAX package
// assembles in XLA) and _smoother_kernel_batch_rows (the recursion writing
// the rows, at fold = 1: the port never folds lanes).  Plain PyTorch twin:
// _smoother_batch_rows_plain in ops/fused_kalman.py.  Instantiated at q = 3,
// 4 and 5 (the figures below are q = 3's).
//
// What bounds it on the card.  Device-memory bandwidth: 18 floats read (G
// 9, g 3, L 6) and 9 written per step and column, plus the boundary rows
// (6.6 GB at 10 000 steps x 3 blocks x 2048 lanes, 1.98 ms at 3.35 TB/s),
// against ~110 float operations a step on the column's carry.
//
// Design.  stream_ring.cuh's stream, K6's: CTAs of kStreamCols = 32
// neighbouring (block, lane) columns (6144 columns: 192 CTAs), one consumer
// thread per column carrying m (Q floats) and the packed P (Tri<Q>::N
// floats) in registers through all rows of one launch, with chain_step.cuh's
// step, and a producer warp beside it.  The gains (T, d, NB, B) that K1
// emits reach the consumer through a ring of kRowsStages shared-memory
// stages of kRowsSteps steps filled by the producer's cp.async: a step of
// the CTA is 18 runs of 128 B (2.3 KB), so the ring and the staged rows
// need dynamic shared memory above 48 KB.  Each step's 9 output rows (mean
// 3, packed covariance 6), each multiplied by its scale (t_vec for the
// mean, t_i t_j for the covariance, float32 products as the twin forms
// them), are staged in shared memory and leave, stored by the producer, as
// coalesced 16-byte stores at (r, block, d, lane); 4-byte copies and stores
// where n_lane is not a multiple of 4 or an operand is not 16-byte
// aligned.  The boundary rows ride the recursion as
// synthetic elements built in registers, not in device memory: first a
// trailing (G = 0, g = mN, L = pN), which emits row N and seeds the carry
// with the last filtered state exactly, and last a leading (G = 0, g = m0, L
// = 0), which emits row 0, the exact initial state with zero covariance;
// the consumer threads store those two rows themselves.  The TPU kernel's
// identity front-padding was there for its grid's divisibility and is gone.
// With the copies, their addresses and the stores in the consumer's own
// warp, K2r ran at 44 % of its bound whatever the ring's depth; a producer
// warp took it to 53 %, and its addresses fixed per thread to 83 %.  Of
// the ring's shapes tried on the card (2 to 8 stages of 4 steps, 2 to 4 of
// 8, 2 of 12; PERF.md), 2 stages of 8 steps were the fastest: one stage of
// loads ahead of the consumer (18 KB a CTA) is enough, and deeper rings
// were slower.
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "chain_step.cuh"
#include "dispatch.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

constexpr int kRowsSteps = 8;    // steps per stage
constexpr int kRowsStages = 2;   // stages in the ring

// the rows a step reads: G (Q x Q), g (Q), L (Tri<Q>::N)
template <int Q>
using RowsRows = StreamRows<Q * Q, Q, Tri<Q>::N>;

// the rows a step writes: the mean's Q, then the packed covariance's
template <int Q>
constexpr int kRowsOut = Q + Tri<Q>::N;

// dynamic shared memory of a CTA: the ring, then two stages of staged
// output rows
template <int Q>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * kStreamCols * kRowsSteps *
         (kRowsStages * RowsRows<Q>::R + 2 * kRowsOut<Q>);
}

template <int Q, int V>
__global__ void __launch_bounds__(2 * kStreamCols)
    smoother_batch_rows_kernel(int n_steps, int n_block, int n_lane,
                               const float* __restrict__ g,
                               const float* __restrict__ G,
                               const float* __restrict__ L,
                               const float* __restrict__ mN,
                               const float* __restrict__ pN,
                               const float* __restrict__ m0,
                               const float* __restrict__ scales,
                               float* __restrict__ mean,
                               float* __restrict__ cov) {
  using Rows = RowsRows<Q>;
  constexpr int NT = Tri<Q>::N;
  constexpr int O = kRowsOut<Q>;
  constexpr int S = kRowsSteps, K = kRowsStages;
  extern __shared__ __align__(16) float smem[];
  auto ring = reinterpret_cast<float (*)[S][Rows::R][kStreamCols]>(smem);
  auto& out = *reinterpret_cast<float (*)[2][S][O][kStreamCols]>(
      smem + K * S * Rows::R * kStreamCols);
  const int tx = threadIdx.x;
  const int n_col_i = n_block * n_lane;
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  const bool live = tx < width;
  float sc[O];
#pragma unroll
  for (int k = 0; k < O; ++k) sc[k] = scales[k];
  // the (block, lane) of this thread's column and of its chunk of a row
  // (chunk_col), V neighbouring lanes of one block where V = 4 (n_lane is
  // then a multiple of 4)
  const size_t c = col0 + tx;
  const size_t blk = c / n_lane, lane = c % n_lane;
  const size_t chunk = col0 + chunk_col<V>(tx % kStreamCols);
  const size_t cblk = chunk / n_lane, clane = chunk % n_lane;
  // entry j of D of row r, block bk, lane ln, in (N+1, NB, D, B)
  auto at = [&](size_t r, int j, int D, size_t bk, size_t ln) {
    return ((r * n_block + bk) * D + j) * n_lane + ln;
  };
  auto store = [&](int r, const float (&mv)[Q], const float (&Pv)[NT]) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < Q; ++j) mean[at(r, j, Q, blk, lane)] = mv[j] * sc[j];
#pragma unroll
    for (int k = 0; k < NT; ++k)
      cov[at(r, k, NT, blk, lane)] = Pv[k] * sc[Q + k];
  };

  // the trailing synthetic element onto a zero carry: row N
  float m[Q], P[NT];
  ChainRow<float, Q> row;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    m[i] = 0.0f;
    row.b[i] = live ? mN[i * n_col + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < Q; ++j) row.A[i][j] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    P[k] = 0.0f;
    row.C[k] = live ? pN[k * n_col + c] : 0.0f;
  }
  chain_step<Q>(row, m, P);
  store(n_steps + 1, m, P);
  // the interior: gain row n emits public row n + 1
  const float* const ops[] = {G, g, L};
  stream_stages<Rows, O, V, S, K>(
      ring, out, n_steps, n_col, col0, width, ops,
      [&](int, const float (&v)[Rows::R], float (&o)[O][kStreamCols],
          int t) {
        ChainRow<float, Q> r;
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int j = 0; j < Q; ++j) r.A[i][j] = v[i * Q + j];
#pragma unroll
        for (int i = 0; i < Q; ++i) r.b[i] = v[Q * Q + i];
#pragma unroll
        for (int k = 0; k < NT; ++k) r.C[k] = v[Q * Q + Q + k];
        chain_step<Q>(r, m, P);
#pragma unroll
        for (int j = 0; j < Q; ++j) o[j][t] = m[j] * sc[j];
#pragma unroll
        for (int k = 0; k < NT; ++k) o[Q + k][t] = P[k] * sc[Q + k];
      },
      [&](int n, int j) {
        return j < Q ? mean + at(n + 1, j, Q, cblk, clane)
                     : cov + at(n + 1, j - Q, NT, cblk, clane);
      });
  // the leading synthetic element: row 0
#pragma unroll
  for (int i = 0; i < Q; ++i) row.b[i] = live ? m0[i * n_col + c] : 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) row.C[k] = 0.0f;
  chain_step<Q>(row, m, P);
  store(0, m, P);
}

inline SplitGeometry rows_geometry(int n_col) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols), stream_cta()};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it: 55 KB at q = 3, 90 KB at q = 4 and 133 KB at q = 5.
template <int Q, int V>
cudaError_t allow_rows_smem() {
  return cudaFuncSetAttribute(smoother_batch_rows_kernel<Q, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(rows_smem_bytes<Q>()));
}

template <int Q, int V>
cudaError_t launch_rows(int n_steps, int n_block, int n_lane, const float* g,
                        const float* G, const float* L, const float* mN,
                        const float* pN, const float* m0, const float* scales,
                        float* mean, float* cov, cudaStream_t stream) {
  const cudaError_t err = allow_rows_smem<Q, V>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = rows_geometry(n_block * n_lane);
  smoother_batch_rows_kernel<Q, V>
      <<<geo.grid, geo.block, rows_smem_bytes<Q>(), stream>>>(
          n_steps, n_block, n_lane, g, G, L, mN, pN, m0, scales, mean, cov);
  return cudaGetLastError();
}

template <int Q, int V>
cudaError_t rows_geometry_report(int n_col, int* out) {
  const cudaError_t err = allow_rows_smem<Q, V>();
  if (err != cudaSuccess) return err;
  return report_geometry(smoother_batch_rows_kernel<Q, V>,
                         rows_geometry(n_col), out, rows_smem_bytes<Q>());
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5 (any other returns
// cudaErrorInvalidValue); n_steps counts the interior rows (T = N - 1);
// scales holds the q mean and n_tri covariance scales.  Every pointer is
// device memory laid out as smoother_recursion_batch_rows
// (ops/fused_kalman.py) documents.  Rows go 16 bytes at a time where n_lane
// is a multiple of 4 and g, G, L, mean and cov are 16-byte aligned, else 4
// bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_smoother_batch_rows(int q, int n_steps, int n_block,
                                         int n_lane, const void* g,
                                         const void* G, const void* L,
                                         const void* mN, const void* pN,
                                         const void* m0, const void* scales,
                                         void* mean, void* cov, void* stream) {
  using namespace rodeo;
  if (n_steps < 0 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const bool vec = stream_aligned(n_lane, g, G, L, mean, cov);
  const auto* gp = static_cast<const float*>(g);
  const auto* Gp = static_cast<const float*>(G);
  const auto* Lp = static_cast<const float*>(L);
  const auto* mNp = static_cast<const float*>(mN);
  const auto* pNp = static_cast<const float*>(pN);
  const auto* m0p = static_cast<const float*>(m0);
  const auto* scp = static_cast<const float*>(scales);
  auto* meanp = static_cast<float*>(mean);
  auto* covp = static_cast<float*>(cov);
  auto s = static_cast<cudaStream_t>(stream);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return vec ? launch_rows<Q, 4>(n_steps, n_block, n_lane, gp, Gp, Lp, mNp,
                                   pNp, m0p, scp, meanp, covp, s)
               : launch_rows<Q, 1>(n_steps, n_block, n_lane, gp, Gp, Lp, mNp,
                                   pNp, m0p, scp, meanp, covp, s);
  });
}

// The launch rodeo_smoother_batch_rows makes at q for n_block x n_lane
// columns with aligned operands on the current device, as report_geometry's
// nine ints (block_step.cuh; the shared memory is the ring's and the staged
// rows', dynamic), then the ring's stages and the steps a stage holds, in
// out.  Returns a cudaError_t.
extern "C" int rodeo_smoother_batch_rows_geometry(int q, int n_block,
                                                  int n_lane, void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const int n_col = n_block * n_lane;
  const cudaError_t err = with_value<3, 4, 5>(q, [&](auto qq) {
    constexpr int Q = decltype(qq)::value;
    return n_lane % 4 == 0 ? rows_geometry_report<Q, 4>(n_col, o)
                           : rows_geometry_report<Q, 1>(n_col, o);
  });
  o[9] = kRowsStages;
  o[10] = kRowsSteps;
  return err;
}
