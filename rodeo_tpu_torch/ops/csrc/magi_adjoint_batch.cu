// K10b: exact reverse adjoint of the MAGI filter's log-density (K10a,
// magi_batch.cu) in the scaled path.  The filter's covariances never see the
// data, so the adjoint is a linear backward recursion over the coefficients
// K10a streamed: with lam the gradient in the state, zero after step N, for
// n = N..1,
//   v = S^{-1} z,   t_a = sum_{i >= ACT} G[i][a] lam[i],
//   dL/dx_n = lam[:ACT] + t - v,   lam <- Q' [v - t ; lam[ACT:]],
// and the gradient in the seed state is the final lam.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_magi.py:
// _magi_adjoint_kernel_batch.  Plain PyTorch twin: _magi_adjoint_batch_plain
// in ops/fused_magi.py.
//
// What bounds it on the card.  Each step reads ACT + Tri<ACT>::N +
// (Q - ACT) ACT floats per column (7 at ACT = 2: z 2, S^{-1} 3, G 2) and
// writes ACT, for ~30 float operations on a dependent chain of 5 (t, v - t
// and Q' u): 688.1 MB read and 196.6 MB written at 4000 steps x 3 blocks x
// 2048 lanes, a bound of 0.264 ms at 3.35 TB/s.  A stream bound by
// device-memory bandwidth, as K6 and K2r are, if enough loads are in
// flight: one warp loading a few steps ahead of its arithmetic waits out a
// device-memory round trip every few steps.
//
// Design.  A reverse column stream on stream_ring.cuh's ring
// (stream_stages), as K6 and K2r run: CTAs of kStreamCols (block, lane)
// columns (the blocks are independent; 192 CTAs at 3 x 2048), one consumer
// warp and a producer warp.  The producer fills a ring of kAdjStages
// shared-memory stages of kAdjSteps steps with each step's rows of z (ACT),
// packed S^{-1} (Tri<ACT>::N) and, when ACT < Q, G ((Q - ACT) ACT): 4, 7
// and 9 rows at n_active 1, 2 and 3.  It reads the streams (N, d, NB, B),
// lanes innermost, as K10a writes them, by cp.async, 16 bytes a copy where
// every row is 16-byte aligned, else 4 (StageCopies), the last step's stage
// first, the last stage holding the steps left over.  The consumer thread of
// column t carries lam (Q floats) in registers from step N-1 down to 0, runs
// adjoint_step in the twin's order on the stage's rows and stages its gx
// rows in shared memory; the producer stores them, 16 bytes at a time where
// aligned.  After the last stage the consumer writes lam0, coalesced across
// the warp.  When Q == ACT there is no G stream and t is zero.  The
// transposed constant transition is built from the host constant once per
// thread.  The ring and the staged rows are dynamic shared memory (76.5 KB
// at ACT = 2, two CTAs an SM).  Of rings of 2-8 stages of 4-24 steps, 3 of
// 24 was the fastest on the card, 0.357 ms, 74 % of the bound: larger
// stages pay fewer hand-overs, until a CTA's ring no longer lets two share
// an SM (8 of 16, 0.72 ms); CTAs of 16 columns were 7 % slower (PERF.md).
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "kalman_cols.cuh"
#include "stream_ring.cuh"

namespace rodeo {

// the ring (the fastest of the sweep on the card, PERF.md)
constexpr int kAdjSteps = 24;           // steps per stage
constexpr int kAdjStages = 3;           // stages in the ring

// the rows a step reads: z (ACT), packed S^{-1}, then G ((Q - ACT) ACT,
// row-major in (i - ACT, a)) when ACT < Q
template <int Q, int ACT>
using AdjRows =
    std::conditional_t<(Q > ACT),
                       StreamRows<ACT, Tri<ACT>::N, (Q - ACT) * ACT>,
                       StreamRows<ACT, Tri<ACT>::N>>;

// dynamic shared memory of a CTA: the ring, then two stages of gx rows
template <int Q, int ACT>
constexpr size_t adj_smem_bytes() {
  return sizeof(float) * kAdjSteps * kStreamCols *
         (kAdjStages * AdjRows<Q, ACT>::R + 2 * ACT);
}

// One reverse step of one column from its rows of the step (AdjRows): lam
// carried, the step's gradient in the active rows in gx, in the twin's
// order.
template <int Q, int ACT>
__device__ __forceinline__ void adjoint_step(
    const float (&Qt)[Q][Q], const float (&row)[AdjRows<Q, ACT>::R],
    float (&lam)[Q], float (&gx)[ACT]) {
  constexpr int S0 = ACT, G0 = ACT + Tri<ACT>::N;  // first rows of S^{-1}, G
  float v[ACT], t[ACT];
#pragma unroll
  for (int a = 0; a < ACT; ++a) {
    float acc = row[S0 + Tri<ACT>::at(a, 0)] * row[0];
#pragma unroll
    for (int b = 1; b < ACT; ++b) acc = acc + row[S0 + Tri<ACT>::at(a, b)] * row[b];
    v[a] = acc;
  }
#pragma unroll
  for (int a = 0; a < ACT; ++a) {
    float acc = 0.0f;
    if constexpr (Q > ACT) {
      acc = row[G0 + a] * lam[ACT];
#pragma unroll
      for (int i = ACT + 1; i < Q; ++i) acc = acc + row[G0 + (i - ACT) * ACT + a] * lam[i];
    }
    t[a] = acc;
  }
#pragma unroll
  for (int a = 0; a < ACT; ++a) gx[a] = lam[a] + t[a] - v[a];
  float u[Q];
#pragma unroll
  for (int a = 0; a < ACT; ++a) u[a] = v[a] - t[a];
#pragma unroll
  for (int i = ACT; i < Q; ++i) u[i] = lam[i];
  matvec<Q>(Qt, u, lam);
}

template <int Q, int ACT, int V>
__global__ void __launch_bounds__(2 * kStreamCols)
    magi_adjoint_kernel(QConst<Q> qc, int n_steps, int n_col_i,
                        const float* __restrict__ z,
                        const float* __restrict__ s_inv,
                        const float* __restrict__ G, float* __restrict__ gx,
                        float* __restrict__ lam0) {
  using Rows = AdjRows<Q, ACT>;
  constexpr int S = kAdjSteps, K = kAdjStages;
  extern __shared__ __align__(16) float smem[];
  auto ring = reinterpret_cast<float (*)[S][Rows::R][kStreamCols]>(smem);
  auto& out = *reinterpret_cast<float (*)[2][S][ACT][kStreamCols]>(
      smem + K * S * Rows::R * kStreamCols);
  const size_t n_col = n_col_i;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kStreamCols;
  const int width = min(kStreamCols, n_col_i - static_cast<int>(col0));
  // the producer thread's chunk of a row
  const size_t chunk = col0 + chunk_col<V>(threadIdx.x % kStreamCols);
  // the transposed transition: Qt[i][j] = Q[j][i]
  float Qt[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) Qt[i][j] = qc.q[j * Q + i];
  float lam[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) lam[j] = 0.0f;

  auto stream = [&](const float* const (&ops)[Rows::kOps]) {
    stream_stages<Rows, ACT, V, S, K>(
        ring, out, n_steps, n_col, col0, width, ops,
        [&](int, const float (&v)[Rows::R], float (&o)[ACT][kStreamCols],
            int t) {
          float g[ACT];
          adjoint_step<Q, ACT>(Qt, v, lam, g);
#pragma unroll
          for (int a = 0; a < ACT; ++a) o[a][t] = g[a];
        },
        // row a of step n of gx
        [&](int n, int a) {
          return gx + (static_cast<size_t>(n) * ACT + a) * n_col + chunk;
        });
  };
  if constexpr (Q > ACT) {
    const float* const ops[] = {z, s_inv, G};
    stream(ops);
  } else {
    const float* const ops[] = {z, s_inv};
    stream(ops);
  }
  // the consumer threads of live columns (the producer's threadIdx.x is at
  // least kStreamCols, never below width)
  const int t = threadIdx.x;
  if (t < width) {
#pragma unroll
    for (int j = 0; j < Q; ++j) lam0[j * n_col + col0 + t] = lam[j];
  }
}

inline SplitGeometry adjoint_geometry(int n_col) {
  return {dim3((n_col + kStreamCols - 1) / kStreamCols), stream_cta()};
}

// The kernel's dynamic shared memory may exceed 48 KB only once the kernel
// is allowed it.
template <int ACT, int V>
cudaError_t allow_adjoint_smem() {
  return cudaFuncSetAttribute(magi_adjoint_kernel<3, ACT, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(adj_smem_bytes<3, ACT>()));
}

template <int ACT, int V>
cudaError_t magi_adjoint_launch(const QConst<3>& qc, int n_steps, int n_col,
                                const float* z, const float* s_inv,
                                const float* G, float* gx, float* lam0,
                                cudaStream_t stream) {
  const cudaError_t err = allow_adjoint_smem<ACT, V>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = adjoint_geometry(n_col);
  magi_adjoint_kernel<3, ACT, V>
      <<<geo.grid, geo.block, adj_smem_bytes<3, ACT>(), stream>>>(
          qc, n_steps, n_col, z, s_inv, G, gx, lam0);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t magi_adjoint_dispatch(bool vec, const QConst<3>& qc, int n_steps,
                                  int n_col, const float* z,
                                  const float* s_inv, const float* G,
                                  float* gx, float* lam0,
                                  cudaStream_t stream) {
  auto* launch = vec ? &magi_adjoint_launch<ACT, 4>
                     : &magi_adjoint_launch<ACT, 1>;
  return launch(qc, n_steps, n_col, z, s_inv, G, gx, lam0, stream);
}

template <int ACT>
cudaError_t magi_adjoint_geometry_of(int n_col, int* out) {
  const bool vec = n_col % 4 == 0;
  const cudaError_t err = vec ? allow_adjoint_smem<ACT, 4>()
                              : allow_adjoint_smem<ACT, 1>();
  if (err != cudaSuccess) return err;
  const SplitGeometry geo = adjoint_geometry(n_col);
  return vec ? report_geometry(magi_adjoint_kernel<3, ACT, 4>, geo, out,
                               adj_smem_bytes<3, ACT>())
             : report_geometry(magi_adjoint_kernel<3, ACT, 1>, geo, out,
                               adj_smem_bytes<3, ACT>());
}

}  // namespace rodeo

// act: 1, 2 or 3.  q_host points to the 3 x 3 scaled transition (not
// transposed) in host memory; every other pointer is device memory laid out
// as magi_adjoint_batch (ops/fused_magi.py) documents (G is read only when
// act < 3).  Rows go 16 bytes at a time where n_block x B is a multiple of
// 4 and z, s_inv, G (when read) and gx are 16-byte aligned, else 4 bytes at
// a time.  Returns a cudaError_t.
extern "C" int rodeo_magi_adjoint_batch(int act, int n_steps, int n_block,
                                        int n_lane, const void* q_host,
                                        const void* z, const void* s_inv,
                                        const void* G, void* gx, void* lam0,
                                        void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  if (act < 3 && G == nullptr) return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  const auto* zp = static_cast<const float*>(z);
  const auto* sp = static_cast<const float*>(s_inv);
  const auto* gp = static_cast<const float*>(G);
  auto* xp = static_cast<float*>(gx);
  auto* lp = static_cast<float*>(lam0);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_col = n_block * n_lane;
  const bool vec = act < 3 ? stream_aligned(n_col, zp, sp, gp, xp)
                           : stream_aligned(n_col, zp, sp, xp);
  switch (act) {
    case 1:
      return magi_adjoint_dispatch<1>(vec, qc, n_steps, n_col, zp, sp, gp, xp, lp, s);
    case 2:
      return magi_adjoint_dispatch<2>(vec, qc, n_steps, n_col, zp, sp, gp, xp, lp, s);
    case 3:
      return magi_adjoint_dispatch<3>(vec, qc, n_steps, n_col, zp, sp, gp, xp, lp, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch rodeo_magi_adjoint_batch makes for act and n_block x n_lane
// columns with aligned operands on the current device, as
// report_geometry's nine ints (block_step.cuh; the shared memory is the
// ring's and the staged rows', dynamic), then the ring's stages, the steps
// a stage holds and the columns a CTA holds, in out.  Returns a
// cudaError_t.
extern "C" int rodeo_magi_adjoint_batch_geometry(int act, int n_block,
                                                 int n_lane, void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const int n_col = n_block * n_lane;
  cudaError_t err;
  switch (act) {
    case 1: err = magi_adjoint_geometry_of<1>(n_col, o); break;
    case 2: err = magi_adjoint_geometry_of<2>(n_col, o); break;
    case 3: err = magi_adjoint_geometry_of<3>(n_col, o); break;
    default: return cudaErrorInvalidValue;
  }
  o[9] = kAdjStages;
  o[10] = kAdjSteps;
  o[11] = kStreamCols;
  return err;
}
