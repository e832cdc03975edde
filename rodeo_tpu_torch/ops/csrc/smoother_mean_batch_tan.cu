// K11e: the tangent twin of the smoother's mean recursion (K2r's),
//   m_n = g_n + G_n m_{n+1},
//   dm_n = dg_n + dG_n m_{n+1} + G_n dm_{n+1}  (each tangent direction),
// from the terminal values down to row 0.  Covariances are not carried: the
// solution's sensitivities need means only.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _smoother_mean_kernel_batch_tan, at q = 3, 4 and 5 and 1 to kMaxTan = 7
// tangent directions (dispatch.cuh).  Plain PyTorch twin:
// _smoother_mean_tan_plain in ops/fused_kalman.py.
//
// Design.  One thread per (block, lane) column and tangent direction
// carries the mean and its tangent (2 Q floats) in registers
// through all T steps of one launch.  A CTA holds kTanCols columns x n_tan
// directions, so the threads of one column read the same value rows (the
// first brings them into L1) and each its own direction's tangent rows.
// The tangent adds its terms in the TPU kernel's order, (dg + dG m) + G dm
// per term, in kernel and twin alike.  The inputs and the output keep the
// (T, NAUG d, n_block, B) layout with lanes innermost; the thread of
// direction 0 stores the values.
//
// What bounds it on the card.  Each step reads NAUG (Q Q + Q) floats and
// writes NAUG Q per column, 48 and 12 at q = 3 and NAUG = 4 (values and
// tangents of g, G, m): a streaming kernel
// bound by device-memory bandwidth (5.9 GB at 3999 steps x 3 blocks x 2048
// lanes, 1.76 ms at 3.35 TB/s).  The loads of tan_unroll<Q>() steps are
// issued before they are used, as in K4: 4 at q = 3, 2 at q = 4 and 1 at
// q = 5, whose rows of 4 steps (240 floats) would not fit the registers
// that a CTA of 7 directions leaves a thread (at most 146).
#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"

namespace rodeo {

constexpr int kTanCols = 64;

template <int Q>
__host__ __device__ constexpr int tan_unroll() {
  return Q <= 3 ? 4 : (Q == 4 ? 2 : 1);
}

template <int Q>
struct MeanRowTan {
  float G[Q][Q], dG[Q][Q];
  float g[Q], dg[Q];
};

template <int Q>
__device__ __forceinline__ void load_mean_row_tan(int n, int n_aug, int dir,
                                                  size_t n_col, size_t c,
                                                  const float* __restrict__ g,
                                                  const float* __restrict__ G,
                                                  MeanRowTan<Q>& row) {
  const size_t rG = static_cast<size_t>(n) * n_aug * Q * Q;
  const size_t rg = static_cast<size_t>(n) * n_aug * Q;
  const size_t t = 1 + dir;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      row.G[i][j] = __ldg(G + (rG + i * Q + j) * n_col + c);
      row.dG[i][j] = __ldg(G + (rG + t * Q * Q + i * Q + j) * n_col + c);
    }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    row.g[i] = __ldg(g + (rg + i) * n_col + c);
    row.dg[i] = __ldg(g + (rg + t * Q + i) * n_col + c);
  }
}

template <int Q>
__device__ __forceinline__ void mean_step_tan(int n, int n_aug, int dir,
                                              size_t n_col, size_t c,
                                              const MeanRowTan<Q>& row,
                                              float (&m)[Q], float (&dm)[Q],
                                              float* __restrict__ ms) {
  float m_out[Q], dm_out[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = row.g[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.G[i][j] * m[j];
    m_out[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = row.dg[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.dG[i][j] * m[j] + row.G[i][j] * dm[j];
    dm_out[i] = acc;
  }
  const size_t r = static_cast<size_t>(n) * n_aug * Q;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    m[i] = m_out[i];
    dm[i] = dm_out[i];
    if (dir == 0) ms[(r + i) * n_col + c] = m[i];
    ms[(r + (1 + dir) * static_cast<size_t>(Q) + i) * n_col + c] = dm[i];
  }
}

template <int Q>
__global__ void __launch_bounds__(kTanCols * kMaxTan)
    smoother_mean_tan_kernel(int n_steps, int n_col_i, int n_tan,
                             const float* __restrict__ g,
                             const float* __restrict__ G,
                             const float* __restrict__ mN,
                             float* __restrict__ ms) {
  const int n_aug = 1 + n_tan;
  const int ci = blockIdx.x * kTanCols + threadIdx.x;
  const int dir = threadIdx.y;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  float m[Q], dm[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    m[j] = mN[j * n_col + c];
    dm[j] = mN[((1 + dir) * Q + j) * n_col + c];
  }

  constexpr int U = tan_unroll<Q>();
  int n = n_steps - 1;
  for (; n >= U - 1; n -= U) {
    MeanRowTan<Q> rows[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_mean_row_tan<Q>(n - u, n_aug, dir, n_col, c, g, G, rows[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      mean_step_tan<Q>(n - u, n_aug, dir, n_col, c, rows[u], m, dm, ms);
  }
  for (; n >= 0; --n) {
    MeanRowTan<Q> row;
    load_mean_row_tan<Q>(n, n_aug, dir, n_col, c, g, G, row);
    mean_step_tan<Q>(n, n_aug, dir, n_col, c, row, m, dm, ms);
  }
}

inline SplitGeometry mean_tan_geometry(int n_col, int n_tan) {
  return {dim3((n_col + kTanCols - 1) / kTanCols), dim3(kTanCols, n_tan)};
}

}  // namespace rodeo

// q: the derivatives per block, 3, 4 or 5; n_col = n_block * B, n_tan
// tangent directions, 1 to kMaxTan (7); any other returns
// cudaErrorInvalidValue.  g (T, NAUG q, n_col), G (T, NAUG q q, n_col), mN
// (NAUG q, n_col) and ms (T, NAUG q, n_col) in device memory, as
// smoother_mean_recursion_batch_tan (ops/fused_kalman.py) documents.
// Returns a cudaError_t.
extern "C" int rodeo_smoother_mean_batch_tan(int q, int n_steps, int n_col,
                                             int n_tan, const void* g,
                                             const void* G, const void* mN,
                                             void* ms, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_col < 1 || n_tan < 1 || n_tan > kMaxTan)
    return cudaErrorInvalidValue;
  const SplitGeometry geo = mean_tan_geometry(n_col, n_tan);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    smoother_mean_tan_kernel<decltype(qq)::value>
        <<<geo.grid, geo.block, 0, static_cast<cudaStream_t>(stream)>>>(
            n_steps, n_col, n_tan, static_cast<const float*>(g),
            static_cast<const float*>(G), static_cast<const float*>(mN),
            static_cast<float*>(ms));
    return cudaGetLastError();
  });
}

// The launch rodeo_smoother_mean_batch_tan makes at q for n_col columns
// and n_tan directions on the current device, as report_geometry's nine
// ints (block_step.cuh) in out.  Returns a cudaError_t.
extern "C" int rodeo_smoother_mean_batch_tan_geometry(int q, int n_col,
                                                      int n_tan, void* out) {
  using namespace rodeo;
  if (n_col < 1 || n_tan < 1 || n_tan > kMaxTan) return cudaErrorInvalidValue;
  return with_value<3, 4, 5>(q, [&](auto qq) {
    return report_geometry(smoother_mean_tan_kernel<decltype(qq)::value>,
                           mean_tan_geometry(n_col, n_tan),
                           static_cast<int*>(out));
  });
}
