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
// Design.  K7b's design on the forward-mode number Dual (dual.cuh): one
// thread per (block, lane, direction) carries m, the packed P and the block's
// log-density as Duals through all N steps (fenrir_step.cuh, K7b's step),
// so its values are K7b's bitwise.  A CTA holds kTanCols columns x n_tan
// directions: the threads of one column read the same value rows, which the
// first of them brings into L1, and each reads its own direction's tangent
// rows.  The observation grid is a constant shared by all lanes (zero
// tangent).  The thread of direction 0 stores the value; the wrapper adds
// the blocks in block order, as for K7b.
//
// What bounds it on the card.  It reads the augmented chain once, 72 floats
// per (step, block, lane) at NAUG = 4 (7.08 GB at 4000 steps x 3 blocks x
// 2048 lanes, 2.11 ms at 3.35 TB/s), and writes NAUG floats per column: a
// streaming kernel bound by device-memory bandwidth.  As in K7b the loads
// of kTanUnroll steps are issued before they are used; a thread's row is
// twice K7b's (value and tangent), so it unrolls half as far.
#include <cuda_runtime.h>

#include "dual.cuh"
#include "fenrir_step.cuh"
#include "kalman_cols.cuh"

namespace rodeo {

constexpr int kTanCols = 64;
constexpr int kTanUnroll = 4;
constexpr int kMaxTan = 4;

// Row n of the augmented chain (N, NAUG d, n_col): the values and the
// tangents of direction dir, for column c.
template <int Q>
__device__ __forceinline__ void load_chain_row_tan(
    int n, int n_aug, int dir, size_t n_col, size_t c,
    const float* __restrict__ A, const float* __restrict__ b,
    const float* __restrict__ C, ChainRow<Dual, Q>& row) {
  constexpr int NT = Tri<Q>::N;
  const size_t rA = static_cast<size_t>(n) * n_aug * Q * Q;
  const size_t rb = static_cast<size_t>(n) * n_aug * Q;
  const size_t rC = static_cast<size_t>(n) * n_aug * NT;
  const size_t t = 1 + dir;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j)
      row.A[i][j] = Dual(__ldg(A + (rA + i * Q + j) * n_col + c),
                         __ldg(A + (rA + t * Q * Q + i * Q + j) * n_col + c));
#pragma unroll
  for (int i = 0; i < Q; ++i)
    row.b[i] = Dual(__ldg(b + (rb + i) * n_col + c),
                    __ldg(b + (rb + t * Q + i) * n_col + c));
#pragma unroll
  for (int k = 0; k < NT; ++k)
    row.C[k] = Dual(__ldg(C + (rC + k) * n_col + c),
                    __ldg(C + (rC + t * NT + k) * n_col + c));
}

template <int Q>
__global__ void __launch_bounds__(kTanCols * kMaxTan)
    fenrir_backward_tan_kernel(int n_steps, int n_block, int n_lane,
                               int n_tan, const float* __restrict__ A,
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
  const int n_aug = 1 + n_tan;
  const int n_col_i = n_block * n_lane;
  const int ci = blockIdx.x * kTanCols + threadIdx.x;
  const int dir = threadIdx.y;
  if (ci >= n_col_i) return;
  const size_t c = ci, n_col = n_col_i;
  const int blk = ci / n_lane;
  Dual m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    m[j] = Dual(m_seed[j * n_col + c], m_seed[((1 + dir) * Q + j) * n_col + c]);
#pragma unroll
  for (int k = 0; k < NT; ++k)
    P[k] = Dual(p_seed[k * n_col + c], p_seed[((1 + dir) * NT + k) * n_col + c]);
  Dual ld(0.0f);

  int n = n_steps - 1;
  for (; n >= kTanUnroll - 1; n -= kTanUnroll) {
    ChainRow<Dual, Q> rows[kTanUnroll];
#pragma unroll
    for (int u = 0; u < kTanUnroll; ++u)
      load_chain_row_tan<Q>(n - u, n_aug, dir, n_col, c, A, b, C, rows[u]);
#pragma unroll
    for (int u = 0; u < kTanUnroll; ++u)
      fenrir_step<Q>(n - u, n_block, blk, rows[u], d, y, om, mask, m, P, ld);
  }
  for (; n >= 0; --n) {
    ChainRow<Dual, Q> row;
    load_chain_row_tan<Q>(n, n_aug, dir, n_col, c, A, b, C, row);
    fenrir_step<Q>(n, n_block, blk, row, d, y, om, mask, m, P, ld);
  }
  store_aug(ld_blocks, 0, 1, n_aug, 0, n_col, c, dir, ld);
}

}  // namespace rodeo

// n_tan tangent directions (1..4); every pointer is device memory laid out
// as fenrir_backward_batch_tan (ops/fused_fenrir.py) documents: the chain
// A, b, C (N, NAUG d, n_block, B), the seeds m_seed (NAUG q, n_block, B)
// and p_seed (NAUG n_tri, ..), the observation grid as for
// rodeo_fenrir_backward_batch; ld_blocks is (NAUG, n_block, B).  Returns a
// cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_tan(
    int n_steps, int n_block, int n_lane, int n_tan, const void* A,
    const void* b, const void* C, const void* d, const void* y,
    const void* om, const void* mask, const void* m_seed, const void* p_seed,
    void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1 || n_tan < 1 ||
      n_tan > kMaxTan)
    return cudaErrorInvalidValue;
  const int n_col = n_block * n_lane;
  const dim3 block(kTanCols, n_tan);
  const dim3 grid((n_col + kTanCols - 1) / kTanCols);
  fenrir_backward_tan_kernel<3><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_steps, n_block, n_lane, n_tan, static_cast<const float*>(A),
      static_cast<const float*>(b), static_cast<const float*>(C),
      static_cast<const float*>(d), static_cast<const float*>(y),
      static_cast<const float*>(om), static_cast<const float*>(mask),
      static_cast<const float*>(m_seed), static_cast<const float*>(p_seed),
      static_cast<float*>(ld_blocks));
  return cudaGetLastError();
}
