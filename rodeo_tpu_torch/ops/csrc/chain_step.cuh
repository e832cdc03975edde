// The backward chain of the reverse recursions, for a thread that carries one
// (block, lane) column: a row (A_n, b_n, C_n) of the chain -- the smoothing
// gains (G_n, g_n, L_n) -- maps the state at step n+1 onto step n,
//   m = b_n + A_n m,   P = C_n + A_n P A_n'.
// The step is shared by the smoother rows K2r (smoother_batch_rows.cu) and
// fenrir's single-solve backward filter K7a (fenrir_backward_single.cu),
// which stream the chain through stream_ring.cuh, and by fenrir's backward
// filters K7b and K11b through fenrir_step.cuh, so that all of them do the
// same arithmetic as their plain twins (_smoother_batch_plain of
// ops/fused_kalman.py, _fenrir_backward_plain of ops/fused_fenrir.py); K4
// (smoother_single.cu) spreads it over the lanes of a warp in the same
// order.
//
// K10b, which reads its operands from device memory itself, indexes them
// through a layout, so that no host code transposes them: (T, D, NB, B),
// columns innermost (BatchLayout).
#pragma once

#include <cuda_runtime.h>

#include "kalman_cols.cuh"

namespace rodeo {

// Entry i of D at step n of column c in a (T, D, n_col) array.
struct BatchLayout {
  size_t n_col;
  __device__ __forceinline__ size_t operator()(int n, int i, size_t c, int D) const {
    return (static_cast<size_t>(n) * D + i) * n_col + c;
  }
};

// One row of the chain, as float or Dual.
template <class T, int Q>
struct ChainRow {
  T A[Q][Q];
  T b[Q];
  T C[Tri<Q>::N];
};

// m = b + A m, P = C + A P A', each sum in the twin's order.
template <int Q, class T>
__device__ __forceinline__ void chain_step(const ChainRow<T, Q>& row, T (&m)[Q],
                                           T (&P)[Tri<Q>::N]) {
  constexpr int NT = Tri<Q>::N;
  T m_out[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = row.b[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc + row.A[i][j] * m[j];
    m_out[i] = acc;
  }
  T apa[NT];
  sym_quadform<Q>(row.A, P, apa);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = row.C[k] + apa[k];
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = m_out[i];
}

}  // namespace rodeo
