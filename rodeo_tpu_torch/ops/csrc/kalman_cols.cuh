// Per-thread Kalman algebra in registers, shared by the fused kernels.
//
// A state block is a mean of Q floats and a covariance packed as its upper
// triangle, Tri<Q>::N floats in the order (0,0), (0,1), ..., (0,Q-1),
// (1,1), ... -- the order of _tri_idx in ops/fused_kalman.py.  Every helper
// adds its terms in the order of its plain PyTorch counterpart in
// ops/fused_kalman.py, so that with multiply-add contraction off
// (-fmad=false) a kernel rounds exactly as its plain twin does.  Where the
// twin skips a coefficient that is exactly 0 or multiplies by exactly 1,
// the dense sum here adds an exact zero or multiplies exactly, which
// changes no finite result.
//
// Every helper is templated on its scalar types: float in the plain kernels,
// Dual (dual.cuh) in the tangent kernels, where a term mixes the two types
// as the twin mixes constants with Duals.  The result type of a product is
// that of the operator: Dual if either factor is.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace rodeo {

template <class A, class B>
using Prod = decltype(A() * B());

template <int Q>
struct Tri {
  static constexpr int N = Q * (Q + 1) / 2;
  // packed index of entry (i, j) of a symmetric Q x Q matrix
  __host__ __device__ static constexpr int at(int i, int j) {
    return i <= j ? i * Q - i * (i - 1) / 2 + (j - i)
                  : j * Q - j * (j - 1) / 2 + (i - j);
  }
};

// out = A v
template <int Q, class TA, class TV>
__device__ __forceinline__ void matvec(const TA (&A)[Q][Q], const TV (&v)[Q],
                                       Prod<TA, TV> (&out)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    Prod<TA, TV> acc = A[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) acc = acc + A[i][j] * v[j];
    out[i] = acc;
  }
}

// Upper triangle of A P A' for packed symmetric P: T = A P (sum over j),
// then entry (i, l) = sum over k of A[l][k] T[i][k].
template <int Q, class TA, class TP>
__device__ __forceinline__ void sym_quadform(const TA (&A)[Q][Q],
                                             const TP (&P)[Tri<Q>::N],
                                             Prod<TA, TP> (&out)[Tri<Q>::N]) {
  using TT = Prod<TA, TP>;
  TT T[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      TT acc = A[i][0] * P[Tri<Q>::at(0, k)];
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + A[i][j] * P[Tri<Q>::at(j, k)];
      T[i][k] = acc;
    }
  }
  int idx = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int l = i; l < Q; ++l) {
      Prod<TA, TT> acc = A[l][0] * T[i][0];
#pragma unroll
      for (int k = 1; k < Q; ++k) acc = acc + A[l][k] * T[i][k];
      out[idx++] = acc;
    }
  }
}

// Closed-form inverse of a packed symmetric matrix (_sym_inv of
// ops/fused_kalman.py): 1 / p for Q = 1; the adjugate over the determinant
// for Q = 2; for Q = 3 the cofactor form, scale-normalised against float32
// determinant overflow; for Q = 4 and 5 one 2 + (Q - 2) Schur split of the
// matrix scaled by its largest diagonal entry, recursing into the Q = 2 and
// Q - 2 forms.  A scale is taken from the values alone: the inverse does
// not depend on it, so it is a constant with a zero tangent, as in the twin
// (differentiating fmaxf would split the tangent at ties).
template <int Q, class T>
__device__ __forceinline__ void sym_inv(const T (&p)[Tri<Q>::N],
                                        T (&out)[Tri<Q>::N]) {
  static_assert(Q >= 1 && Q <= 5, "sym_inv: q <= 5");
  if constexpr (Q == 1) {
    out[0] = 1.0f / p[0];
  } else if constexpr (Q == 2) {
    const T inv_det = 1.0f / (p[0] * p[2] - p[1] * p[1]);
    out[0] = p[2] * inv_det;
    out[1] = (-p[1]) * inv_det;
    out[2] = p[0] * inv_det;
  } else if constexpr (Q == 3) {
    T a = p[0], b = p[1], c = p[2], d = p[3], e = p[4], f = p[5];
    const float s = fmaxf(fabsf(value(a)), fmaxf(fabsf(value(d)), fabsf(value(f))));
    const float rs = 1.0f / fmaxf(s, 1e-30f);
    a = a * rs; b = b * rs; c = c * rs; d = d * rs; e = e * rs; f = f * rs;
    const T co00 = d * f - e * e;
    const T co01 = c * e - b * f;
    const T co02 = b * e - c * d;
    const T co11 = a * f - c * c;
    const T co12 = b * c - a * e;
    const T co22 = a * d - b * b;
    const T det = a * co00 + b * co01 + c * co02;
    const T inv_det = rs / det;
    out[0] = co00 * inv_det;
    out[1] = co01 * inv_det;
    out[2] = co02 * inv_det;
    out[3] = co11 * inv_det;
    out[4] = co12 * inv_det;
    out[5] = co22 * inv_det;
  } else {
    // M = [[A, B], [B', D]], A (K x K), B (K x M), D (M x M)
    constexpr int K = 2, M = Q - 2;
    float s = value(p[Tri<Q>::at(0, 0)]);
#pragma unroll
    for (int i = 1; i < Q; ++i)
      s = fmaxf(fabsf(s), fabsf(value(p[Tri<Q>::at(i, i)])));
    const float rs = 1.0f / fmaxf(s, 1e-30f);
    T pc[Tri<Q>::N];
#pragma unroll
    for (int k = 0; k < Tri<Q>::N; ++k) pc[k] = p[k] * rs;
    const T a_in[3] = {pc[Tri<Q>::at(0, 0)], pc[Tri<Q>::at(0, 1)],
                       pc[Tri<Q>::at(1, 1)]};
    T Ainv[3];
    sym_inv<K>(a_in, Ainv);
    // C = A^{-1} B
    T C[K][M];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        T acc = Ainv[Tri<K>::at(i, 0)] * pc[Tri<Q>::at(0, K + j)];
#pragma unroll
        for (int l = 1; l < K; ++l)
          acc = acc + Ainv[Tri<K>::at(i, l)] * pc[Tri<Q>::at(l, K + j)];
        C[i][j] = acc;
      }
    // the Schur complement S = D - B' C, packed
    T S[Tri<M>::N];
    int idx = 0;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = i; j < M; ++j) {
        T acc = pc[Tri<Q>::at(K + i, K + j)];
#pragma unroll
        for (int l = 0; l < K; ++l)
          acc = acc - pc[Tri<Q>::at(l, K + i)] * C[l][j];
        S[idx++] = acc;
      }
    T Sinv[Tri<M>::N];
    sym_inv<M>(S, Sinv);
    // the inverse's blocks: UL = A^{-1} + C S^{-1} C', UR = -C S^{-1},
    // LR = S^{-1}
    T UR[K][M];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        T acc = C[i][0] * Sinv[Tri<M>::at(0, j)];
#pragma unroll
        for (int l = 1; l < M; ++l) acc = acc + C[i][l] * Sinv[Tri<M>::at(l, j)];
        UR[i][j] = -acc;
      }
    idx = 0;
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
      for (int j = i; j < Q; ++j, ++idx) {
        if (j < K) {
          T acc = Ainv[Tri<K>::at(i, j)];
#pragma unroll
          for (int l = 0; l < M; ++l) acc = acc - UR[i][l] * C[j][l];
          out[idx] = acc * rs;
        } else if (i < K) {
          out[idx] = UR[i][j - K] * rs;
        } else {
          out[idx] = Sinv[Tri<M>::at(i - K, j - K)] * rs;
        }
      }
  }
}

// Closed-form lower Cholesky factor L[i][j], j <= i, of a packed symmetric
// matrix (_chol_cols of ops/fused_kalman.py): normalised to correlation form
// (unit diagonal), factored with a relative pivot floor, and its rows
// scaled back.  A floored pivot marks a numerically null direction: the
// entries below it are zero, not divided by the floor.  Entries above the
// diagonal are left unset.
template <int Q>
__device__ __forceinline__ void chol_cols(const float (&p)[Tri<Q>::N],
                                          float (&L)[Q][Q]) {
  constexpr float kFloor = 1e-12f;
  float d[Q], rd[Q];
  bool ok[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    d[i] = sqrtf(fmaxf(p[Tri<Q>::at(i, i)], 1e-38f));
    rd[i] = 1.0f / d[i];
  }
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = p[Tri<Q>::at(i, j)] * (rd[i] * rd[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        ok[i] = s > kFloor;
        L[i][i] = sqrtf(fmaxf(s, kFloor));
      } else {
        const float r = s / L[j][j];
        L[i][j] = ok[j] ? r : 0.0f;
      }
    }
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = L[i][j] * d[i];
}

// out = L e for a lower-triangular L (_chol_matvec of ops/fused_kalman.py,
// whose sum starts from 0).
template <int Q>
__device__ __forceinline__ void chol_matvec(const float (&L)[Q][Q],
                                            const float (&e)[Q],
                                            float (&out)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j <= i; ++j) acc = acc + L[i][j] * e[j];
    out[i] = acc;
  }
}

// Determinant of a packed symmetric matrix, Q <= 3 (_sym_det of
// ops/fused_magi.py; not scale-normalised, as in the JAX package: in the
// Taylor-scaled coordinates the entries are O(1)).
template <int Q, class T>
__device__ __forceinline__ T sym_det(const T (&s)[Tri<Q>::N]) {
  static_assert(Q >= 1 && Q <= 3, "sym_det: only q <= 3 is ported");
  if constexpr (Q == 1) {
    return s[0];
  } else if constexpr (Q == 2) {
    return s[0] * s[2] - s[1] * s[1];
  } else {
    return s[0] * (s[3] * s[5] - s[4] * s[4]) - s[1] * (s[1] * s[5] - s[4] * s[2]) +
           s[2] * (s[1] * s[4] - s[3] * s[2]);
  }
}

// log(2 pi), rounded to float32 as PyTorch rounds the Python float
constexpr float kLog2Pi = static_cast<float>(1.8378770664093453);

// Masked scalar observation update of one block (_masked_obs_update_cols of
// ops/fused_kalman.py): S = om + D P D', z = y - D m, K = P D' / S * mask,
// m += K z, P = (I - K D) P (I - K D)' + K K' om.  At a step without data
// (D = 0, y = 0, om = 1, mask = 0) it leaves m and P exactly as they were.
// Returns the block's log-density term z^2 / S + log S + log 2 pi, which
// the caller scales by -0.5 * mask.  The data (D, y, om, mask) are
// constants; m and P are float or Dual.
template <int Q, class T>
__device__ __forceinline__ T masked_obs_update(const float (&D)[Q], float y,
                                               float om, float mask,
                                               T (&m)[Q], T (&P)[Tri<Q>::N]) {
  T PD[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = P[Tri<Q>::at(i, 0)] * D[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) acc = acc + P[Tri<Q>::at(i, j)] * D[j];
    PD[i] = acc;
  }
  // S = om, then its terms; z = y, then its terms (the twin's order)
  T S = om + D[0] * PD[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) S = S + D[i] * PD[i];
  T z = y - D[0] * m[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) z = z - D[i] * m[i];
  const T inv_S = 1.0f / S;
  const T term = z * z * inv_S + log_of(S) + kLog2Pi;
  T K[Q], IKD[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) K[i] = PD[i] * inv_S * mask;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = m[i] + K[i] * z;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) IKD[i][j] = (i == j ? 1.0f : 0.0f) - K[i] * D[j];
  T pj[Tri<Q>::N];
  sym_quadform<Q>(IKD, P, pj);
  int k = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = i; j < Q; ++j, ++k) P[k] = pj[k] + K[i] * K[j] * om;
  return term;
}

}  // namespace rodeo
