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
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rodeo {

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
template <int Q>
__device__ __forceinline__ void matvec(const float (&A)[Q][Q],
                                       const float (&v)[Q], float (&out)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = A[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) acc = acc + A[i][j] * v[j];
    out[i] = acc;
  }
}

// Upper triangle of A P A' for packed symmetric P: T = A P (sum over j),
// then entry (i, l) = sum over k of A[l][k] T[i][k].
template <int Q>
__device__ __forceinline__ void sym_quadform(const float (&A)[Q][Q],
                                             const float (&P)[Tri<Q>::N],
                                             float (&out)[Tri<Q>::N]) {
  float T[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      float acc = A[i][0] * P[Tri<Q>::at(0, k)];
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
      float acc = A[l][0] * T[i][0];
#pragma unroll
      for (int k = 1; k < Q; ++k) acc = acc + A[l][k] * T[i][k];
      out[idx++] = acc;
    }
  }
}

// Closed-form inverse of a packed symmetric matrix, scale-normalised
// against float32 determinant overflow (_sym_inv of ops/fused_kalman.py,
// the cofactor form).  q = 4 and 5 need the Schur-split form of _sym_inv
// ported first.
template <int Q>
__device__ __forceinline__ void sym_inv(const float (&p)[Tri<Q>::N],
                                        float (&out)[Tri<Q>::N]) {
  static_assert(Q == 3, "sym_inv: only the q = 3 cofactor form is ported");
  float a = p[0], b = p[1], c = p[2], d = p[3], e = p[4], f = p[5];
  const float s = fmaxf(fabsf(a), fmaxf(fabsf(d), fabsf(f)));
  const float rs = 1.0f / fmaxf(s, 1e-30f);
  a = a * rs; b = b * rs; c = c * rs; d = d * rs; e = e * rs; f = f * rs;
  const float co00 = d * f - e * e;
  const float co01 = c * e - b * f;
  const float co02 = b * e - c * d;
  const float co11 = a * f - c * c;
  const float co12 = b * c - a * e;
  const float co22 = a * d - b * b;
  const float det = a * co00 + b * co01 + c * co02;
  const float inv_det = rs / det;
  out[0] = co00 * inv_det;
  out[1] = co01 * inv_det;
  out[2] = co02 * inv_det;
  out[3] = co11 * inv_det;
  out[4] = co12 * inv_det;
  out[5] = co22 * inv_det;
}

// log(2 pi), rounded to float32 as PyTorch rounds the Python float
constexpr float kLog2Pi = static_cast<float>(1.8378770664093453);

// Masked scalar observation update of one block (_masked_obs_update_cols of
// ops/fused_kalman.py): S = om + D P D', z = y - D m, K = P D' / S * mask,
// m += K z, P = (I - K D) P (I - K D)' + K K' om.  At a step without data
// (D = 0, y = 0, om = 1, mask = 0) it leaves m and P exactly as they were.
// Returns the block's log-density term z^2 / S + log S + log 2 pi, which
// the caller scales by -0.5 * mask.
template <int Q>
__device__ __forceinline__ float masked_obs_update(const float (&D)[Q],
                                                   float y, float om,
                                                   float mask, float (&m)[Q],
                                                   float (&P)[Tri<Q>::N]) {
  float PD[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = P[Tri<Q>::at(i, 0)] * D[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) acc = acc + P[Tri<Q>::at(i, j)] * D[j];
    PD[i] = acc;
  }
  float S = om;
#pragma unroll
  for (int i = 0; i < Q; ++i) S = S + D[i] * PD[i];
  float z = y;
#pragma unroll
  for (int i = 0; i < Q; ++i) z = z - D[i] * m[i];
  const float inv_S = 1.0f / S;
  const float term = z * z * inv_S + logf(S) + kLog2Pi;
  float K[Q], IKD[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) K[i] = PD[i] * inv_S * mask;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = m[i] + K[i] * z;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) IKD[i][j] = (i == j ? 1.0f : 0.0f) - K[i] * D[j];
  float pj[Tri<Q>::N];
  sym_quadform<Q>(IKD, P, pj);
  int k = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = i; j < Q; ++j, ++k) P[k] = pj[k] + K[i] * K[j] * om;
  return term;
}

}  // namespace rodeo
