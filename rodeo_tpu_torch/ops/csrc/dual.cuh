// A forward-mode number for the tangent kernels: a float value and one
// tangent, the derivative along the direction of the thread that carries it.
//
// The rules are those of ops/dual.py, written once here and once there with
// their operations in the same order (value a, tangent da; q = a / b):
//   a +- b: da +- db;   -a: -da;   a * b: da * b + a * db;
//   a / b: (da - q * db) / b;   c / b for a float c: -(q * db) / b;
//   log a: da / a;   exp a: da * exp(a).
// The value part of every rule is exactly the float operation, so a kernel
// templated on the scalar type computes, in the value of its Duals, what its
// float instantiation computes, bitwise.  A float mixed with a Dual is a
// constant (zero tangent).  The overloads for float keep the plain
// kernels' code as it was: value(x), log_of(x), exp_of(x) and the operators
// of float.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rodeo {

struct Dual {
  float v, d;
  Dual() = default;
  __device__ __forceinline__ constexpr Dual(float v_, float d_) : v(v_), d(d_) {}
  // a constant
  __device__ __forceinline__ explicit constexpr Dual(float v_) : v(v_), d(0.0f) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -(q * b.d) / b.v};
}

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ float value(Dual x) { return x.v; }

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ Dual log_of(Dual x) { return {logf(x.v), x.d / x.v}; }

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ Dual exp_of(Dual x) {
  const float e = expf(x.v);
  return {e, x.d * e};
}

// The output layout of the tangent kernels (that of the TPU kernels they
// replace): an output of K entries per row is (rows, NAUG K, ...), the
// values in entries 0..K-1 of a row, then each direction's tangents, K
// entries each.  Entry k of row `row` of the thread of direction `dir`: the
// thread of direction 0 also stores the value.
__device__ __forceinline__ void store_aug(float* __restrict__ out, size_t row,
                                          int K, int n_aug, int k, size_t col,
                                          size_t base, int dir, Dual x) {
  const size_t r = row * n_aug * K;
  if (dir == 0) out[(r + k) * col + base] = x.v;
  out[(r + static_cast<size_t>(1 + dir) * K + k) * col + base] = x.d;
}

}  // namespace rodeo
