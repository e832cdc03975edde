// A forward-mode number for the tangent kernels: a value and one tangent,
// the derivative along the direction of the thread that carries it.  The
// component type T is float (Dual), or Dual itself (DualT<Dual>): the
// tangent kernel K11a takes the Jacobian of a functor without a hand-written
// one (kDualJacobian) on states that already carry theta's tangent, so its
// outer direction seeds the Jacobian's column and each component carries
// theta's (jac0_own of block_step.cuh).
//
// The rules are those of ops/dual.py, written once here and once there with
// their operations in the same order (value a, tangent da; q = a / b):
//   a +- b: da +- db;   -a: -da;   a * b: da * b + a * db;
//   a / b: (da - q * db) / b;   c / b for a constant c: -(q * db) / b;
//   log a: da / a;   exp a: da * exp(a).
// A constant is a float or, in a DualT<Dual>, a Dual (theta's, which the
// Jacobian's direction does not move): its tangent is zero and is not
// carried.  The value part of every rule is exactly the operation on T, so
// a kernel templated on the scalar type computes, in the value of its
// Duals, what its float instantiation computes, bitwise.  The overloads for
// float keep the plain kernels' code as it was: value(x), log_of(x),
// exp_of(x) and the operators of float.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>
#include <math.h>

namespace rodeo {

template <class T>
struct DualT {
  T v, d;
  DualT() = default;
  __device__ __forceinline__ constexpr DualT(T v_, T d_) : v(v_), d(d_) {}
  // a constant
  __device__ __forceinline__ explicit constexpr DualT(T v_)
      : v(v_), d(T(0.0f)) {}
};

using Dual = DualT<float>;

// C is a constant to a DualT<T>: a float, or T itself
template <class C, class T>
inline constexpr bool kConstantOf =
    std::is_same_v<C, float> || std::is_same_v<C, T>;
template <class C, class T>
using IfConstantOf = std::enable_if_t<kConstantOf<C, T>, int>;

template <class T>
__device__ __forceinline__ DualT<T> operator+(DualT<T> a, DualT<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator+(DualT<T> a, C b) {
  return {a.v + b, a.d};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator+(C a, DualT<T> b) {
  return {a + b.v, b.d};
}
template <class T>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a, DualT<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a, C b) {
  return {a.v - b, a.d};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator-(C a, DualT<T> b) {
  return {a - b.v, -b.d};
}
template <class T>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a) {
  return {-a.v, -a.d};
}
template <class T>
__device__ __forceinline__ DualT<T> operator*(DualT<T> a, DualT<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator*(DualT<T> a, C b) {
  return {a.v * b, a.d * b};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator*(C a, DualT<T> b) {
  return {a * b.v, a * b.d};
}
template <class T>
__device__ __forceinline__ DualT<T> operator/(DualT<T> a, DualT<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator/(DualT<T> a, C b) {
  return {a.v / b, a.d / b};
}
template <class T, class C, IfConstantOf<C, T> = 0>
__device__ __forceinline__ DualT<T> operator/(C a, DualT<T> b) {
  const T q = a / b.v;
  return {q, -(q * b.d) / b.v};
}

__device__ __forceinline__ float value(float x) { return x; }
template <class T>
__device__ __forceinline__ float value(DualT<T> x) { return value(x.v); }

__device__ __forceinline__ float log_of(float x) { return logf(x); }
template <class T>
__device__ __forceinline__ DualT<T> log_of(DualT<T> x) {
  return {log_of(x.v), x.d / x.v};
}

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
template <class T>
__device__ __forceinline__ DualT<T> exp_of(DualT<T> x) {
  const T e = exp_of(x.v);
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
