// A second-order forward number along one direction: a value, its first
// and its second derivative.  Evaluating a function on Jet2(x, 1, 0) gives
// f(x), f'(x) and f''(x), the gradient and Hessian of an observation
// model's Laplace linearisation (obs_models.cuh).  The component type T is
// float in K9 (filter_nn_batch.cuh), and Dual (dual.cuh) in its tangent
// twin K11d (filter_nn_batch_tan.cuh), where the tangent of f'' carries the
// third derivative.
//
// The rules are those of Jet2 in ops/dual.py, written once here and once
// there with their operations in the same order (a, b Jet2s with
// components a0, a1, a2; c a float constant; q = a0 / b0):
//   a +- b, -a: componentwise;  a +- c: (a0 +- c, a1, a2);
//   a * b: (a0 b0, a1 b0 + a0 b1, (a2 b0 + a0 b2) + (a1 b1 + a1 b1));
//   a * c: each component times c;
//   a / b: (q, q1 = (a1 - q b1) / b0, (a2 - (q1 b1 + q1 b1) - q b2) / b0);
//   a / c: each component over c;
//   c / b: (q, q1 = -(q b1) / b0, -((q1 b1 + q1 b1) + q b2) / b0);
//   exp a: (e, e a1, e (a2 + a1 a1)), e = exp(a0);
//   log a: (log a0, q1 = a1 / a0, (a2 - q1 a1) / a0).
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

namespace rodeo {

template <class T>
struct Jet2 {
  T v, d1, d2;
};

template <class T>
__device__ __forceinline__ Jet2<T> operator+(const Jet2<T>& a, const Jet2<T>& b) {
  return {a.v + b.v, a.d1 + b.d1, a.d2 + b.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator+(const Jet2<T>& a, float c) {
  return {a.v + c, a.d1, a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator+(float c, const Jet2<T>& a) {
  return {c + a.v, a.d1, a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator-(const Jet2<T>& a, const Jet2<T>& b) {
  return {a.v - b.v, a.d1 - b.d1, a.d2 - b.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator-(const Jet2<T>& a, float c) {
  return {a.v - c, a.d1, a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator-(float c, const Jet2<T>& a) {
  return {c - a.v, -a.d1, -a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator-(const Jet2<T>& a) {
  return {-a.v, -a.d1, -a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator*(const Jet2<T>& a, const Jet2<T>& b) {
  return {a.v * b.v, a.d1 * b.v + a.v * b.d1,
          (a.d2 * b.v + a.v * b.d2) + (a.d1 * b.d1 + a.d1 * b.d1)};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator*(const Jet2<T>& a, float c) {
  return {a.v * c, a.d1 * c, a.d2 * c};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator*(float c, const Jet2<T>& a) {
  return {c * a.v, c * a.d1, c * a.d2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator/(const Jet2<T>& a, const Jet2<T>& b) {
  const T q = a.v / b.v;
  const T q1 = (a.d1 - q * b.d1) / b.v;
  const T q2 = (a.d2 - (q1 * b.d1 + q1 * b.d1) - q * b.d2) / b.v;
  return {q, q1, q2};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator/(const Jet2<T>& a, float c) {
  return {a.v / c, a.d1 / c, a.d2 / c};
}
template <class T>
__device__ __forceinline__ Jet2<T> operator/(float c, const Jet2<T>& b) {
  const T q = c / b.v;
  const T q1 = -(q * b.d1) / b.v;
  const T q2 = -((q1 * b.d1 + q1 * b.d1) + q * b.d2) / b.v;
  return {q, q1, q2};
}
template <class T>
__device__ __forceinline__ Jet2<T> exp_of(const Jet2<T>& a) {
  const T e = exp_of(a.v);
  return {e, e * a.d1, e * (a.d2 + a.d1 * a.d1)};
}
template <class T>
__device__ __forceinline__ Jet2<T> log_of(const Jet2<T>& a) {
  const T q1 = a.d1 / a.v;
  return {log_of(a.v), q1, (a.d2 - q1 * a.d1) / a.v};
}

// x as the variable of differentiation: (x, 1, 0)
template <class T>
__device__ __forceinline__ Jet2<T> jet_variable(T x) {
  return {x, T(1.0f), T(0.0f)};
}

}  // namespace rodeo
