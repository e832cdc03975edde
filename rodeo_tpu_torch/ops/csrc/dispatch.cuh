// The C entry points pick a kernel's instance from run-time numbers -- a
// model, an observation model, an interrogation mode, the state size q --
// with these helpers: each number is matched against the list that the
// kernel holds, one level per number, and any other value returns
// cudaErrorInvalidValue without a launch.  A number never stands for a
// combination of two, which would alias as soon as either list grew.  The
// lists mirror the instance tables of ops/fused_kalman.py (_INSTANCES),
// which refuse the same combinations in Python.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#include "filter_step.cuh"
#include "models.cuh"

namespace rodeo {

// a type as a value, for the generic lambdas the helpers call
template <class M>
struct Is {
  using type = M;
};

template <int V>
using Int = std::integral_constant<int, V>;

// f(Is<F>()) for the functor F among Fs whose kNumber is `number`
// (models.cuh's models, obs_models.cuh's observation models)
template <class... Fs, class Fn>
cudaError_t with_functor(int number, Fn&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((number == Fs::kNumber ? (err = f(Is<Fs>()), true) : false) || ...);
  return err;
}

// f(Int<V>()) for the V among Vs equal to `value` (a mode, a q)
template <int... Vs, class Fn>
cudaError_t with_value(int value, Fn&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((value == Vs ? (err = f(Int<Vs>()), true) : false) || ...);
  return err;
}

// The interrogation modes of the filters that take every one, K1 and K3:
// f(Int<MODE>()).
template <class Fn>
cudaError_t with_mode(int mode, Fn&& f) {
  return with_value<kKramer, kRodeo, kSchober, kChkrebtii>(mode, f);
}

// The (model, q) of the forward filters that take every model: K1
// (filter_batch.cu) and K3 (filter_single.cu), which hold the four modes
// there (with_mode), and the tangent filter K11a (filter_batch_tan.cu),
// DALTON's filter K8 (dalton_filter_batch.cu) and its tangent twin K11c
// (dalton_filter_batch_tan.cu), and non-Gaussian DALTON's Laplace filter K9
// (filter_nn_batch.cu) and its tangent twin K11d (filter_nn_batch_tan.cu),
// which hold kramer and rodeo (with_ek_mode; K9 and K11d each with the
// observation functors Gauss and Poisson):
// f(Is<Model>(), Int<Q>()) for the first-order models at q = 3,
// FitzHugh-Nagumo also at q = 4 and 5 (its weight and initial state padded
// with zeros past the third derivative), and the second-order Chkrebtii at
// q = 4 and 5.
template <class Fn>
cudaError_t with_filter_instance(int model, int q, Fn&& f) {
  if (model == Chkrebtii::kNumber)
    return with_value<4, 5>(q, [&](auto qq) { return f(Is<Chkrebtii>(), qq); });
  if (model == FitzHughNagumo::kNumber)
    return with_value<3, 4, 5>(
        q, [&](auto qq) { return f(Is<FitzHughNagumo>(), qq); });
  return with_functor<Lorenz63, Hes1, Seirah>(model, [&](auto m) {
    return with_value<3>(q, [&](auto qq) { return f(m, qq); });
  });
}

// The interrogation modes of the filters that take kramer and rodeo alone:
// f(Int<MODE>()).
template <class Fn>
cudaError_t with_ek_mode(int mode, Fn&& f) {
  return with_value<kKramer, kRodeo>(mode, f);
}

// The tangent directions of fenrir's tangent backward filter K11b
// (fenrir_backward_batch_tan.cu): 1 to kMaxTan, the most parameters of a
// model (Hes1's 7), f(Int<NTAN>()).
constexpr int kMaxTan = 7;
template <class Fn>
cudaError_t with_n_tan(int n_tan, Fn&& f) {
  return with_value<1, 2, 3, 4, 5, 6, 7>(n_tan, f);
}

// The instances of the stationary solve's mean chains (K5a, K5b, K5c,
// mean_chain_single.cu): Lorenz63 and FitzHugh-Nagumo at q = 3,
// f(Is<Model>()).
template <class Fn>
cudaError_t with_mean_instance(int model, Fn&& f) {
  return with_functor<Lorenz63, FitzHughNagumo>(model, f);
}

}  // namespace rodeo
