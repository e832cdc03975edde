// Observation models of non-Gaussian DALTON as device functors, for the
// Laplace-linearised filters K9 (filter_nn_batch.cuh) and K11d
// (filter_nn_batch_tan.cuh).
//
// A functor has one static device function, the log-likelihood
// contribution of one observed state component:
//   f(y, x, j, th, iobs, pars) -> J
// with y the block's data (n_ydim = 1), x the component j of the block's
// predicted state in original coordinates as a number of type J (a Jet2,
// jet.cuh, so that the kernel reads the gradient and the Hessian off the
// result), th the lane's parameters (float or Dual, the kernel's scalar
// type), iobs the observation's index and pars the float32 parameters of
// the model.  It gives the value only; the derivatives are the Jet2's.
// Each does the arithmetic of its *_comp_flat counterpart in
// rodeo_tpu_torch/models/obs.py, in the same order.  th and iobs are kept
// so that a model that depends on them can be added.
#pragma once

#include <cuda_runtime.h>

#include "jet.cuh"

namespace rodeo {

constexpr int kObsPars = 2;  // parameters per observation model, at most

struct ObsPars {
  float p[kObsPars];
};

// rodeo_tpu_torch/models/obs.py: gauss_comp_flat, -0.5 (y - x)^2 / var as
// a product with pars.p[0] = 1 / var
struct Gauss {
  static constexpr int kNumber = 0;  // _OBS_FUNCTORS in ops/fused_daltonng.py
  template <class J, class S, int NTH>
  __device__ __forceinline__ static J f(float y, const J& x, int j,
                                        const S (&th)[NTH], float iobs,
                                        const ObsPars& pars) {
    const J r = y - x;
    return -0.5f * (r * r) * pars.p[0];
  }
};

// rodeo_tpu_torch/models/obs.py: poisson_comp_flat,
// y (b0 + b1 x) - exp(b0 + b1 x)
struct Poisson {
  static constexpr int kNumber = 1;
  template <class J, class S, int NTH>
  __device__ __forceinline__ static J f(float y, const J& x, int j,
                                        const S (&th)[NTH], float iobs,
                                        const ObsPars& pars) {
    const J loglam = pars.p[0] + pars.p[1] * x;
    return loglam * y - exp_of(loglam);
  }
};

}  // namespace rodeo
