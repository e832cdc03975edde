// The instances of non-Gaussian DALTON's Laplace filter K9
// (filter_nn_batch.cuh) and of its tangent twin K11d
// (filter_nn_batch_tan.cuh), as their C entry points (filter_nn_batch.cu,
// filter_nn_batch_tan.cu) see them: a class per (model, q), whose members
// launch or report the instance of an observation functor
// (obs_models.cuh's Gauss and Poisson) and an interrogation mode (kramer
// and rodeo).  The members are defined in the kernels' headers and
// instantiated in one translation unit per (model, q),
// filter_nn_instances_*.cu (K9) and filter_nn_tan_instances_*.cu (K11d), so
// that nvcc compiles the instances in parallel and the entry points' units
// hold no kernel.
#pragma once

#include <cuda_runtime.h>

namespace rodeo {

// The operands of a launch, as the C entry point received them (K11d's
// outputs augmented on the d axis, NAUG = 1 + NTHETA).
struct NnFilterArgs {
  int obs_dims, n_steps, n_lane;
  const void *q_host, *pars_host;
  const float *R, *W, *tv, *x0, *theta, *tgrid, *y, *iobs, *mask;
  float *mf, *pf, *mp, *pp;
};

// K9's instances of Model at Q: launch returns cudaErrorInvalidValue for an
// observation functor or a mode it does not hold; geometry reports the
// launch as report_geometry (block_step.cuh) does.
template <class Model, int Q>
struct NnFilterInstances {
  static cudaError_t launch(int obs_model, int mode, const NnFilterArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int obs_model, int mode, int n_lane, int* out);
};

// K11d's instances of Model at Q, as NnFilterInstances.
template <class Model, int Q>
struct NnFilterTanInstances {
  static cudaError_t launch(int obs_model, int mode, const NnFilterArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int obs_model, int mode, int n_lane, int* out);
};

}  // namespace rodeo
