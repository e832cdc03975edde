// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) and of its
// tangent twin K11c (dalton_filter_batch_tan.cuh), as their C entry points
// (dalton_filter_batch.cu, dalton_filter_batch_tan.cu) see them: a class per
// (model, q), whose members launch or report the instance of an
// interrogation mode and of with_obs.  The members are defined in the
// kernels' headers and instantiated in one translation unit per (model, q),
// dalton_instances_*.cu (K8) and dalton_tan_instances_*.cu (K11c), so that
// nvcc compiles the instances in parallel and the entry points' units hold
// no kernel.
#pragma once

#include <cuda_runtime.h>

namespace rodeo {

// The operands of a launch, as the C entry point received them (K11c's ld0
// and ld augmented, (1 + NTHETA, B)).
struct DaltonFilterArgs {
  int n_steps, n_lane;
  const void* q_host;
  const float *R, *W, *tv, *x0, *theta, *tgrid, *d, *y, *om, *mask, *ld0;
  float* ld;
};

// K8's instances of Model at Q: launch returns cudaErrorInvalidValue for a
// mode it does not hold; geometry reports the launch as report_geometry
// (block_step.cuh) does.
template <class Model, int Q>
struct DaltonFilterInstances {
  static cudaError_t launch(int mode, bool with_obs,
                            const DaltonFilterArgs& a, cudaStream_t stream);
  static cudaError_t geometry(int mode, bool with_obs, int n_lane, int* out);
};

// K11c's instances of Model at Q, as DaltonFilterInstances.
template <class Model, int Q>
struct DaltonFilterTanInstances {
  static cudaError_t launch(int mode, bool with_obs,
                            const DaltonFilterArgs& a, cudaStream_t stream);
  static cudaError_t geometry(int mode, bool with_obs, int n_lane, int* out);
};

}  // namespace rodeo
