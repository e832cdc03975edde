// The instances of DALTON's filter K8 (dalton_filter_batch.cuh), as its C
// entry points (dalton_filter_batch.cu) see them: a class per (model, q),
// whose members launch or report the instance of an interrogation mode and
// of with_obs.  The members are defined in the kernel's header and
// instantiated in one translation unit per (model, q),
// dalton_instances_*.cu, so that nvcc compiles the instances in parallel
// and the entry points' unit holds no kernel.
#pragma once

#include <cuda_runtime.h>

namespace rodeo {

// The operands of a launch, as the C entry point received them.
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

}  // namespace rodeo
