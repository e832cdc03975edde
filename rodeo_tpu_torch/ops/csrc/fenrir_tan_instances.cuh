// The instances of fenrir's tangent backward filter K11b
// (fenrir_backward_batch_tan.cuh) as its C entry points
// (fenrir_backward_batch_tan.cu) see them: a class per q, whose members
// launch or report the instance of a number of directions and a row
// alignment.  The members are defined in the kernel's header and
// instantiated in one translation unit per q, fenrir_tan_instances_q*.cu,
// so that nvcc compiles them in parallel.
#pragma once

#include <cuda_runtime.h>

#include "dispatch.cuh"

namespace rodeo {

// The operands of a launch, as the C entry point received them.
struct FenrirTanArgs {
  int n_steps, n_block, n_lane;
  const float *A, *b, *C, *d, *y, *om, *mask, *m_seed, *p_seed;
  float* ld_blocks;
};

// K11b's instances at Q: launch returns cudaErrorInvalidValue for a number
// of directions it does not hold; vec picks the 16-byte copies (rows
// 16-byte aligned).  geometry reports the launch as report_geometry
// (block_step.cuh) does, then the ring's stages and the steps a stage
// holds.
template <int Q>
struct FenrirTanInstances {
  static cudaError_t launch(int n_tan, bool vec, const FenrirTanArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int n_tan, int n_col, bool vec, int* out);
};

}  // namespace rodeo
