// The instances of the forward filters that take every model, K1
// (filter_batch.cuh) and K3 (filter_single.cuh) under every interrogation
// and the tangent filter K11a (filter_batch_tan.cuh) under kramer and
// rodeo, as their C entry points (filter_batch.cu, filter_single.cu,
// filter_batch_tan.cu) see them: a class per (model, q), whose members
// launch or report the instance of an interrogation mode.  The members are
// defined in the kernels' headers and instantiated in one translation unit
// per (model, q), filter_instances_*.cu (K1, K3) and
// filter_tan_instances_*.cu (K11a), so that nvcc compiles the instances in
// parallel and the entry points' units hold no kernel.
#pragma once

#include <cuda_runtime.h>

namespace rodeo {

// The operands of a launch, as the C entry point received them.
struct FilterBatchArgs {
  int n_steps, n_lane;
  const void* q_host;
  const float *R, *W, *tv, *x0, *theta, *tgrid, *eps;
  float *G, *g, *L, *m_last, *p_last;
};

// K1's instances of Model at Q: launch returns cudaErrorInvalidValue for a
// mode it does not hold; geometry reports the launch as report_geometry
// (block_step.cuh) does.
template <class Model, int Q>
struct FilterBatchInstances {
  static cudaError_t launch(int mode, const FilterBatchArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int mode, int n_lane, int* out);
};

// The operands of a launch, as the C entry point received them.
struct FilterSingleArgs {
  int n_steps;
  const void* q_host;
  const float *R, *W, *tv, *x0, *theta, *tgrid, *eps;
  float *mf, *pf, *mp, *pp;
};

// K3's instances of Model at Q, as FilterBatchInstances.
template <class Model, int Q>
struct FilterSingleInstances {
  static cudaError_t launch(int mode, const FilterSingleArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int mode, int* out);
};

// The operands of a launch of K11a, as the C entry point received them.
struct FilterBatchTanArgs {
  int n_steps, n_lane;
  const void* q_host;
  const float *R, *W, *tv, *x0, *theta, *tgrid;
  float *A, *b, *C, *m_last, *p_last;
};

// K11a's instances of Model at Q, as FilterBatchInstances (kramer and
// rodeo).
template <class Model, int Q>
struct FilterBatchTanInstances {
  static cudaError_t launch(int mode, const FilterBatchTanArgs& a,
                            cudaStream_t stream);
  static cudaError_t geometry(int mode, int n_lane, int* out);
};

}  // namespace rodeo
