// The C entry points of K11a, the tangent twin of K1
// (filter_batch_tan.cuh): each picks the instance of (model, mode, q) and
// calls its launch, compiled in filter_tan_instances_*.cu.
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "filter_instances.cuh"

// The arguments of rodeo_filter_batch (filter_batch.cu) without eps, the
// instances of with_filter_instance (dispatch.cuh) under kramer and rodeo
// (any other (model, mode, q) returning cudaErrorInvalidValue), with the
// augmented outputs A, b, C, m_last, p_last laid out as
// fused_filter_batch_tan (ops/fused_kalman.py) documents; NTHETA tangent
// directions, one per parameter of the model.  Returns a cudaError_t.
extern "C" int rodeo_filter_batch_tan(int model, int mode, int q,
                                      int n_steps, int n_lane,
                                      const void* q_host, const void* R,
                                      const void* W, const void* tv,
                                      const void* x0, const void* theta,
                                      const void* tgrid, void* A, void* b,
                                      void* C, void* m_last, void* p_last,
                                      void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  const FilterBatchTanArgs a{n_steps, n_lane, q_host, in(R), in(W), in(tv),
                             in(x0), in(theta), in(tgrid), out(A), out(b),
                             out(C), out(m_last), out(p_last)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterBatchTanInstances<typename decltype(m)::type,
                                   decltype(qq)::value>::launch(mode, a, s);
  });
}

// The launch rodeo_filter_batch_tan makes for (model, mode, q, n_lane) on
// the current device, as nine ints in out (report_geometry in
// block_step.cuh).  Returns a cudaError_t.
extern "C" int rodeo_filter_batch_tan_geometry(int model, int mode, int q,
                                               int n_lane, void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterBatchTanInstances<typename decltype(m)::type,
                                   decltype(qq)::value>::geometry(
        mode, n_lane, static_cast<int*>(out));
  });
}
