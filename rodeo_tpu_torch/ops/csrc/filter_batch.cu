// The C entry points of K1, the lane-batched forward filter
// (filter_batch.cuh): each picks the instance of (model, mode, q) and calls
// its launch, compiled in filter_instances_*.cu.
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "filter_instances.cuh"

// model: 0 Lorenz63, 1 FitzHughNagumo, 2 Chkrebtii, 3 Hes1, 4 Seirah; mode:
// 0 kramer, 1 rodeo, 2 schober, 3 chkrebtii (the numbering of _FUNCTORS and
// _MODES in ops/fused_kalman.py); q the derivatives per block: the instances
// of with_filter_instance and with_mode (dispatch.cuh), any other (model,
// mode, q) returning cudaErrorInvalidValue.  q_host points to the q x q
// scaled transition in host memory; every other pointer is device memory
// laid out as fused_filter_batch documents, eps (N, q, NB, B) read under
// chkrebtii alone (NULL otherwise).  Returns a cudaError_t.
extern "C" int rodeo_filter_batch(int model, int mode, int q, int n_steps,
                                  int n_lane, const void* q_host,
                                  const void* R, const void* W, const void* tv,
                                  const void* x0, const void* theta,
                                  const void* tgrid, const void* eps,
                                  void* G, void* g, void* L, void* m_last,
                                  void* p_last, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  if (mode == kChkrebtii && eps == nullptr) return cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  const FilterBatchArgs a{n_steps, n_lane, q_host, in(R), in(W), in(tv),
                          in(x0), in(theta), in(tgrid), in(eps), out(G),
                          out(g), out(L), out(m_last), out(p_last)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterBatchInstances<typename decltype(m)::type,
                                decltype(qq)::value>::launch(mode, a, s);
  });
}

// The launch rodeo_filter_batch makes for (model, mode, q, n_lane) on the
// current device, as nine ints in out (report_geometry in block_step.cuh).
// Returns a cudaError_t.
extern "C" int rodeo_filter_batch_geometry(int model, int mode, int q,
                                           int n_lane, void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterBatchInstances<typename decltype(m)::type,
                                decltype(qq)::value>::geometry(
        mode, n_lane, static_cast<int*>(out));
  });
}

extern "C" const char* rodeo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
