// The C entry points of K3, the single-solve forward filter
// (filter_single.cuh): each picks the instance of (model, mode, q) and calls
// its launch, compiled in filter_instances_*.cu.
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "filter_instances.cuh"

// model, mode and q as rodeo_filter_batch (filter_batch.cu) numbers them,
// the same instances.  q_host points to the q x q scaled transition in host
// memory; every other pointer is device memory laid out as fused_filter
// documents, eps (N, NB, q) read under chkrebtii alone (NULL otherwise).
// Returns a cudaError_t.
extern "C" int rodeo_filter_single(int model, int mode, int q, int n_steps,
                                   const void* q_host, const void* R,
                                   const void* W, const void* tv,
                                   const void* x0, const void* theta,
                                   const void* tgrid, const void* eps,
                                   void* mf, void* pf, void* mp, void* pp,
                                   void* stream) {
  using namespace rodeo;
  if (n_steps < 1) return cudaErrorInvalidValue;
  if (mode == kChkrebtii && eps == nullptr) return cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  const FilterSingleArgs a{n_steps, q_host, in(R), in(W), in(tv),
                           in(x0), in(theta), in(tgrid), in(eps),
                           out(mf), out(pf), out(mp), out(pp)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterSingleInstances<typename decltype(m)::type,
                                 decltype(qq)::value>::launch(mode, a, s);
  });
}

// The launch rodeo_filter_single makes for (model, mode, q) on the current
// device, as nine ints in out (report_geometry in block_step.cuh).
// Returns a cudaError_t.
extern "C" int rodeo_filter_single_geometry(int model, int mode, int q,
                                            void* out) {
  using namespace rodeo;
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return FilterSingleInstances<typename decltype(m)::type,
                                 decltype(qq)::value>::geometry(
        mode, static_cast<int*>(out));
  });
}
