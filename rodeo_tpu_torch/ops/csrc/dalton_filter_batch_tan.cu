// The C entry points of K11c, the tangent twin of K8
// (dalton_filter_batch_tan.cuh): each picks the instance of (model, mode,
// q) and calls its launch, compiled in dalton_tan_instances_*.cu.
#include <cuda_runtime.h>

#include "dalton_instances.cuh"
#include "dispatch.cuh"

// The arguments of rodeo_dalton_filter_batch (dalton_filter_batch.cu), the
// instances of with_filter_instance (dispatch.cuh) under kramer and rodeo
// (any other (model, mode, q) returning cudaErrorInvalidValue), with the
// seed ld0 and the result ld augmented, (NAUG, B): the values, then the
// tangent of each of the model's NTHETA directions.  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch_tan(
    int model, int mode, int q, int with_obs, int n_steps, int n_lane,
    const void* q_host, const void* R, const void* W, const void* tv,
    const void* x0, const void* theta, const void* tgrid, const void* d,
    const void* y, const void* om, const void* mask, const void* ld0,
    void* ld, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  const DaltonFilterArgs a{n_steps,   n_lane,  q_host,    in(R),   in(W),
                           in(tv),    in(x0),  in(theta), in(tgrid),
                           in(d),     in(y),   in(om),    in(mask), in(ld0),
                           static_cast<float*>(ld)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return DaltonFilterTanInstances<typename decltype(m)::type,
                                    decltype(qq)::value>::launch(mode,
                                                                 with_obs != 0,
                                                                 a, s);
  });
}

// The launch rodeo_dalton_filter_batch_tan makes for (model, mode, q,
// with_obs, n_lane) on the current device, as nine ints in out
// (report_geometry in block_step.cuh).  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch_tan_geometry(int model, int mode,
                                                      int q, int with_obs,
                                                      int n_lane, void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return DaltonFilterTanInstances<typename decltype(m)::type,
                                    decltype(qq)::value>::geometry(
        mode, with_obs != 0, n_lane, static_cast<int*>(out));
  });
}
