// The C entry points of K11d, the tangent twin of K9
// (filter_nn_batch_tan.cuh): each picks the instance of (model, q) and
// calls its launch, compiled in filter_nn_tan_instances_*.cu, which picks
// the observation functor and the mode.
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "filter_nn_instances.cuh"

// The arguments of rodeo_filter_nn_batch (filter_nn_batch.cu), with the
// augmented outputs mf, pf, mp, pp laid out as filter_nn_batch_tan
// (ops/fused_daltonng.py) documents; NTHETA tangent directions, one per
// parameter of the model.  Returns a cudaError_t.
extern "C" int rodeo_filter_nn_batch_tan(int model, int obs_model, int mode,
                                         int q, int obs_dims, int n_steps,
                                         int n_lane, const void* q_host,
                                         const void* pars_host, const void* R,
                                         const void* W, const void* tv,
                                         const void* x0, const void* theta,
                                         const void* tgrid, const void* y,
                                         const void* iobs, const void* mask,
                                         void* mf, void* pf, void* mp,
                                         void* pp, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  const NnFilterArgs a{obs_dims,  n_steps,  n_lane,   q_host,   pars_host,
                       in(R),     in(W),    in(tv),   in(x0),   in(theta),
                       in(tgrid), in(y),    in(iobs), in(mask), out(mf),
                       out(pf),   out(mp),  out(pp)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return NnFilterTanInstances<typename decltype(m)::type,
                                decltype(qq)::value>::launch(obs_model, mode,
                                                             a, s);
  });
}

// The launch rodeo_filter_nn_batch_tan makes for (model, obs_model, mode,
// q, n_lane) on the current device, as nine ints in out (report_geometry
// in block_step.cuh).  Returns a cudaError_t.
extern "C" int rodeo_filter_nn_batch_tan_geometry(int model, int obs_model,
                                                  int mode, int q, int n_lane,
                                                  void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  return with_filter_instance(model, q, [&](auto m, auto qq) {
    return NnFilterTanInstances<typename decltype(m)::type,
                                decltype(qq)::value>::geometry(
        obs_model, mode, n_lane, static_cast<int*>(out));
  });
}
