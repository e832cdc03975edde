// K8: lane-batched forward filter of the DALTON likelihood, summing the
// forecast log-density of the ODE's pseudo-observations and, with WITH_OBS,
// that of the data through a masked scalar observation update after each
// ODE update.  Only the (B,) log-density leaves the kernel.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel.  Plain PyTorch twin: _dalton_filter_plain in
// ops/fused_dalton.py.
//
// Design.  As K1 (filter_batch.cu), one thread per (lane, block), the
// threads of a lane meeting once a step in shared memory (block_step.cuh),
// because the ODE right-hand side couples the blocks; each step is K1's
// predict, interrogate and update without K1's gains
// (dalton_update_block).  Each thread leaves its block's log-density terms
// in shared memory, and the thread of block 0 adds them in block order as
// the twin adds them, one step late, after the next step's barrier
// (add_step_terms; the terms are double buffered), and holds ld.  With
// WITH_OBS each thread runs its block's masked observation update at a step
// with data and skips it at a step without (mask 0), where it is an exact
// identity; the twin skips it too.  The observation grid (N, .., NB) is
// shared by all lanes and comes from cache; nothing is streamed per lane,
// and one float per lane is written at the end.  WITH_OBS is a template
// parameter, so the launch without data carries no observation code.  The
// tangent kernel K11c runs the same step on Dual numbers.
//
// What bounds it on the card.  Nothing is streamed per lane; a step is a
// chain of dependent float operations on one block, with the ODE at the
// gathered means, so the kernel is bound by the latency of that chain.  At
// 2048 lanes Lorenz63 runs 64 CTAs of 32 x 3 = 96 threads, one on each of
// 64 of the card's 132 SMs; 128 CTAs of 16 lanes were slower.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 on the card (PERF.md)
constexpr int kDaltonLanes = 32;

// At 2048 lanes the launch has 64 CTAs, fewer than the SMs, so an SM never
// holds a second one: the launch bounds ask for one CTA per SM, and ptxas
// spends registers on the chain instead of spilling to fit more CTAs.
template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kDaltonLanes * Model::NB, 1)
    dalton_filter_kernel(QConst<Q> qc, int n_steps, int n_lane,
                         const float* __restrict__ R_in,
                         const float* __restrict__ W_in,
                         const float* __restrict__ tv_in,
                         const float* __restrict__ x0,
                         const float* __restrict__ theta,
                         const float* __restrict__ tgrid,
                         const float* __restrict__ d,
                         const float* __restrict__ y,
                         const float* __restrict__ om,
                         const float* __restrict__ mask,
                         const float* __restrict__ ld0,
                         float* __restrict__ ld_out) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  __shared__ SharedMeans<float, NB, Q, kDaltonLanes> xs;
  // each block's terms of a step: the ODE's and the data's
  __shared__ StepTerms<float, NB, kDaltonLanes> ode_terms, obs_terms;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int lane = blockIdx.x * kDaltonLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no store
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  const size_t col = static_cast<size_t>(NB) * n_lane;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k * static_cast<size_t>(n_lane) + off];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[j * col + b * static_cast<size_t>(n_lane) + off];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;
  float ld = ld0[off];

  for (int n = 0; n < n_steps; ++n) {
    float mp[Q], pp[NT];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    publish_mean<NB, Q>(xs, n, b, tx, mp, c.tv);
    __syncthreads();
    if (b == 0 && n > 0)
      ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n - 1, tx, mask);
    float x[NB][Q];
    gather_means<NB, Q>(xs, n, tx, x);
    dalton_update_block<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], x, b,
                                                  tx, mp, pp, d, y, om, mask,
                                                  m, P, ode_terms, obs_terms);
  }
  __syncthreads();
  if (b == 0) {
    ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n_steps - 1, tx, mask);
    if (live) ld_out[off] = ld;
  }
}

template <class Model, int MODE, bool WITH_OBS>
cudaError_t dalton_launch(const QConst<3>& qc, int n_steps, int n_lane,
                          const float* R, const float* W, const float* tv,
                          const float* x0, const float* theta,
                          const float* tgrid, const float* d, const float* y,
                          const float* om, const float* mask,
                          const float* ld0, float* ld, cudaStream_t stream) {
  const SplitGeometry g = split_geometry<Model, kDaltonLanes>(n_lane, 1);
  dalton_filter_kernel<Model, 3, MODE, WITH_OBS><<<g.grid, g.block, 0,
                                                   stream>>>(
      qc, n_steps, n_lane, R, W, tv, x0, theta, tgrid, d, y, om, mask, ld0,
      ld);
  return cudaGetLastError();
}

template <class Model, int MODE>
cudaError_t dalton_launch_obs(bool with_obs, const QConst<3>& qc,
                              int n_steps, int n_lane, const float* R,
                              const float* W, const float* tv,
                              const float* x0, const float* theta,
                              const float* tgrid, const float* d,
                              const float* y, const float* om,
                              const float* mask, const float* ld0, float* ld,
                              cudaStream_t stream) {
  if (with_obs)
    return dalton_launch<Model, MODE, true>(qc, n_steps, n_lane, R, W, tv,
                                            x0, theta, tgrid, d, y, om, mask,
                                            ld0, ld, stream);
  return dalton_launch<Model, MODE, false>(qc, n_steps, n_lane, R, W, tv, x0,
                                           theta, tgrid, d, y, om, mask, ld0,
                                           ld, stream);
}

template <class Model, int MODE>
cudaError_t dalton_geometry(bool with_obs, int n_lane, int* out) {
  const SplitGeometry g = split_geometry<Model, kDaltonLanes>(n_lane, 1);
  if (with_obs)
    return report_geometry(dalton_filter_kernel<Model, 3, MODE, true>, g, out);
  return report_geometry(dalton_filter_kernel<Model, 3, MODE, false>, g, out);
}

}  // namespace rodeo

// model: 0 Lorenz63, 1 FitzHughNagumo; mode: 0 kramer, 1 rodeo (the
// numbering of _FUNCTORS and _MODES in ops/fused_kalman.py); with_obs: 0 or
// 1.  q_host points to the 3 x 3 scaled transition in host memory; every
// other pointer is device memory laid out as dalton_filter_batch
// (ops/fused_dalton.py) documents.  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch(
    int model, int mode, int with_obs, int n_steps, int n_lane,
    const void* q_host, const void* R, const void* W, const void* tv,
    const void* x0, const void* theta, const void* tgrid, const void* d,
    const void* y, const void* om, const void* mask, const void* ld0,
    void* ld, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  const auto* r = static_cast<const float*>(R);
  const auto* w = static_cast<const float*>(W);
  const auto* t = static_cast<const float*>(tv);
  const auto* x = static_cast<const float*>(x0);
  const auto* th = static_cast<const float*>(theta);
  const auto* tg = static_cast<const float*>(tgrid);
  const auto* dp = static_cast<const float*>(d);
  const auto* yp = static_cast<const float*>(y);
  const auto* op = static_cast<const float*>(om);
  const auto* mk = static_cast<const float*>(mask);
  const auto* l0 = static_cast<const float*>(ld0);
  auto* lp = static_cast<float*>(ld);
  auto s = static_cast<cudaStream_t>(stream);
  const bool obs = with_obs != 0;
  return with_ek_instance(model, mode, [&](auto m, auto md) {
    using Model = typename decltype(m)::type;
    return dalton_launch_obs<Model, decltype(md)::value>(
        obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk,
        l0, lp, s);
  });
}

// The launch rodeo_dalton_filter_batch makes for (model, mode, with_obs,
// n_lane) on the current device, as nine ints in out (report_geometry in
// block_step.cuh).  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch_geometry(int model, int mode,
                                                  int with_obs, int n_lane,
                                                  void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const bool obs = with_obs != 0;
  return with_ek_instance(model, mode, [&](auto m, auto md) {
    using Model = typename decltype(m)::type;
    return dalton_geometry<Model, decltype(md)::value>(
        obs, n_lane, o);
  });
}
