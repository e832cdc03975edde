// K11c: the tangent twin of K8.  DALTON's forward filter carries the
// derivative of its state and log-density along each theta direction and
// writes the log-density with its tangents, (NAUG, B), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel_tan.  Plain PyTorch twin: _dalton_filter_tan_plain
// in ops/fused_dalton.py, which runs K8's twin on Duals (ops/dual.py).
//
// Design.  K8's step on the forward-mode number Dual (dual.cuh), theta
// seeded along the thread's direction, the initial state exact (zero
// tangent), the seed log-density's tangent read from ld0, split over the
// blocks of a lane as K8 is (block_step.cuh), with a grid row per
// direction: one thread per (lane, direction, block) predicts, interrogates
// and updates its block, and with WITH_OBS runs its block's masked
// observation update at a step with data (dalton_update_block).  Each
// thread leaves its block's log-density terms in shared memory; the thread
// of block 0 adds them in block order, one step late, after the next
// step's barrier (add_step_terms; the terms are double buffered), and
// holds ld.  The values are K8's bitwise; the threads of direction 0 store
// them.
//
// What bounds it on the card.  Nothing is streamed per lane; a step is K8's
// chain of float operations on one block and its tangent, with the ODE at
// the gathered means, so the kernel is bound by the latency of that chain.
// At 2048 lanes Lorenz63 runs grid (64, 3) = 192 CTAs of 32 x 3 = 96
// threads, every CTA resident at once and every SM with one or two.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "dispatch.cuh"
#include "dual.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 32, faster than 16 on the card (PERF.md)
constexpr int kDaltonTanLanes = 32;

template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kDaltonTanLanes * Model::NB)
    dalton_filter_tan_kernel(QConst<Q> qc, int n_steps, int n_lane,
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
  constexpr int NAUG = 1 + NTH;
  __shared__ SharedMeans<Dual, NB, Q, kDaltonTanLanes> xs;
  // each block's terms of a step: the ODE's and the data's
  __shared__ StepTerms<Dual, NB, kDaltonTanLanes> ode_terms, obs_terms;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int dir = blockIdx.y;
  const int lane = blockIdx.x * kDaltonTanLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no store
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  const size_t col = static_cast<size_t>(NB) * n_lane;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  Dual th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k)
    th[k] = Dual(theta[k * static_cast<size_t>(n_lane) + off], k == dir ? 1.0f : 0.0f);

  Dual m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = Dual(x0[j * col + b * static_cast<size_t>(n_lane) + off]);
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = Dual(0.0f);
  Dual ld(ld0[off], ld0[(1 + dir) * static_cast<size_t>(n_lane) + off]);

  for (int n = 0; n < n_steps; ++n) {
    Dual mp[Q], pp[NT];
    predict_block<Q>(c.Qm, c.R, m, P, mp, pp);
    publish_mean<NB, Q>(xs, n, b, tx, mp, c.tv);
    __syncthreads();
    if (b == 0 && n > 0)
      ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n - 1, tx, mask);
    Dual x[NB][Q];
    gather_means<NB, Q>(xs, n, tx, x);
    dalton_update_block<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], x, b,
                                                  tx, mp, pp, d, y, om, mask,
                                                  m, P, ode_terms, obs_terms);
  }
  __syncthreads();
  if (b == 0) {
    ld = add_step_terms<NB, WITH_OBS>(ld, ode_terms, obs_terms, n_steps - 1, tx, mask);
    if (live) store_aug(ld_out, 0, 1, NAUG, 0, n_lane, off, dir, ld);
  }
}

template <class Model, int MODE, bool WITH_OBS>
cudaError_t dalton_tan_launch(const QConst<3>& qc, int n_steps, int n_lane,
                              const float* R, const float* W,
                              const float* tv, const float* x0,
                              const float* theta, const float* tgrid,
                              const float* d, const float* y, const float* om,
                              const float* mask, const float* ld0, float* ld,
                              cudaStream_t stream) {
  const SplitGeometry g =
      split_geometry<Model, kDaltonTanLanes>(n_lane, Model::NTHETA);
  dalton_filter_tan_kernel<Model, 3, MODE, WITH_OBS><<<g.grid, g.block, 0,
                                                       stream>>>(
      qc, n_steps, n_lane, R, W, tv, x0, theta, tgrid, d, y, om, mask, ld0,
      ld);
  return cudaGetLastError();
}

template <class Model, int MODE>
cudaError_t dalton_tan_launch_obs(bool with_obs, const QConst<3>& qc,
                                  int n_steps, int n_lane, const float* R,
                                  const float* W, const float* tv,
                                  const float* x0, const float* theta,
                                  const float* tgrid, const float* d,
                                  const float* y, const float* om,
                                  const float* mask, const float* ld0,
                                  float* ld, cudaStream_t stream) {
  if (with_obs)
    return dalton_tan_launch<Model, MODE, true>(qc, n_steps, n_lane, R, W, tv,
                                                x0, theta, tgrid, d, y, om,
                                                mask, ld0, ld, stream);
  return dalton_tan_launch<Model, MODE, false>(qc, n_steps, n_lane, R, W, tv,
                                               x0, theta, tgrid, d, y, om,
                                               mask, ld0, ld, stream);
}

template <class Model, int MODE>
cudaError_t dalton_tan_geometry(bool with_obs, int n_lane, int* out) {
  const SplitGeometry g =
      split_geometry<Model, kDaltonTanLanes>(n_lane, Model::NTHETA);
  if (with_obs)
    return report_geometry(dalton_filter_tan_kernel<Model, 3, MODE, true>, g,
                           out);
  return report_geometry(dalton_filter_tan_kernel<Model, 3, MODE, false>, g,
                         out);
}

}  // namespace rodeo

// The arguments of rodeo_dalton_filter_batch (dalton_filter_batch.cu), with
// the seed ld0 and the result ld augmented, (NAUG, B): the values, then the
// tangent of each of the model's NTHETA directions.  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch_tan(
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
    return dalton_tan_launch_obs<Model, decltype(md)::value>(
        obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk,
        l0, lp, s);
  });
}

// The launch rodeo_dalton_filter_batch_tan makes for (model, mode,
// with_obs, n_lane) on the current device, as nine ints in out
// (report_geometry in block_step.cuh).  Returns a cudaError_t.
extern "C" int rodeo_dalton_filter_batch_tan_geometry(int model, int mode,
                                                      int with_obs,
                                                      int n_lane, void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  const bool obs = with_obs != 0;
  return with_ek_instance(model, mode, [&](auto m, auto md) {
    using Model = typename decltype(m)::type;
    return dalton_tan_geometry<Model, decltype(md)::value>(
        obs, n_lane, o);
  });
}
