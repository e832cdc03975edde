// K11c: the tangent twin of K8.  DALTON's forward filter carries the
// derivative of its state and log-density along each theta direction and
// writes the log-density with its tangents, (NAUG, B), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel_tan.  Plain PyTorch twin: _dalton_filter_tan_plain
// in ops/fused_dalton.py, which runs K8's twin on Duals (ops/dual.py).
//
// Design.  K8's step (dalton_step of filter_step.cuh) instantiated on the
// forward-mode number Dual (dual.cuh), as K11a does with K1: one thread per
// (lane, direction), theta seeded along the thread's direction, the initial
// state exact (zero tangent), the seed log-density's tangent read from ld0.
// The values are K8's bitwise; the thread of direction 0 stores them.  A CTA
// holds kTanLanes lanes x NTHETA directions, NTHETA times K8's threads.
// WITH_OBS is a template parameter as in K8.
//
// What bounds it on the card.  Nothing is streamed per lane; a step is K8's
// serial chain of float operations and its tangent (about three times as
// many, counted from the twin by chip_smoke.py), so the kernel is bound by
// the latency of each thread's chain, as K8 is.
#include <cstring>

#include <cuda_runtime.h>

#include "dual.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kTanLanes = 32;

template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kTanLanes * Model::NTHETA)
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
  const int lane = blockIdx.x * kTanLanes + threadIdx.x;
  const int dir = threadIdx.y;
  if (lane >= n_lane) return;
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t off = lane;

  FilterConsts<Model, Q> c;
  load_consts<Model, Q>(qc, R_in, W_in, tv_in, c);
  Dual th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k)
    th[k] = Dual(theta[k * static_cast<size_t>(n_lane) + off], k == dir ? 1.0f : 0.0f);

  Dual m[NB][Q], P[NB][NT];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < Q; ++j) m[b][j] = Dual(x0[j * col + b * n_lane + off]);
#pragma unroll
    for (int k = 0; k < NT; ++k) P[b][k] = Dual(0.0f);
  }
  Dual ld(ld0[off], ld0[(1 + dir) * static_cast<size_t>(n_lane) + off]);

  for (int n = 0; n < n_steps; ++n)
    dalton_step<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], d, y, om, mask,
                                          m, P, ld);
  store_aug(ld_out, 0, 1, NAUG, 0, n_lane, off, dir, ld);
}

template <class Model, int MODE, bool WITH_OBS>
cudaError_t dalton_tan_launch(const QConst<3>& qc, int n_steps, int n_lane,
                              const float* R, const float* W,
                              const float* tv, const float* x0,
                              const float* theta, const float* tgrid,
                              const float* d, const float* y, const float* om,
                              const float* mask, const float* ld0, float* ld,
                              cudaStream_t stream) {
  const dim3 block(kTanLanes, Model::NTHETA);
  const dim3 grid((n_lane + kTanLanes - 1) / kTanLanes);
  dalton_filter_tan_kernel<Model, 3, MODE, WITH_OBS><<<grid, block, 0, stream>>>(
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
  switch (model * 2 + mode) {
    case 0:
      return dalton_tan_launch_obs<Lorenz63, kKramer>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 1:
      return dalton_tan_launch_obs<Lorenz63, kRodeo>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 2:
      return dalton_tan_launch_obs<FitzHughNagumo, kKramer>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 3:
      return dalton_tan_launch_obs<FitzHughNagumo, kRodeo>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
