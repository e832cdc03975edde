// K8: lane-batched forward filter of the DALTON likelihood, summing the
// forecast log-density of the ODE's pseudo-observations and, with WITH_OBS,
// that of the data through a masked scalar observation update after each
// ODE update.  Only the (B,) log-density leaves the kernel.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_dalton.py:
// _dalton_filter_kernel.  Plain PyTorch twin: _dalton_filter_plain in
// ops/fused_dalton.py.
//
// Design.  As K1 (filter_batch.cu), one thread carries one lane through all
// N steps with all NB blocks of its state in registers, because the ODE
// right-hand side couples the blocks; each step is K1's predict, interrogate
// and update without K1's gains (dalton_step of filter_step.cuh, which the
// tangent kernel K11c shares).  The log-density is summed in a register,
// the blocks of a step added in block order as the twin adds them.  The observation grid (N, .., NB) is shared by all lanes
// and comes from cache; nothing is streamed per lane, and one float per lane
// is written at the end.  WITH_OBS is a template parameter, so the launch
// without data carries no observation code.
//
// What bounds it on the card.  A step is ~700 dependent float operations
// per lane and no per-lane memory traffic, so the kernel is bound by the
// latency of each thread's serial chain; B lanes give only B threads (2048
// at the benchmark's width).  Small CTAs (kDaltonThreads) spread the lanes
// over as many SMs as possible; splitting a lane's blocks over threads is
// left to a later change, as for K1.
#include <cstring>

#include <cuda_runtime.h>

#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kDaltonThreads = 32;

template <class Model, int Q, int MODE, bool WITH_OBS>
__global__ void __launch_bounds__(kDaltonThreads)
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
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lane) return;
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t off = lane;

  FilterConsts<Model, Q> c;
  load_consts<Model, Q>(qc, R_in, W_in, tv_in, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k * static_cast<size_t>(n_lane) + off];

  float m[NB][Q], P[NB][NT];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < Q; ++j) m[b][j] = x0[j * col + b * n_lane + off];
#pragma unroll
    for (int k = 0; k < NT; ++k) P[b][k] = 0.0f;
  }
  float ld = ld0[off];

  for (int n = 0; n < n_steps; ++n)
    dalton_step<Model, Q, MODE, WITH_OBS>(c, th, n, tgrid[n], d, y, om, mask,
                                          m, P, ld);
  ld_out[off] = ld;
}

template <class Model, int MODE, bool WITH_OBS>
cudaError_t dalton_launch(const QConst<3>& qc, int n_steps, int n_lane,
                          const float* R, const float* W, const float* tv,
                          const float* x0, const float* theta,
                          const float* tgrid, const float* d, const float* y,
                          const float* om, const float* mask,
                          const float* ld0, float* ld, cudaStream_t stream) {
  const dim3 block(kDaltonThreads);
  const dim3 grid((n_lane + kDaltonThreads - 1) / kDaltonThreads);
  dalton_filter_kernel<Model, 3, MODE, WITH_OBS><<<grid, block, 0, stream>>>(
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
  switch (model * 2 + mode) {
    case 0:
      return dalton_launch_obs<Lorenz63, kKramer>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 1:
      return dalton_launch_obs<Lorenz63, kRodeo>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 2:
      return dalton_launch_obs<FitzHughNagumo, kKramer>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    case 3:
      return dalton_launch_obs<FitzHughNagumo, kRodeo>(
          obs, qc, n_steps, n_lane, r, w, t, x, th, tg, dp, yp, op, mk, l0,
          lp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
