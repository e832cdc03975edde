// K9: the Laplace-linearised forward filter of non-Gaussian DALTON,
// lane-batched, storing the filtered and predicted moments of every step.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_daltonng.py:
// _filter_nn_kernel_batch (interrogations kramer and rodeo).
// Plain PyTorch twin: _filter_nn_batch_plain in ops/fused_daltonng.py.
//
// Design.  One thread carries one lane (one parameter candidate) through
// all N steps in a single launch, with all NB blocks of its state in
// registers (K1 ran so before it was split over the blocks of a lane).  A
// step is K1's predict and ODE update (filter_step.cuh's
// interrogate_update, whose loop body K1 runs per block), then,
// at a step with data, one masked scalar pseudo-observation update per
// observed component and block: the user's observation log-likelihood,
// compiled in as a functor (obs_models.cuh), linearised at the predicted
// mean in original coordinates by evaluating it on a second-order forward
// number (jet.cuh) -- the nested jax.jvp of the TPU kernel.  The TPU kernel
// runs the masked update at every step; this one skips it where the mask
// is 0, where it is an exact identity, and so does its twin.  Outputs are
// laid out (N, d, NB, B) with lanes innermost: mf (N, Q, ..), pf (N, Tri,
// ..), mp (N, Q, ..), pp (N, Tri, ..), the four streams the smoothing
// passes read.  Float32 throughout.
//
// What bounds it on the card.  A step is ~1e3 dependent float operations
// per lane against 18 floats stored per block, as in K1: 1.77 GB at 4000
// steps x 3 blocks x 2048 lanes, 0.53 ms at 3.35 TB/s, far below the
// latency of each thread's serial chain.  B lanes give B threads, so the
// design takes small CTAs to spread the lanes over the SMs.
#include <cstring>

#include <cuda_runtime.h>

#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"
#include "obs_models.cuh"

namespace rodeo {

constexpr int kNnThreads = 32;

template <class Model, class Obs, int Q, int MODE>
__global__ void __launch_bounds__(kNnThreads)
    filter_nn_batch_kernel(QConst<Q> qc, ObsPars pars, int obs_dims,
                           int n_steps, int n_lane,
                           const float* __restrict__ R_in,
                           const float* __restrict__ W_in,
                           const float* __restrict__ tv_in,
                           const float* __restrict__ x0,
                           const float* __restrict__ theta,
                           const float* __restrict__ tgrid,
                           const float* __restrict__ y,
                           const float* __restrict__ iobs,
                           const float* __restrict__ mask,
                           float* __restrict__ mf_out,
                           float* __restrict__ pf_out,
                           float* __restrict__ mp_out,
                           float* __restrict__ pp_out) {
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

  for (int n = 0; n < n_steps; ++n) {
    float mp[NB][Q], pp[NB][NT];
    filter_nn_step<Model, Obs, Q, MODE>(c, th, n, tgrid[n], obs_dims, pars, y,
                                        iobs, mask, m, P, mp, pp);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        mf_out[(static_cast<size_t>(n) * Q + i) * col + base] = m[b][i];
        mp_out[(static_cast<size_t>(n) * Q + i) * col + base] = mp[b][i];
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        pf_out[(static_cast<size_t>(n) * NT + k) * col + base] = P[b][k];
        pp_out[(static_cast<size_t>(n) * NT + k) * col + base] = pp[b][k];
      }
    }
  }
}

template <class Model, class Obs, int MODE>
cudaError_t nn_launch(const QConst<3>& qc, const ObsPars& pars, int obs_dims,
                      int n_steps, int n_lane, const float* R, const float* W,
                      const float* tv, const float* x0, const float* theta,
                      const float* tgrid, const float* y, const float* iobs,
                      const float* mask, float* mf, float* pf, float* mp,
                      float* pp, cudaStream_t stream) {
  const dim3 block(kNnThreads);
  const dim3 grid((n_lane + kNnThreads - 1) / kNnThreads);
  filter_nn_batch_kernel<Model, Obs, 3, MODE><<<grid, block, 0, stream>>>(
      qc, pars, obs_dims, n_steps, n_lane, R, W, tv, x0, theta, tgrid, y,
      iobs, mask, mf, pf, mp, pp);
  return cudaGetLastError();
}

template <class Model, class Obs>
cudaError_t nn_launch_mode(int mode, const QConst<3>& qc, const ObsPars& pars,
                           int obs_dims, int n_steps, int n_lane,
                           const float* R, const float* W, const float* tv,
                           const float* x0, const float* theta,
                           const float* tgrid, const float* y,
                           const float* iobs, const float* mask, float* mf,
                           float* pf, float* mp, float* pp,
                           cudaStream_t stream) {
  if (mode == kKramer)
    return nn_launch<Model, Obs, kKramer>(qc, pars, obs_dims, n_steps, n_lane,
                                          R, W, tv, x0, theta, tgrid, y, iobs,
                                          mask, mf, pf, mp, pp, stream);
  if (mode == kRodeo)
    return nn_launch<Model, Obs, kRodeo>(qc, pars, obs_dims, n_steps, n_lane,
                                         R, W, tv, x0, theta, tgrid, y, iobs,
                                         mask, mf, pf, mp, pp, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rodeo

// model: 0 Lorenz63, 1 FitzHughNagumo; obs_model: 0 Gauss, 1 Poisson; mode:
// 0 kramer, 1 rodeo (the numbering of _FUNCTORS, _OBS_FUNCTORS and _MODES
// in ops/fused_kalman.py and ops/fused_daltonng.py); obs_dims: bit j set
// for each observed component j.  q_host and pars_host point to the 3 x 3
// scaled transition and the observation model's kObsPars parameters in
// host memory; every other pointer is device memory laid out as
// filter_nn_batch (ops/fused_daltonng.py) documents.  Returns a
// cudaError_t.
extern "C" int rodeo_filter_nn_batch(int model, int obs_model, int mode,
                                     int obs_dims, int n_steps, int n_lane,
                                     const void* q_host,
                                     const void* pars_host, const void* R,
                                     const void* W, const void* tv,
                                     const void* x0, const void* theta,
                                     const void* tgrid, const void* y,
                                     const void* iobs, const void* mask,
                                     void* mf, void* pf, void* mp, void* pp,
                                     void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_lane < 1) return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  ObsPars pars;
  std::memcpy(pars.p, pars_host, sizeof(pars.p));
  const auto* r = static_cast<const float*>(R);
  const auto* w = static_cast<const float*>(W);
  const auto* t = static_cast<const float*>(tv);
  const auto* x = static_cast<const float*>(x0);
  const auto* th = static_cast<const float*>(theta);
  const auto* tg = static_cast<const float*>(tgrid);
  const auto* yy = static_cast<const float*>(y);
  const auto* io = static_cast<const float*>(iobs);
  const auto* mk = static_cast<const float*>(mask);
  auto* mfp = static_cast<float*>(mf);
  auto* pfp = static_cast<float*>(pf);
  auto* mpp = static_cast<float*>(mp);
  auto* ppp = static_cast<float*>(pp);
  auto s = static_cast<cudaStream_t>(stream);
  switch (model * 2 + obs_model) {
    case 0:
      return nn_launch_mode<Lorenz63, Gauss>(mode, qc, pars, obs_dims, n_steps,
                                             n_lane, r, w, t, x, th, tg, yy,
                                             io, mk, mfp, pfp, mpp, ppp, s);
    case 1:
      return nn_launch_mode<Lorenz63, Poisson>(mode, qc, pars, obs_dims,
                                               n_steps, n_lane, r, w, t, x, th,
                                               tg, yy, io, mk, mfp, pfp, mpp,
                                               ppp, s);
    case 2:
      return nn_launch_mode<FitzHughNagumo, Gauss>(mode, qc, pars, obs_dims,
                                                   n_steps, n_lane, r, w, t, x,
                                                   th, tg, yy, io, mk, mfp,
                                                   pfp, mpp, ppp, s);
    case 3:
      return nn_launch_mode<FitzHughNagumo, Poisson>(mode, qc, pars, obs_dims,
                                                     n_steps, n_lane, r, w, t,
                                                     x, th, tg, yy, io, mk,
                                                     mfp, pfp, mpp, ppp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
