// K11d: the tangent twin of K9.  The Laplace-linearised filter of
// non-Gaussian DALTON carries the derivative of its state along each theta
// direction and stores the filtered and predicted moments with their
// tangents, stacked on the d axis as the TPU kernel stacks them: mf (N,
// NAUG Q, NB, B), pf (N, NAUG Tri, ..), mp (N, NAUG Q, ..), pp (N, NAUG
// Tri, ..), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_daltonng.py:
// _filter_nn_kernel_batch_tan (interrogations kramer and rodeo).
// Plain PyTorch twin: _filter_nn_batch_tan_plain in ops/fused_daltonng.py,
// which runs K9's twin on Duals (ops/dual.py).
//
// Design.  One thread carries one (lane, direction): K9's step
// (filter_step.cuh's filter_nn_step) instantiated on the forward-mode
// number Dual (dual.cuh), with theta seeded along the thread's direction
// and the initial state exact (zero tangent), as K11a does for K1.  The
// Laplace derivatives come from the observation functor evaluated on a
// Jet2 of Duals (jet.cuh), so the tangent of the Hessian -- the third
// derivative of the observation log-likelihood -- needs no code of its
// own.  The value part of each Dual is K9's float arithmetic, so the
// values equal K9's bitwise; the thread of direction 0 stores them.  A CTA
// holds kNnTanLanes lanes x NTHETA directions.
//
// What bounds it on the card.  A step stores 72 floats per (block, lane)
// at NAUG = 4: 7.08 GB at 4000 steps x 3 blocks x 2048 lanes, 2.11 ms at
// 3.35 TB/s.  Each thread's step is a serial chain of some 3e3 dependent
// float operations (K9's and its tangent), so the kernel is latency-bound
// as K9 is, with three times as many threads in flight.
#include <cstring>

#include <cuda_runtime.h>

#include "dual.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"
#include "obs_models.cuh"

namespace rodeo {

constexpr int kNnTanLanes = 32;

template <class Model, class Obs, int Q, int MODE>
__global__ void __launch_bounds__(kNnTanLanes * Model::NTHETA)
    filter_nn_batch_tan_kernel(QConst<Q> qc, ObsPars pars, int obs_dims,
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
  constexpr int NAUG = 1 + NTH;
  const int lane = blockIdx.x * kNnTanLanes + threadIdx.x;
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

  for (int n = 0; n < n_steps; ++n) {
    Dual mp[NB][Q], pp[NB][NT];
    filter_nn_step<Model, Obs, Q, MODE>(c, th, n, tgrid[n], obs_dims, pars, y,
                                        iobs, mask, m, P, mp, pp);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        store_aug(mf_out, n, Q, NAUG, i, col, base, dir, m[b][i]);
        store_aug(mp_out, n, Q, NAUG, i, col, base, dir, mp[b][i]);
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        store_aug(pf_out, n, NT, NAUG, k, col, base, dir, P[b][k]);
        store_aug(pp_out, n, NT, NAUG, k, col, base, dir, pp[b][k]);
      }
    }
  }
}

template <class Model, class Obs, int MODE>
cudaError_t nn_tan_launch(const QConst<3>& qc, const ObsPars& pars,
                          int obs_dims, int n_steps, int n_lane,
                          const float* R, const float* W, const float* tv,
                          const float* x0, const float* theta,
                          const float* tgrid, const float* y,
                          const float* iobs, const float* mask, float* mf,
                          float* pf, float* mp, float* pp,
                          cudaStream_t stream) {
  const dim3 block(kNnTanLanes, Model::NTHETA);
  const dim3 grid((n_lane + kNnTanLanes - 1) / kNnTanLanes);
  filter_nn_batch_tan_kernel<Model, Obs, 3, MODE><<<grid, block, 0, stream>>>(
      qc, pars, obs_dims, n_steps, n_lane, R, W, tv, x0, theta, tgrid, y,
      iobs, mask, mf, pf, mp, pp);
  return cudaGetLastError();
}

template <class Model, class Obs>
cudaError_t nn_tan_launch_mode(int mode, const QConst<3>& qc,
                               const ObsPars& pars, int obs_dims, int n_steps,
                               int n_lane, const float* R, const float* W,
                               const float* tv, const float* x0,
                               const float* theta, const float* tgrid,
                               const float* y, const float* iobs,
                               const float* mask, float* mf, float* pf,
                               float* mp, float* pp, cudaStream_t stream) {
  if (mode == kKramer)
    return nn_tan_launch<Model, Obs, kKramer>(qc, pars, obs_dims, n_steps,
                                              n_lane, R, W, tv, x0, theta,
                                              tgrid, y, iobs, mask, mf, pf,
                                              mp, pp, stream);
  if (mode == kRodeo)
    return nn_tan_launch<Model, Obs, kRodeo>(qc, pars, obs_dims, n_steps,
                                             n_lane, R, W, tv, x0, theta,
                                             tgrid, y, iobs, mask, mf, pf, mp,
                                             pp, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rodeo

// The arguments of rodeo_filter_nn_batch (filter_nn_batch.cu), with the
// augmented outputs mf, pf, mp, pp laid out as filter_nn_batch_tan
// (ops/fused_daltonng.py) documents; NTHETA tangent directions, one per
// parameter of the model.  Returns a cudaError_t.
extern "C" int rodeo_filter_nn_batch_tan(int model, int obs_model, int mode,
                                         int obs_dims, int n_steps, int n_lane,
                                         const void* q_host,
                                         const void* pars_host, const void* R,
                                         const void* W, const void* tv,
                                         const void* x0, const void* theta,
                                         const void* tgrid, const void* y,
                                         const void* iobs, const void* mask,
                                         void* mf, void* pf, void* mp,
                                         void* pp, void* stream) {
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
      return nn_tan_launch_mode<Lorenz63, Gauss>(mode, qc, pars, obs_dims,
                                                 n_steps, n_lane, r, w, t, x,
                                                 th, tg, yy, io, mk, mfp, pfp,
                                                 mpp, ppp, s);
    case 1:
      return nn_tan_launch_mode<Lorenz63, Poisson>(mode, qc, pars, obs_dims,
                                                   n_steps, n_lane, r, w, t, x,
                                                   th, tg, yy, io, mk, mfp,
                                                   pfp, mpp, ppp, s);
    case 2:
      return nn_tan_launch_mode<FitzHughNagumo, Gauss>(
          mode, qc, pars, obs_dims, n_steps, n_lane, r, w, t, x, th, tg, yy,
          io, mk, mfp, pfp, mpp, ppp, s);
    case 3:
      return nn_tan_launch_mode<FitzHughNagumo, Poisson>(
          mode, qc, pars, obs_dims, n_steps, n_lane, r, w, t, x, th, tg, yy,
          io, mk, mfp, pfp, mpp, ppp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
