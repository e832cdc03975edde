// K3: the single-solve forward filter of the probabilistic ODE solver,
// storing the filtered and predicted moments of steps 1..N: mf, mp
// (N, NB, q) and packed pf, pp (N, NB, n_tri).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py: _filter_kernel
// (interrogations kramer and rodeo).  Plain PyTorch twin:
// _filter_single_plain in ops/fused_kalman.py.
//
// Design.  K1's step, not a copy: predict_block and interrogate_update of
// filter_step.cuh (whose loop body K1 and K8 run per block), on one solve.
// The ODE's right-hand side couples the blocks (Lorenz's f_y needs x and
// z), so one thread carries all NB blocks of the state in registers through
// all N steps of a single launch, and stores the four moments of each step
// in the JAX package's (N, NB, d) layout instead of K1's gains.  The TPU
// kernel's chunk grid (which streamed VMEM blocks to HBM) and its unroll
// option have no counterpart here: the loop runs inside the thread, and
// the stores drain while the next step computes.
//
// What bounds it on the card.  One thread: each step is ~1e3 dependent float
// operations, so the kernel runs at the latency of that chain, far above its
// byte bound (54 floats stored per step at 3 blocks, 2.2 MB at 10 000 steps,
// 0.65 us at 3.35 TB/s).  Nothing in one solve can run beside the chain;
// many solves at once are the lane-batched K1's work.
#include <cstring>

#include <cuda_runtime.h>

#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(1)
    filter_single_kernel(QConst<Q> qc, int n_steps,
                         const float* __restrict__ R_in,
                         const float* __restrict__ W_in,
                         const float* __restrict__ tv_in,
                         const float* __restrict__ x0,
                         const float* __restrict__ theta,
                         const float* __restrict__ tgrid,
                         float* __restrict__ mf, float* __restrict__ pf,
                         float* __restrict__ mp_out, float* __restrict__ pp_out) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  FilterConsts<Model, Q> c;
  load_consts<Model, Q>(qc, R_in, W_in, tv_in, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k];

  float m[NB][Q], P[NB][NT];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < Q; ++j) m[b][j] = x0[b * Q + j];
#pragma unroll
    for (int k = 0; k < NT; ++k) P[b][k] = 0.0f;
  }

  for (int n = 0; n < n_steps; ++n) {
    float mp[NB][Q], pp[NB][NT];
#pragma unroll
    for (int b = 0; b < NB; ++b) predict_block<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b]);
    float z[NB], S[NB], inv_S[NB];
    interrogate_update<Model, Q, MODE>(c, th, tgrid[n], mp, pp, m, P, z, S, inv_S);
    const size_t row = static_cast<size_t>(n) * NB;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        mp_out[(row + b) * Q + j] = mp[b][j];
        mf[(row + b) * Q + j] = m[b][j];
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        pp_out[(row + b) * NT + k] = pp[b][k];
        pf[(row + b) * NT + k] = P[b][k];
      }
    }
  }
}

template <class Model, int MODE>
cudaError_t launch_single(const QConst<3>& qc, int n_steps, const float* R,
                          const float* W, const float* tv, const float* x0,
                          const float* theta, const float* tgrid, float* mf,
                          float* pf, float* mp, float* pp, cudaStream_t stream) {
  filter_single_kernel<Model, 3, MODE><<<1, 1, 0, stream>>>(
      qc, n_steps, R, W, tv, x0, theta, tgrid, mf, pf, mp, pp);
  return cudaGetLastError();
}

}  // namespace rodeo

// model: 0 Lorenz63, 1 FitzHughNagumo; mode: 0 kramer, 1 rodeo (the
// numbering of _FUNCTORS and _MODES in ops/fused_kalman.py).  q_host points
// to the 3 x 3 scaled transition in host memory; every other pointer is
// device memory laid out as fused_filter documents.  Returns a cudaError_t.
extern "C" int rodeo_filter_single(int model, int mode, int n_steps,
                                   const void* q_host, const void* R,
                                   const void* W, const void* tv,
                                   const void* x0, const void* theta,
                                   const void* tgrid, void* mf, void* pf,
                                   void* mp, void* pp, void* stream) {
  using namespace rodeo;
  if (n_steps < 1) return cudaErrorInvalidValue;
  QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  const auto* r = static_cast<const float*>(R);
  const auto* w = static_cast<const float*>(W);
  const auto* t = static_cast<const float*>(tv);
  const auto* x = static_cast<const float*>(x0);
  const auto* th = static_cast<const float*>(theta);
  const auto* tg = static_cast<const float*>(tgrid);
  auto* mfp = static_cast<float*>(mf);
  auto* pfp = static_cast<float*>(pf);
  auto* mpp = static_cast<float*>(mp);
  auto* ppp = static_cast<float*>(pp);
  auto s = static_cast<cudaStream_t>(stream);
  switch (model * 2 + mode) {
    case 0:
      return launch_single<Lorenz63, kKramer>(qc, n_steps, r, w, t, x, th, tg,
                                              mfp, pfp, mpp, ppp, s);
    case 1:
      return launch_single<Lorenz63, kRodeo>(qc, n_steps, r, w, t, x, th, tg,
                                             mfp, pfp, mpp, ppp, s);
    case 2:
      return launch_single<FitzHughNagumo, kKramer>(qc, n_steps, r, w, t, x,
                                                    th, tg, mfp, pfp, mpp,
                                                    ppp, s);
    case 3:
      return launch_single<FitzHughNagumo, kRodeo>(qc, n_steps, r, w, t, x,
                                                   th, tg, mfp, pfp, mpp,
                                                   ppp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
