// K1: lane-batched forward filter of the probabilistic ODE solver, emitting
// the per-step smoothing gains (G, g, L) and the last filtered state.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _filter_kernel_batch (emit="gains", interrogations kramer and rodeo).
// Plain PyTorch twin: _filter_batch_plain in ops/fused_kalman.py.
//
// Design.  One thread carries one lane (one independent solve) through all
// N steps in a single launch, with all NB blocks of its state in registers:
// the ODE right-hand side couples the blocks (Lorenz's f_y needs x and z),
// while the EK1 Jacobian is block-diagonal, so the Kalman update itself runs
// block by block.  Each step predicts through the constant scaled Pascal
// transition (kernel arguments, the float32 values the wrapper computed),
// adds the process noise, forms the smoothing gain of the transition n-1 ->
// n from the carry and the fresh prediction, evaluates the ODE (and column 0
// of its Jacobian) at the predicted mean, and does the scalar-innovation
// Joseph update.  Outputs are laid out (N, d, NB, B) with lanes innermost,
// so the threads of a warp store 32 neighbouring floats.  The arithmetic is
// float32 throughout, as on the TPU.
//
// What bounds it on the card.  A step is ~1e3 dependent float operations
// per lane against 18 * NB floats stored, so the kernel is bound by the
// latency of each thread's serial chain, not by device memory; and B lanes
// give only B threads (2048 at the benchmark's width), far fewer than the
// card can keep in flight.  The design takes small CTAs (kFilterThreads) so
// that the lanes spread over as many SMs as possible; splitting a lane's
// blocks over threads to raise occupancy is left to a later change.
#include <cstring>

#include <cuda_runtime.h>

#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kFilterThreads = 32;
constexpr int kKramer = 0;  // EK1, zero measurement noise
constexpr int kRodeo = 1;   // EK0, measurement noise W Sigma_pred W'

template <int Q>
struct QConst {
  float q[Q * Q];  // scaled transition, row-major
};

// G, g and the Joseph-form noise L of the backward kernel of the transition
// n-1 -> n (_gain_cols_batched): G = Pf Q' Pp^{-1}, g = mf - G mp,
// L = (I - G Q) Pf (I - G Q)' + G R G'.
template <int Q>
__device__ __forceinline__ void gain_cols(
    const float (&Qm)[Q][Q], const float (&R)[Tri<Q>::N],
    const float (&mf)[Q], const float (&Pf)[Tri<Q>::N], const float (&mp)[Q],
    const float (&Pp)[Tri<Q>::N], float (&G)[Q][Q], float (&g)[Q],
    float (&L)[Tri<Q>::N]) {
  constexpr int NT = Tri<Q>::N;
  float ppinv[NT];
  sym_inv<Q>(Pp, ppinv);
  float T1[Q][Q];  // Pf Q'
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      float acc = Qm[l][0] * Pf[Tri<Q>::at(i, 0)];
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + Qm[l][j] * Pf[Tri<Q>::at(i, j)];
      T1[i][l] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      float acc = T1[i][0] * ppinv[Tri<Q>::at(0, l)];
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + T1[i][j] * ppinv[Tri<Q>::at(j, l)];
      G[i][l] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = mf[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc - G[i][j] * mp[j];
    g[i] = acc;
  }
  float IGQ[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      float s = Qm[0][j] * G[i][0];
#pragma unroll
      for (int k = 1; k < Q; ++k) s = s + Qm[k][j] * G[i][k];
      IGQ[i][j] = (i == j) ? 1.0f - s : -s;
    }
  }
  float GR[NT];
  sym_quadform<Q>(IGQ, Pf, L);
  sym_quadform<Q>(G, R, GR);
#pragma unroll
  for (int k = 0; k < NT; ++k) L[k] = L[k] + GR[k];
}

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(kFilterThreads)
    filter_batch_kernel(QConst<Q> qc, int n_steps, int n_lane,
                        const float* __restrict__ R_in,
                        const float* __restrict__ W_in,
                        const float* __restrict__ tv_in,
                        const float* __restrict__ x0,
                        const float* __restrict__ theta,
                        const float* __restrict__ tgrid,
                        float* __restrict__ G_out, float* __restrict__ g_out,
                        float* __restrict__ L_out, float* __restrict__ m_last,
                        float* __restrict__ p_last) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
  constexpr int NTH = Model::NTHETA;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lane) return;
  // stride between consecutive rows of one (step, d) slab: NB blocks x B
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t off = lane;

  float Qm[Q][Q], R[NB][NT], W[NB][Q], tv[Q], th[NTH];
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) Qm[i][j] = qc.q[i * Q + j];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int k = 0; k < NT; ++k) R[b][k] = R_in[b * NT + k];
#pragma unroll
    for (int j = 0; j < Q; ++j) W[b][j] = W_in[b * Q + j];
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) tv[j] = tv_in[j];
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
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      matvec<Q>(Qm, m[b], mp[b]);
      sym_quadform<Q>(Qm, P[b], pp[b]);
#pragma unroll
      for (int k = 0; k < NT; ++k) pp[b][k] = pp[b][k] + R[b][k];
      // the gain of the transition n-1 -> n needs only the carry (filtered
      // n-1) and the fresh prediction (n)
      float G[Q][Q], g[Q], L[NT];
      gain_cols<Q>(Qm, R[b], m[b], P[b], mp[b], pp[b], G, g, L);
      const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          G_out[(static_cast<size_t>(n) * Q * Q + i * Q + j) * col + base] = G[i][j];
#pragma unroll
      for (int i = 0; i < Q; ++i)
        g_out[(static_cast<size_t>(n) * Q + i) * col + base] = g[i];
#pragma unroll
      for (int k = 0; k < NT; ++k)
        L_out[(static_cast<size_t>(n) * NT + k) * col + base] = L[k];
    }

    // interrogate the ODE at the predicted mean, in original coordinates
    float x[NB][Q], fx[NB], jd[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < Q; ++j) x[b][j] = mp[b][j] * tv[j];
    const float t = tgrid[n];
    Model::template f<Q>(x, th, t, fx);
    if (MODE == kKramer) Model::template jac0<Q>(x, th, t, jd);

#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float H[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) H[j] = W[b][j];
      if (MODE == kKramer) H[0] = W[b][0] - jd[b] * tv[0];
      float hm = H[0] * mp[b][0];
#pragma unroll
      for (int j = 1; j < Q; ++j) hm = hm + H[j] * mp[b][j];
      float mm = -fx[b];
      if (MODE == kKramer) mm = mm + jd[b] * x[b][0];
      const float z = -(hm + mm);
      float PH[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        float acc = pp[b][Tri<Q>::at(i, 0)] * H[0];
#pragma unroll
        for (int j = 1; j < Q; ++j) acc = acc + pp[b][Tri<Q>::at(i, j)] * H[j];
        PH[i] = acc;
      }
      float S = H[0] * PH[0];
#pragma unroll
      for (int i = 1; i < Q; ++i) S = S + H[i] * PH[i];
      if (MODE == kRodeo) S = S + S;  // V = W Sigma_pred W' doubles S
      const float inv_S = 1.0f / S;
      float gain[Q], IKW[Q][Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) gain[i] = PH[i] * inv_S;
#pragma unroll
      for (int i = 0; i < Q; ++i) m[b][i] = mp[b][i] + gain[i] * z;
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          IKW[i][j] = (i == j ? 1.0f : 0.0f) - gain[i] * H[j];
      sym_quadform<Q>(IKW, pp[b], P[b]);
      if (MODE == kRodeo) {
        const float V = S * 0.5f;
        int k = 0;
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int j = i; j < Q; ++j, ++k) P[b][k] = P[b][k] + gain[i] * gain[j] * V;
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
    for (int j = 0; j < Q; ++j) m_last[j * col + base] = m[b][j];
#pragma unroll
    for (int k = 0; k < NT; ++k) p_last[k * col + base] = P[b][k];
  }
}

template <class Model, int MODE>
cudaError_t launch(const QConst<3>& qc, int n_steps, int n_lane,
                   const float* R, const float* W, const float* tv,
                   const float* x0, const float* theta, const float* tgrid,
                   float* G, float* g, float* L, float* m_last, float* p_last,
                   cudaStream_t stream) {
  const dim3 block(kFilterThreads);
  const dim3 grid((n_lane + kFilterThreads - 1) / kFilterThreads);
  filter_batch_kernel<Model, 3, MODE><<<grid, block, 0, stream>>>(
      qc, n_steps, n_lane, R, W, tv, x0, theta, tgrid, G, g, L, m_last,
      p_last);
  return cudaGetLastError();
}

}  // namespace rodeo

// model: 0 Lorenz63, 1 FitzHughNagumo; mode: 0 kramer, 1 rodeo (the
// numbering of _FUNCTORS and _MODES in ops/fused_kalman.py).  q_host points
// to the 3 x 3 scaled transition in host memory; every other pointer is
// device memory laid out as fused_filter_batch documents.  Returns a
// cudaError_t.
extern "C" int rodeo_filter_batch(int model, int mode, int n_steps,
                                  int n_lane, const void* q_host,
                                  const void* R, const void* W, const void* tv,
                                  const void* x0, const void* theta,
                                  const void* tgrid, void* G, void* g,
                                  void* L, void* m_last, void* p_last,
                                  void* stream) {
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
  auto* Gp = static_cast<float*>(G);
  auto* gp = static_cast<float*>(g);
  auto* Lp = static_cast<float*>(L);
  auto* mp = static_cast<float*>(m_last);
  auto* pp = static_cast<float*>(p_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (model * 2 + mode) {
    case 0:
      return launch<Lorenz63, kKramer>(qc, n_steps, n_lane, r, w, t, x, th,
                                       tg, Gp, gp, Lp, mp, pp, s);
    case 1:
      return launch<Lorenz63, kRodeo>(qc, n_steps, n_lane, r, w, t, x, th,
                                      tg, Gp, gp, Lp, mp, pp, s);
    case 2:
      return launch<FitzHughNagumo, kKramer>(qc, n_steps, n_lane, r, w, t, x,
                                             th, tg, Gp, gp, Lp, mp, pp, s);
    case 3:
      return launch<FitzHughNagumo, kRodeo>(qc, n_steps, n_lane, r, w, t, x,
                                            th, tg, Gp, gp, Lp, mp, pp, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* rodeo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
