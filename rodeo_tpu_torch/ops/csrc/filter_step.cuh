// The pieces of the lane-batched EK filter's step that act on one block:
// the prediction (predict_block), the smoothing gains of a step
// (gain_cols) and non-Gaussian DALTON's masked Laplace pseudo-observation
// update (laplace_update), with the interrogation modes and the scaled
// transition (QConst) that the filters take as a kernel argument.
//
// The filters K1 (filter_batch.cu), K3 (filter_single.cu), K8
// (dalton_filter_batch.cu) and K9 (filter_nn_batch.cuh) on float, and the
// tangent kernels K11a (filter_batch_tan.cuh), K11c
// (dalton_filter_batch_tan.cu) and K11d (filter_nn_batch_tan.cuh) on the
// scalar type Dual (dual.cuh), run them inside the step split over the
// blocks of a lane (block_step.cuh), which adds the ODE's update of a
// block.  The plain PyTorch versions of the step are _filter_batch_plain
// (ops/fused_kalman.py), _dalton_filter_plain (ops/fused_dalton.py) and
// _filter_nn_batch_plain (ops/fused_daltonng.py), which run on Duals for
// the tangent kernels; the order of every sum follows them (see
// kalman_cols.cuh).
#pragma once

#include <cuda_runtime.h>

#include "kalman_cols.cuh"
#include "obs_models.cuh"

namespace rodeo {

// The interrogations, numbered as _MODES in ops/fused_kalman.py numbers
// them.  K1 and K3 take all four; the other filters kramer and rodeo.
constexpr int kKramer = 0;     // EK1, zero measurement noise
constexpr int kRodeo = 1;      // EK0, measurement noise W Sigma_pred W'
constexpr int kSchober = 2;    // EK0, zero measurement noise
constexpr int kChkrebtii = 3;  // rodeo's noise, the ODE at a predictive draw

template <int Q>
struct QConst {
  float q[Q * Q];  // scaled transition, row-major
};

// Prediction of one block: mp = Q m, pp = Q P Q' + R.
template <int Q, class T>
__device__ __forceinline__ void predict_block(const float (&Qm)[Q][Q],
                                              const float (&R)[Tri<Q>::N],
                                              const T (&m)[Q],
                                              const T (&P)[Tri<Q>::N],
                                              T (&mp)[Q], T (&pp)[Tri<Q>::N]) {
  matvec<Q>(Qm, m, mp);
  sym_quadform<Q>(Qm, P, pp);
#pragma unroll
  for (int k = 0; k < Tri<Q>::N; ++k) pp[k] = pp[k] + R[k];
}

// G, g and the Joseph-form noise L of the backward kernel of the transition
// n-1 -> n (_gain_cols_batched of ops/fused_kalman.py), from the filtered
// moments at n-1 and the predicted ones at n: G = Pf Q' Pp^{-1},
// g = mf - G mp, L = (I - G Q) Pf (I - G Q)' + G R G'.
template <int Q, class T>
__device__ __forceinline__ void gain_cols(
    const float (&Qm)[Q][Q], const float (&R)[Tri<Q>::N], const T (&mf)[Q],
    const T (&Pf)[Tri<Q>::N], const T (&mp)[Q], const T (&Pp)[Tri<Q>::N],
    T (&G)[Q][Q], T (&g)[Q], T (&L)[Tri<Q>::N]) {
  constexpr int NT = Tri<Q>::N;
  T ppinv[NT];
  sym_inv<Q>(Pp, ppinv);
  T T1[Q][Q];  // Pf Q'
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      T acc = Qm[l][0] * Pf[Tri<Q>::at(i, 0)];
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + Qm[l][j] * Pf[Tri<Q>::at(i, j)];
      T1[i][l] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      T acc = T1[i][0] * ppinv[Tri<Q>::at(0, l)];
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + T1[i][j] * ppinv[Tri<Q>::at(j, l)];
      G[i][l] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = mf[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) acc = acc - G[i][j] * mp[j];
    g[i] = acc;
  }
  T IGQ[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      T s = Qm[0][j] * G[i][0];
#pragma unroll
      for (int k = 1; k < Q; ++k) s = s + Qm[k][j] * G[i][k];
      IGQ[i][j] = (i == j) ? 1.0f - s : -s;
    }
  }
  T GR[NT];
  sym_quadform<Q>(IGQ, Pf, L);
  sym_quadform<Q>(G, R, GR);
#pragma unroll
  for (int k = 0; k < NT; ++k) L[k] = L[k] + GR[k];
}

// The masked Laplace pseudo-observation update of component j of one block
// (_laplace_update_cols of ops/fused_daltonng.py), after the ODE update.
// The observation log-likelihood is linearised at x, the component's
// predicted mean in original coordinates: its gradient g and Hessian h come
// from the functor evaluated on the Jet2 (x, 1, 0), the pseudo-observation
// variance is vhat = -1 / h and the pseudo-datum x + vhat g, observed
// through the scaled row D = tv[j] e_j: zo = (x + vhat g) - tv[j] m[j],
// So = vhat + D P D', K = P D' (mask / So), m += K zo and the Joseph form
// P = (I - K D) P (I - K D)' + K K' vhat.
template <class Obs, int Q, class T, int NTH>
__device__ __forceinline__ void laplace_update(
    const float (&tv)[Q], int j, const T& x, float y, float iobs,
    float mask, const T (&th)[NTH], const ObsPars& pars, T (&m)[Q],
    T (&P)[Tri<Q>::N]) {
  constexpr int NT = Tri<Q>::N;
  const Jet2<T> ll =
      Obs::template f<Jet2<T>, T, NTH>(y, jet_variable(x), j, th, iobs, pars);
  const T& g = ll.d1;
  const T& h = ll.d2;
  const T vhat = -1.0f / h;
  const T zo = (x + vhat * g) - tv[j] * m[j];
  T PD[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) PD[i] = P[Tri<Q>::at(i, j)] * tv[j];
  const T So = vhat + tv[j] * PD[j];
  const T ratio = mask / So;
  T K[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) K[i] = PD[i] * ratio;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = m[i] + K[i] * zo;
  T IKD[Q][Q];
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int l = 0; l < Q; ++l)
      IKD[i][l] = (i == l ? 1.0f : 0.0f) - (l == j ? K[i] * tv[j] : T(0.0f));
  T pj[NT];
  sym_quadform<Q>(IKD, P, pj);
  int k = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int l = i; l < Q; ++l, ++k) P[k] = pj[k] + K[i] * K[l] * vhat;
}

}  // namespace rodeo
