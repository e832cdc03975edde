// One step of the lane-batched EK filter for a thread that carries one lane
// with all NB blocks of its state in registers: predict, interrogate the ODE
// at the predicted mean, and the scalar-innovation Joseph update; the
// smoothing gains of a step (gain_cols) and non-Gaussian DALTON's
// Laplace-linearised step (filter_nn_step).
//
// The one-thread-per-lane step (interrogate_update, FilterConsts,
// load_consts) is run by K9 (filter_nn_batch.cu) alone, whose filter_nn_step
// adds masked pseudo-observation updates to it.  K1 (filter_batch.cu), K3
// (filter_single.cu) and K8 (dalton_filter_batch.cu) on float, and the
// tangent kernels K11a (filter_batch_tan.cu), K11c
// (dalton_filter_batch_tan.cu) and K11d (filter_nn_batch_tan.cu) on the
// scalar type Dual (dual.cuh), run the same step split over the blocks of a
// lane (block_step.cuh): predict_block, gain_cols and laplace_update from
// here, and a per-block copy of interrogate_update's loop body, so their
// values are this step's bitwise.  The plain PyTorch versions of this step
// are _filter_batch_plain (ops/fused_kalman.py), _dalton_filter_plain
// (ops/fused_dalton.py) and _filter_nn_batch_plain
// (ops/fused_daltonng.py), which run on Duals for the tangent kernels; the
// order of every sum follows them (see kalman_cols.cuh).
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#include "kalman_cols.cuh"
#include "obs_models.cuh"

namespace rodeo {

constexpr int kKramer = 0;  // EK1, zero measurement noise
constexpr int kRodeo = 1;   // EK0, measurement noise W Sigma_pred W'

template <int Q>
struct QConst {
  float q[Q * Q];  // scaled transition, row-major
};

// The lane-shared operands of the filter, held in registers.
template <class Model, int Q>
struct FilterConsts {
  float Qm[Q][Q];
  float R[Model::NB][Tri<Q>::N];
  float W[Model::NB][Q];
  float tv[Q];
};

template <class Model, int Q>
__device__ __forceinline__ void load_consts(const QConst<Q>& qc,
                                            const float* __restrict__ R_in,
                                            const float* __restrict__ W_in,
                                            const float* __restrict__ tv_in,
                                            FilterConsts<Model, Q>& c) {
  constexpr int NB = Model::NB;
  constexpr int NT = Tri<Q>::N;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) c.Qm[i][j] = qc.q[i * Q + j];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int k = 0; k < NT; ++k) c.R[b][k] = R_in[b * NT + k];
#pragma unroll
    for (int j = 0; j < Q; ++j) c.W[b][j] = W_in[b * Q + j];
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) c.tv[j] = tv_in[j];
}

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

// Interrogate the ODE at the predicted mean (original coordinates) of all
// blocks and update each block from (mp, pp) into (m, P).  Returns each
// block's innovation z, its variance S (doubled under EK0) and 1 / S, the
// terms of the forecast log-density.  The measurement row is
// H = W - J diag(tv), where the block-diagonal Jacobian J has only column 0:
// its entries j > 0 are W's constants, and H[0] depends on theta under EK1
// (type T) and is W's constant under EK0, as in the twin.
template <class Model, int Q, int MODE, class T>
__device__ __forceinline__ void interrogate_update(
    const FilterConsts<Model, Q>& c, const T (&th)[Model::NTHETA], float t,
    const T (&mp)[Model::NB][Q], const T (&pp)[Model::NB][Tri<Q>::N],
    T (&m)[Model::NB][Q], T (&P)[Model::NB][Tri<Q>::N],
    T (&z_out)[Model::NB], T (&S_out)[Model::NB],
    T (&inv_S_out)[Model::NB]) {
  constexpr int NB = Model::NB;
  using TH = std::conditional_t<MODE == kKramer, T, float>;
  T x[NB][Q], fx[NB], jd[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) x[b][j] = mp[b][j] * c.tv[j];
  Model::template f<Q>(x, th, t, fx);
  if constexpr (MODE == kKramer) Model::template jac0<Q>(x, th, t, jd);

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float (&W)[Q] = c.W[b];  // H[j] for j > 0
    TH H0;                          // H[0]
    if constexpr (MODE == kKramer) H0 = W[0] - jd[b] * c.tv[0];
    else H0 = W[0];
    T hm = H0 * mp[b][0];
#pragma unroll
    for (int j = 1; j < Q; ++j) hm = hm + W[j] * mp[b][j];
    T mm = -fx[b];
    if constexpr (MODE == kKramer) mm = mm + jd[b] * x[b][0];
    const T z = -(hm + mm);
    T PH[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      T acc = pp[b][Tri<Q>::at(i, 0)] * H0;
#pragma unroll
      for (int j = 1; j < Q; ++j) acc = acc + pp[b][Tri<Q>::at(i, j)] * W[j];
      PH[i] = acc;
    }
    T S = H0 * PH[0];
#pragma unroll
    for (int i = 1; i < Q; ++i) S = S + W[i] * PH[i];
    if constexpr (MODE == kRodeo) S = S + S;  // V = W Sigma_pred W' doubles S
    const T inv_S = 1.0f / S;
    T gain[Q], IKW[Q][Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) gain[i] = PH[i] * inv_S;
#pragma unroll
    for (int i = 0; i < Q; ++i) m[b][i] = mp[b][i] + gain[i] * z;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      IKW[i][0] = (i == 0 ? 1.0f : 0.0f) - gain[i] * H0;
#pragma unroll
      for (int j = 1; j < Q; ++j)
        IKW[i][j] = (i == j ? 1.0f : 0.0f) - gain[i] * W[j];
    }
    sym_quadform<Q>(IKW, pp[b], P[b]);
    if constexpr (MODE == kRodeo) {
      const T V = S * 0.5f;
      int k = 0;
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = i; j < Q; ++j, ++k) P[b][k] = P[b][k] + gain[i] * gain[j] * V;
    }
    z_out[b] = z;
    S_out[b] = S;
    inv_S_out[b] = inv_S;
  }
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

// One step n of the Laplace-linearised filter of non-Gaussian DALTON
// (_filter_nn_batch_plain of ops/fused_daltonng.py): predict, interrogate
// and update every block from (m, P) into (mp, pp) and (m, P), then, at a
// step with data (mask[n] != 0), the pseudo-observation update of each
// component j in obs_dims (a bit mask), in ascending order.  A step
// without data skips them: there the masked update is an exact identity
// (K = 0), and the twin skips it too.  The observation grid (y: N x NB,
// iobs, mask: N) is shared by all lanes.
template <class Model, class Obs, int Q, int MODE, class T>
__device__ __forceinline__ void filter_nn_step(
    const FilterConsts<Model, Q>& c, const T (&th)[Model::NTHETA], int n,
    float t, int obs_dims, const ObsPars& pars, const float* __restrict__ y,
    const float* __restrict__ iobs, const float* __restrict__ mask,
    T (&m)[Model::NB][Q], T (&P)[Model::NB][Tri<Q>::N],
    T (&mp)[Model::NB][Q], T (&pp)[Model::NB][Tri<Q>::N]) {
  constexpr int NB = Model::NB;
#pragma unroll
  for (int b = 0; b < NB; ++b) predict_block<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b]);
  T z[NB], S[NB], inv_S[NB];
  interrogate_update<Model, Q, MODE>(c, th, t, mp, pp, m, P, z, S, inv_S);
  const float mk = mask[n];
  if (mk == 0.0f) return;
  const float io = iobs[n];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (!(obs_dims & (1 << j))) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      laplace_update<Obs, Q>(c.tv, j, mp[b][j] * c.tv[j],
                             y[static_cast<size_t>(n) * NB + b], io, mk, th,
                             pars, m[b], P[b]);
  }
}

}  // namespace rodeo
