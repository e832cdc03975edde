// One step of the lane-batched EK filter for a thread that carries one lane
// with all NB blocks of its state in registers: predict, interrogate the ODE
// at the predicted mean, and the scalar-innovation Joseph update.
//
// Shared by K1 (filter_batch.cu), which also forms the smoothing gains
// between predict and update, and K8 (dalton_filter_batch.cu), which also
// sums the forecast log-density and adds a masked observation update, so
// that both kernels run the same arithmetic.  The plain PyTorch versions of
// this step are _filter_batch_plain (ops/fused_kalman.py) and
// _dalton_filter_plain (ops/fused_dalton.py); the order of every sum
// follows them (see kalman_cols.cuh).
#pragma once

#include <cuda_runtime.h>

#include "kalman_cols.cuh"

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
template <int Q>
__device__ __forceinline__ void predict_block(const float (&Qm)[Q][Q],
                                              const float (&R)[Tri<Q>::N],
                                              const float (&m)[Q],
                                              const float (&P)[Tri<Q>::N],
                                              float (&mp)[Q],
                                              float (&pp)[Tri<Q>::N]) {
  matvec<Q>(Qm, m, mp);
  sym_quadform<Q>(Qm, P, pp);
#pragma unroll
  for (int k = 0; k < Tri<Q>::N; ++k) pp[k] = pp[k] + R[k];
}

// Interrogate the ODE at the predicted mean (original coordinates) of all
// blocks and update each block from (mp, pp) into (m, P).  Returns each
// block's innovation z, its variance S (doubled under EK0) and 1 / S, the
// terms of the forecast log-density.
template <class Model, int Q, int MODE>
__device__ __forceinline__ void interrogate_update(
    const FilterConsts<Model, Q>& c, const float (&th)[Model::NTHETA],
    float t, const float (&mp)[Model::NB][Q],
    const float (&pp)[Model::NB][Tri<Q>::N], float (&m)[Model::NB][Q],
    float (&P)[Model::NB][Tri<Q>::N], float (&z_out)[Model::NB],
    float (&S_out)[Model::NB], float (&inv_S_out)[Model::NB]) {
  constexpr int NB = Model::NB;
  float x[NB][Q], fx[NB], jd[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) x[b][j] = mp[b][j] * c.tv[j];
  Model::template f<Q>(x, th, t, fx);
  if (MODE == kKramer) Model::template jac0<Q>(x, th, t, jd);

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float H[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) H[j] = c.W[b][j];
    if (MODE == kKramer) H[0] = c.W[b][0] - jd[b] * c.tv[0];
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
    z_out[b] = z;
    S_out[b] = S;
    inv_S_out[b] = inv_S;
  }
}

}  // namespace rodeo
