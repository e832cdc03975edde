// K11a: the tangent twin of K1.  The lane-batched forward filter carries the
// derivative of its state along each theta direction and emits the
// smoothing gains (G, g, L) and the last filtered state with their
// tangents, stacked on the d axis as the TPU kernel stacks them: A (N,
// NAUG Q Q, NB, B), b (N, NAUG Q, ..), C (N, NAUG Tri, ..), m_last (NAUG Q,
// NB, B), p_last (NAUG Tri, NB, B), NAUG = 1 + NTHETA.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_fenrir.py:
// _filter_kernel_batch_tan (emit="gains", interrogations kramer and rodeo).
// Plain PyTorch twin: _filter_batch_tan_plain in ops/fused_kalman.py, which
// runs K1's twin on Duals (ops/dual.py).
//
// Design.  One thread carries one (lane, direction): K1's step
// (filter_step.cuh) instantiated on the forward-mode number Dual (dual.cuh),
// a value and one tangent, with theta seeded along the thread's direction
// and the initial state exact (zero tangent).  The value part of each Dual
// is K1's float arithmetic, so the values equal K1's bitwise; the thread of
// direction 0 stores them.  A CTA holds kTanLanes lanes x NTHETA directions,
// which gives NTHETA times K1's threads (6144 at 2048 lanes), each holding
// one tangent's registers rather than all NTHETA.  The TPU kernel's chunk
// grid, lane fold and re-traced primal per tangent are gone (each thread
// recomputes the value, which costs arithmetic, not memory).
//
// What bounds it on the card.  A step stores 72 floats per (block, lane) at
// NAUG = 4 (A 36, b 12, C 24): 7.08 GB at 4000 steps x 3 blocks x 2048
// lanes, 2.11 ms at 3.35 TB/s.  Each thread's step is a serial chain of
// ~3e3 dependent float operations (K1's and its tangent), so the kernel is
// latency-bound as K1 is, with three times as many threads in flight.
#include <cstring>

#include <cuda_runtime.h>

#include "dual.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kTanLanes = 32;

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(kTanLanes * Model::NTHETA)
    filter_batch_tan_kernel(QConst<Q> qc, int n_steps, int n_lane,
                            const float* __restrict__ R_in,
                            const float* __restrict__ W_in,
                            const float* __restrict__ tv_in,
                            const float* __restrict__ x0,
                            const float* __restrict__ theta,
                            const float* __restrict__ tgrid,
                            float* __restrict__ A_out,
                            float* __restrict__ b_out,
                            float* __restrict__ C_out,
                            float* __restrict__ m_last,
                            float* __restrict__ p_last) {
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

  for (int n = 0; n < n_steps; ++n) {
    Dual mp[NB][Q], pp[NB][NT];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      predict_block<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b]);
      Dual G[Q][Q], g[Q], L[NT];
      gain_cols<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b], G, g, L);
      const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          store_aug(A_out, n, Q * Q, NAUG, i * Q + j, col, base, dir, G[i][j]);
#pragma unroll
      for (int i = 0; i < Q; ++i) store_aug(b_out, n, Q, NAUG, i, col, base, dir, g[i]);
#pragma unroll
      for (int k = 0; k < NT; ++k) store_aug(C_out, n, NT, NAUG, k, col, base, dir, L[k]);
    }
    Dual z[NB], S[NB], inv_S[NB];
    interrogate_update<Model, Q, MODE>(c, th, tgrid[n], mp, pp, m, P, z, S,
                                       inv_S);
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const size_t base = b * static_cast<size_t>(n_lane) + off;
#pragma unroll
    for (int j = 0; j < Q; ++j) store_aug(m_last, 0, Q, NAUG, j, col, base, dir, m[b][j]);
#pragma unroll
    for (int k = 0; k < NT; ++k) store_aug(p_last, 0, NT, NAUG, k, col, base, dir, P[b][k]);
  }
}

template <class Model, int MODE>
cudaError_t filter_tan_launch(const QConst<3>& qc, int n_steps, int n_lane,
                              const float* R, const float* W, const float* tv,
                              const float* x0, const float* theta,
                              const float* tgrid, float* A, float* b,
                              float* C, float* m_last, float* p_last,
                              cudaStream_t stream) {
  const dim3 block(kTanLanes, Model::NTHETA);
  const dim3 grid((n_lane + kTanLanes - 1) / kTanLanes);
  filter_batch_tan_kernel<Model, 3, MODE><<<grid, block, 0, stream>>>(
      qc, n_steps, n_lane, R, W, tv, x0, theta, tgrid, A, b, C, m_last,
      p_last);
  return cudaGetLastError();
}

}  // namespace rodeo

// The arguments of rodeo_filter_batch (filter_batch.cu), with the
// augmented outputs A, b, C, m_last, p_last laid out as
// fused_filter_batch_tan (ops/fused_kalman.py) documents; NTHETA tangent
// directions, one per parameter of the model.  Returns a cudaError_t.
extern "C" int rodeo_filter_batch_tan(int model, int mode, int n_steps,
                                      int n_lane, const void* q_host,
                                      const void* R, const void* W,
                                      const void* tv, const void* x0,
                                      const void* theta, const void* tgrid,
                                      void* A, void* b, void* C,
                                      void* m_last, void* p_last,
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
  auto* Ap = static_cast<float*>(A);
  auto* bp = static_cast<float*>(b);
  auto* Cp = static_cast<float*>(C);
  auto* mp = static_cast<float*>(m_last);
  auto* pp = static_cast<float*>(p_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (model * 2 + mode) {
    case 0:
      return filter_tan_launch<Lorenz63, kKramer>(
          qc, n_steps, n_lane, r, w, t, x, th, tg, Ap, bp, Cp, mp, pp, s);
    case 1:
      return filter_tan_launch<Lorenz63, kRodeo>(
          qc, n_steps, n_lane, r, w, t, x, th, tg, Ap, bp, Cp, mp, pp, s);
    case 2:
      return filter_tan_launch<FitzHughNagumo, kKramer>(
          qc, n_steps, n_lane, r, w, t, x, th, tg, Ap, bp, Cp, mp, pp, s);
    case 3:
      return filter_tan_launch<FitzHughNagumo, kRodeo>(
          qc, n_steps, n_lane, r, w, t, x, th, tg, Ap, bp, Cp, mp, pp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
