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
// Joseph update; predict, interrogate, update and the gains are the step
// that K8 and the tangent kernel K11a share (filter_step.cuh).  Outputs are
// laid out (N, d, NB, B) with lanes innermost, so the threads of a warp
// store 32 neighbouring floats.  The arithmetic is float32 throughout, as on
// the TPU.
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

#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kFilterThreads = 32;

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
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      predict_block<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b]);
      // the gain of the transition n-1 -> n needs only the carry (filtered
      // n-1) and the fresh prediction (n)
      float G[Q][Q], g[Q], L[NT];
      gain_cols<Q>(c.Qm, c.R[b], m[b], P[b], mp[b], pp[b], G, g, L);
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
    float z[NB], S[NB], inv_S[NB];
    interrogate_update<Model, Q, MODE>(c, th, tgrid[n], mp, pp, m, P, z, S,
                                       inv_S);
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
