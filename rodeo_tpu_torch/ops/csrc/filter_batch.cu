// K1: lane-batched forward filter of the probabilistic ODE solver, emitting
// the per-step smoothing gains (G, g, L) and the last filtered state.
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py:
// _filter_kernel_batch (emit="gains", interrogations kramer and rodeo).
// Plain PyTorch twin: _filter_batch_plain in ops/fused_kalman.py.
//
// Design.  One thread per (lane, block) carries its block of one lane (one
// independent solve) through all N steps in a single launch, split over the
// blocks as the tangent kernel K11a is, on block_step.cuh's step loop
// (split_filter_steps, which K3 runs on one lane).  The ODE
// right-hand side couples the blocks (Lorenz's f_y needs x and z), while the
// EK1 Jacobian is block-diagonal, so everything but the ODE evaluation runs
// block by block.  Each step a thread predicts its block through the
// constant scaled Pascal transition (kernel arguments, the float32 values
// the wrapper computed) plus the process noise, publishes its predicted mean
// to shared memory, forms and stores its block's smoothing gain of the
// transition n-1 -> n from the carry and the fresh prediction, and, after
// one barrier a step with the other blocks of its lane, evaluates the ODE
// (and column 0 of its Jacobian) at their gathered predicted means and does
// its block's scalar-innovation Joseph update.  The arithmetic is the
// twin's, operation for operation, so the outputs are the twin's bitwise.  Outputs are laid out (N, d,
// NB, B) with lanes innermost: a CTA holds 16 lanes, so a warp is 16
// consecutive lanes of each of two blocks, and each store is two coalesced
// 64-byte segments.  The arithmetic is float32 throughout, as on the TPU.
//
// What bounds it on the card.  A step is a chain of dependent float
// operations on one block, with the ODE at the gathered means, against 18
// floats stored per (block, lane), so the kernel is bound by the latency of
// that chain, not by device memory (its bound is the 18 x NB floats a step
// written per lane).  At 2048 lanes Lorenz63 runs 128 CTAs of 16 x 3 = 48
// threads, one on each of 128 of the card's 132 SMs.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

// Lanes per CTA: 16, faster than 32 on the card (PERF.md)
constexpr int kFilterLanes = 16;

// At 2048 lanes the launch has 128 CTAs, fewer than the SMs, so an SM never
// holds a second one: the launch bounds ask for one CTA per SM, and ptxas
// spends registers on the chain instead of spilling to fit more CTAs.
template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(kFilterLanes * Model::NB, 1)
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
  __shared__ SharedMeans<float, NB, Q, kFilterLanes> xs;
  const int tx = threadIdx.x;
  const int b = threadIdx.y;
  const int lane = blockIdx.x * kFilterLanes + tx;
  // a lane beyond n_lane runs masked (it must reach every barrier): loads
  // of the last lane, no stores
  const bool live = lane < n_lane;
  const size_t off = live ? lane : n_lane - 1;
  // stride between consecutive rows of one (step, d) slab: NB blocks x B
  const size_t col = static_cast<size_t>(NB) * n_lane;
  const size_t base = b * static_cast<size_t>(n_lane) + off;

  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k * static_cast<size_t>(n_lane) + off];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[j * col + base];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;

  SharedExchange<NB, Q, kFilterLanes> ex{xs, tx};
  split_filter_steps<Model, Q>(
      c, tgrid, n_steps, b, ex, m, P, ode_update<Model, Q, MODE>(c, th, b),
      // the gain of the transition n-1 -> n needs only the carry (filtered
      // n-1) and the fresh prediction (n)
      [&](int n, const float (&mc)[Q], const float (&Pc)[NT],
          const float (&mp)[Q], const float (&pp)[NT]) {
        float G[Q][Q], g[Q], L[NT];
        gain_cols<Q>(c.Qm, c.R, mc, Pc, mp, pp, G, g, L);
        if (live) {
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
      },
      [](int, const float (&)[Q], const float (&)[NT]) {});

  if (live) {
#pragma unroll
    for (int j = 0; j < Q; ++j) m_last[j * col + base] = m[j];
#pragma unroll
    for (int k = 0; k < NT; ++k) p_last[k * col + base] = P[k];
  }
}

template <class Model, int MODE>
cudaError_t launch(const QConst<3>& qc, int n_steps, int n_lane,
                   const float* R, const float* W, const float* tv,
                   const float* x0, const float* theta, const float* tgrid,
                   float* G, float* g, float* L, float* m_last, float* p_last,
                   cudaStream_t stream) {
  const SplitGeometry geo = split_geometry<Model, kFilterLanes>(n_lane, 1);
  filter_batch_kernel<Model, 3, MODE><<<geo.grid, geo.block, 0, stream>>>(
      qc, n_steps, n_lane, R, W, tv, x0, theta, tgrid, G, g, L, m_last,
      p_last);
  return cudaGetLastError();
}

template <class Model, int MODE>
cudaError_t filter_geometry(int n_lane, int* out) {
  return report_geometry(filter_batch_kernel<Model, 3, MODE>,
                         split_geometry<Model, kFilterLanes>(n_lane, 1), out);
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

// The launch rodeo_filter_batch makes for (model, mode, n_lane) on the
// current device, as nine ints in out (report_geometry in block_step.cuh).
// Returns a cudaError_t.
extern "C" int rodeo_filter_batch_geometry(int model, int mode, int n_lane,
                                           void* out) {
  using namespace rodeo;
  if (n_lane < 1) return cudaErrorInvalidValue;
  auto* o = static_cast<int*>(out);
  switch (model * 2 + mode) {
    case 0: return filter_geometry<Lorenz63, kKramer>(n_lane, o);
    case 1: return filter_geometry<Lorenz63, kRodeo>(n_lane, o);
    case 2: return filter_geometry<FitzHughNagumo, kKramer>(n_lane, o);
    case 3: return filter_geometry<FitzHughNagumo, kRodeo>(n_lane, o);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rodeo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
