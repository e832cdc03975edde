// K3: the single-solve forward filter of the probabilistic ODE solver,
// storing the filtered and predicted moments of steps 1..N: mf, mp
// (N, NB, q) and packed pf, pp (N, NB, n_tri).
//
// Replaces the TPU kernel rodeo_tpu/ops/pallas_kalman.py: _filter_kernel
// (interrogations kramer and rodeo).  Plain PyTorch twin:
// _filter_single_plain in ops/fused_kalman.py.
//
// What bounds it on the card.  One solve is one chain of ~1e3 float
// operations a step through N steps, far above its byte bound (54 floats
// stored per step at 3 blocks, 2.2 MB at 10 000 steps, 0.65 us at 3.35
// TB/s): nothing in one solve runs beside the chain, so the kernel runs at
// the pace at which one warp issues the step's instructions and waits on
// their latencies.  Many solves at once are the lane-batched K1's work.
//
// Design.  K1's step split over the blocks (block_step.cuh's
// split_filter_steps) at a single lane: one CTA of NB threads (3 for
// Lorenz63), one per block of the solve, all in one warp.  Each thread
// predicts its own block, publishes its predicted mean, and after the
// step's one exchange evaluates the ODE on the gathered means (identical
// bits in every thread) and updates its own block
// (interrogate_update_block), so a thread's stream of instructions is
// about a third of the one thread's that carried all blocks; each thread
// stores its block's four moments of each step in the JAX package's (N,
// NB, d) layout, which the stores drain while the next step computes.  The
// means go from thread to thread by warp shuffles (ShuffleExchange): on the
// card, shared memory behind __syncwarp took 16 % longer (PERF.md).  The
// values are the twin's bitwise.  The TPU kernel's chunk grid (which streamed
// VMEM blocks to HBM) and its unroll option have no counterpart here.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

template <class Model, int Q, int MODE>
__global__ void __launch_bounds__(Model::NB, 1)
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
  const int b = threadIdx.x;
  BlockConsts<Q> c;
  load_block_consts<Q>(qc, R_in, W_in, tv_in, b, c);
  float th[NTH];
#pragma unroll
  for (int k = 0; k < NTH; ++k) th[k] = theta[k];

  float m[Q], P[NT];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = x0[b * Q + j];
#pragma unroll
  for (int k = 0; k < NT; ++k) P[k] = 0.0f;

  // block b's moments of step n (row n of the outputs)
  auto store = [&](float* mo, float* po, int n,
                   const float (&mv)[Q], const float (&Pv)[NT]) {
    const size_t row = static_cast<size_t>(n) * NB + b;
#pragma unroll
    for (int j = 0; j < Q; ++j) mo[row * Q + j] = mv[j];
#pragma unroll
    for (int k = 0; k < NT; ++k) po[row * NT + k] = Pv[k];
  };
  auto predicted = [&](int n, const float (&)[Q], const float (&)[NT],
                       const float (&mp)[Q], const float (&pp)[NT]) {
    store(mp_out, pp_out, n, mp, pp);
  };
  auto filtered = [&](int n, const float (&mv)[Q], const float (&Pv)[NT]) {
    store(mf, pf, n, mv, Pv);
  };
  ShuffleExchange<NB, Q> ex;
  split_filter_steps<Model, Q>(c, tgrid, n_steps, b, ex, m, P,
                               ode_update<Model, Q, MODE>(c, th, b),
                               predicted, filtered);
}

// one CTA of NB threads, a thread per block
template <class Model>
SplitGeometry single_geometry() {
  return {dim3(1), dim3(Model::NB)};
}

template <class Model, int MODE>
cudaError_t launch_single(const QConst<3>& qc, int n_steps, const float* R,
                          const float* W, const float* tv, const float* x0,
                          const float* theta, const float* tgrid, float* mf,
                          float* pf, float* mp, float* pp, cudaStream_t stream) {
  const SplitGeometry geo = single_geometry<Model>();
  filter_single_kernel<Model, 3, MODE><<<geo.grid, geo.block, 0, stream>>>(
      qc, n_steps, R, W, tv, x0, theta, tgrid, mf, pf, mp, pp);
  return cudaGetLastError();
}

template <class Model, int MODE>
cudaError_t single_geometry_report(int* out) {
  return report_geometry(filter_single_kernel<Model, 3, MODE>,
                         single_geometry<Model>(), out);
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

// The launch rodeo_filter_single makes for (model, mode) on the current
// device, as nine ints in out (report_geometry in block_step.cuh).
// Returns a cudaError_t.
extern "C" int rodeo_filter_single_geometry(int model, int mode, void* out) {
  using namespace rodeo;
  auto* o = static_cast<int*>(out);
  switch (model * 2 + mode) {
    case 0: return single_geometry_report<Lorenz63, kKramer>(o);
    case 1: return single_geometry_report<Lorenz63, kRodeo>(o);
    case 2: return single_geometry_report<FitzHughNagumo, kKramer>(o);
    case 3: return single_geometry_report<FitzHughNagumo, kRodeo>(o);
    default: return cudaErrorInvalidValue;
  }
}
