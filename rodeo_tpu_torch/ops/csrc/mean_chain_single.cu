// K5a, K5b, K5c: the mean-only chain of the stationary-gain single solve
// (solve_mv_fused_stationary).  Beyond an exact Riccati prefix (K3) the
// measurement row is constant and the gain frozen, so each step is
//   mp = Q m,  z = f(mp * tv) - W mp,  m = mp + K z
// per block (the Jacobian terms of EK1's innovation cancel, so EK0 and EK1
// share the step), with no covariance algebra.
//
//   K5a mean_gain_single      replaces _mean_gain_kernel: the chain over N
//                             steps with a gain row (NB, q) per step,
//                             writing every filtered mean (N, NB, q);
//   K5b mean_boundary_single  replaces _mean_boundary_kernel: the chain
//                             with the frozen gain K* over the tail, in
//                             groups of k_group steps, storing only each
//                             group's entry state (n_group, NB, q);
//   K5c mean_recovery_single  replaces _mean_recovery_kernel: each group's
//                             k_group steps re-run from its entry state,
//                             the groups in parallel, writing the interior
//                             means (n_group * k_group, NB, q).
//
// All three in rodeo_tpu/ops/pallas_kalman.py.  Plain PyTorch twins:
// _mean_gain_plain, _mean_boundary_plain and _mean_recovery_plain in
// ops/fused_kalman.py, which run the same step (_mean_step_cols) in the
// same order.
//
// Design.  K5a and K5c run one step, mean_step below: the mean half of
// predict_block (filter_step.cuh), the model functor (models.cuh), which
// couples the blocks, and the update with a given gain, on one state of all
// NB blocks held in registers.  K5a is one thread, as its chain is serial.
// K5b splits the step over the blocks of its solve, as K3 splits its
// filter's (block_step.cuh): one CTA of NB threads in one warp (3 for
// Lorenz63, 2 for FitzHugh-Nagumo), thread b carrying only its block m[b]
// through the n_group x k_group steps.  Each step thread b computes its
// block's mp = Q m[b] and the scaled first entry mp[0] tv[0], which the
// threads exchange by warp shuffles (ShuffleExchange of the first entries:
// the vector fields read no other); each evaluates Model::f on the gathered
// entries (the same bits in every thread), keeps its own block's value and
// updates its block in mean_step's order, and at each group's start stores
// its block's row of the group's entry state.  K5c runs one thread per
// group and writes its rows straight into the (T, NB, q) layout of the
// means; the TPU kernel's (k, q, NB, G) lane layout and the transposes
// around it have no counterpart here.  K5c re-runs K5b's operations from
// K5b's own stored states, so K5b + K5c over the tail equal K5a with the
// constant gain from the same start, bit for bit.  On the TPU the
// store-free K5b was the point of the two-phase schedule (a column store
// cost more than the step); on the card a store drains while the chain goes
// on, and the schedule is kept because it is the JAX package's algorithm.
//
// What bounds them on the card.  A step's dependent chain is 10 float
// operations (Q m 3, mp tv 1, the vector field 3, z = f - W mp 1, m = mp +
// K z 2; a shuffle's latency besides in K5b), far above their byte bound
// (K5b reads 4 bytes of time a step and writes 36 bytes a group).  One
// thread carrying all blocks issues ~100 float instructions a step, and
// one warp's issue, not the chain, binds it.  Split over the blocks, a
// Lorenz63 thread issues 55 SASS instructions a step (the loop unrolled by
// 1: the shuffles, the vector field, its block's update and the loop), and
// a step takes 40 ns, ~80 cycles: the chain's 10 operations and the
// shuffle's latency on it (PERF.md).
// The k_group loop is unrolled by 8 (by 1, 2 and 4 it was 3-8 % slower, by
// 16 within 0.3 %).  The scaled IBM transition is unit upper-triangular, and
// K5b skips its 0 and 1 coefficients as the twin's _coef_mul does
// (unit_upper_matvec, 1.2-1.6 % faster than the dense matvec, PERF.md); it
// takes no other transition.  K5c: n_group threads, each a
// 64-step chain; its 36 bytes a step stored are microseconds at 3.35 TB/s,
// so it too runs at the latency of its chain.
#include <cstring>

#include <cuda_runtime.h>

#include "block_step.cuh"
#include "filter_step.cuh"
#include "kalman_cols.cuh"
#include "models.cuh"

namespace rodeo {

constexpr int kRecoveryThreads = 128;
constexpr int kBoundaryUnroll = 8;  // K5b's steps a group's loop unrolls

// The operands every mean step shares, in registers.
template <class Model, int Q>
struct MeanConsts {
  float Qm[Q][Q];
  float W[Model::NB][Q];
  float tv[Q];
  float th[Model::NTHETA];
  float K[Model::NB][Q];  // the frozen gain (K5c)
};

template <class Model, int Q>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float (&dst)[Model::NB][Q]) {
#pragma unroll
  for (int b = 0; b < Model::NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) dst[b][j] = src[b * Q + j];
}

template <class Model, int Q>
__device__ __forceinline__ void store_rows(const float (&src)[Model::NB][Q],
                                           float* __restrict__ dst) {
#pragma unroll
  for (int b = 0; b < Model::NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) dst[b * Q + j] = src[b][j];
}

template <class Model, int Q>
__device__ __forceinline__ void load_mean_consts(
    const QConst<Q>& qc, const float* __restrict__ W_in,
    const float* __restrict__ tv_in, const float* __restrict__ theta,
    const float* __restrict__ K_in, MeanConsts<Model, Q>& c) {
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) c.Qm[i][j] = qc.q[i * Q + j];
  load_rows<Model, Q>(W_in, c.W);
#pragma unroll
  for (int j = 0; j < Q; ++j) c.tv[j] = tv_in[j];
#pragma unroll
  for (int k = 0; k < Model::NTHETA; ++k) c.th[k] = theta[k];
  if (K_in != nullptr) load_rows<Model, Q>(K_in, c.K);
}

// One step of the mean chain at time t with gain K, in place on m.
template <class Model, int Q>
__device__ __forceinline__ void mean_step(const MeanConsts<Model, Q>& c,
                                          const float (&K)[Model::NB][Q],
                                          float t, float (&m)[Model::NB][Q]) {
  constexpr int NB = Model::NB;
  float mp[NB][Q], x[NB][Q], fx[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) matvec<Q>(c.Qm, m[b], mp[b]);
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < Q; ++j) x[b][j] = mp[b][j] * c.tv[j];
  Model::template f<Q>(x, c.th, t, fx);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float wm = c.W[b][0] * mp[b][0];
#pragma unroll
    for (int j = 1; j < Q; ++j) wm = wm + c.W[b][j] * mp[b][j];
    const float z = fx[b] - wm;
#pragma unroll
    for (int i = 0; i < Q; ++i) m[b][i] = mp[b][i] + K[b][i] * z;
  }
}

// K5a: the chain over n_steps from x0, the gain of step n read from
// gains[n], every filtered mean stored.
template <class Model, int Q>
__global__ void __launch_bounds__(1)
    mean_gain_kernel(QConst<Q> qc, int n_steps, const float* __restrict__ W,
                     const float* __restrict__ tv,
                     const float* __restrict__ x0,
                     const float* __restrict__ theta,
                     const float* __restrict__ tgrid,
                     const float* __restrict__ gains, float* __restrict__ mf) {
  constexpr int NB = Model::NB;
  MeanConsts<Model, Q> c;
  load_mean_consts<Model, Q>(qc, W, tv, theta, nullptr, c);
  float m[NB][Q];
  load_rows<Model, Q>(x0, m);
  for (int n = 0; n < n_steps; ++n) {
    const size_t row = static_cast<size_t>(n) * NB * Q;
    float K[NB][Q];
    load_rows<Model, Q>(gains + row, K);
    mean_step<Model, Q>(c, K, tgrid[n], m);
    store_rows<Model, Q>(m, mf + row);
  }
}

// The operands of K5b's block b, in registers.
template <class Model, int Q>
struct MeanBlockConsts {
  float Qm[Q][Q];
  float W[Q];
  float tv[Q];
  float th[Model::NTHETA];
  float K[Q];  // the frozen gain's row
};

// out = A v for a unit upper-triangular A (zeros below the diagonal, ones
// on it), without the terms the twin's _coef_mul drops or does not
// multiply: row i is v[i] + A[i][i+1] v[i+1] + ..., in the twin's order.
// On finite values it is matvec's result, bit for bit.
template <int Q>
__device__ __forceinline__ void unit_upper_matvec(const float (&A)[Q][Q],
                                                  const float (&v)[Q],
                                                  float (&out)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = v[i];
#pragma unroll
    for (int j = i + 1; j < Q; ++j) acc = acc + A[i][j] * v[j];
    out[i] = acc;
  }
}

// Whether the transition is unit upper-triangular, as the scaled IBM
// prior's is.
inline bool unit_upper(const QConst<3>& qc) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j <= i; ++j)
      if (qc.q[i * 3 + j] != (i == j ? 1.0f : 0.0f)) return false;
  return true;
}

// Block b's share of mean_step at time t, in place on its mean m, for a
// unit upper-triangular transition: the blocks' scaled first entries
// exchanged by ex, the vector field evaluated on them in every thread, its
// own block's entry kept.
template <class Model, int Q>
__device__ __forceinline__ void mean_step_block(
    const MeanBlockConsts<Model, Q>& c, ShuffleExchange<Model::NB, Q, 1>& ex,
    int b, float t, float (&m)[Q]) {
  constexpr int NB = Model::NB;
  float mp[Q], x[NB][Q], fx[NB];
  unit_upper_matvec<Q>(c.Qm, m, mp);
  ex.publish(0, b, mp, c.tv);
  ex.gather(0, x);
  Model::template f<Q>(x, c.th, t, fx);
  float wm = c.W[0] * mp[0];
#pragma unroll
  for (int j = 1; j < Q; ++j) wm = wm + c.W[j] * mp[j];
  const float z = own_block(fx, b) - wm;
#pragma unroll
  for (int i = 0; i < Q; ++i) m[i] = mp[i] + c.K[i] * z;
}

// K5b: the chain with the frozen gain over n_group groups of k_group steps
// of the tail grid tg, from m0, thread b carrying block b; group g's entry
// state goes to bnd[g].  The transition is unit upper-triangular.
template <class Model, int Q>
__global__ void __launch_bounds__(Model::NB, 1)
    mean_boundary_kernel(QConst<Q> qc, int n_group, int k_group,
                         const float* __restrict__ W,
                         const float* __restrict__ tv,
                         const float* __restrict__ m0,
                         const float* __restrict__ theta,
                         const float* __restrict__ tg,
                         const float* __restrict__ kst,
                         float* __restrict__ bnd) {
  constexpr int NB = Model::NB;
  const int b = threadIdx.x;
  MeanBlockConsts<Model, Q> c;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) c.Qm[i][j] = qc.q[i * Q + j];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    c.W[j] = W[b * Q + j];
    c.tv[j] = tv[j];
    c.K[j] = kst[b * Q + j];
  }
#pragma unroll
  for (int k = 0; k < Model::NTHETA; ++k) c.th[k] = theta[k];
  float m[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) m[j] = m0[b * Q + j];
  ShuffleExchange<NB, Q, 1> ex;
  for (int g = 0; g < n_group; ++g) {
    float* entry = bnd + (static_cast<size_t>(g) * NB + b) * Q;
#pragma unroll
    for (int j = 0; j < Q; ++j) entry[j] = m[j];
    const float* t_g = tg + static_cast<size_t>(g) * k_group;
#pragma unroll (kBoundaryUnroll)
    for (int r = 0; r < k_group; ++r)
      mean_step_block<Model, Q>(c, ex, b, t_g[r], m);
  }
}

// one CTA of NB threads, a thread per block
template <class Model>
SplitGeometry boundary_geometry() {
  return {dim3(1), dim3(Model::NB)};
}

template <class Model>
cudaError_t boundary_launch(const QConst<3>& qc, int n_group, int k_group,
                            const float* W, const float* tv, const float* m0,
                            const float* theta, const float* tg,
                            const float* kst, float* bnd,
                            cudaStream_t stream) {
  const SplitGeometry geo = boundary_geometry<Model>();
  mean_boundary_kernel<Model, 3><<<geo.grid, geo.block, 0, stream>>>(
      qc, n_group, k_group, W, tv, m0, theta, tg, kst, bnd);
  return cudaGetLastError();
}

// K5c: thread g re-runs group g's k_group steps from bnd[g] and writes rows
// g * k_group + r of the tail's means.
template <class Model, int Q>
__global__ void __launch_bounds__(kRecoveryThreads)
    mean_recovery_kernel(QConst<Q> qc, int n_group, int k_group,
                         const float* __restrict__ W,
                         const float* __restrict__ tv,
                         const float* __restrict__ bnd,
                         const float* __restrict__ theta,
                         const float* __restrict__ tg,
                         const float* __restrict__ kst,
                         float* __restrict__ mf) {
  constexpr int NB = Model::NB;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_group) return;
  MeanConsts<Model, Q> c;
  load_mean_consts<Model, Q>(qc, W, tv, theta, kst, c);
  float m[NB][Q];
  load_rows<Model, Q>(bnd + static_cast<size_t>(g) * NB * Q, m);
  const size_t first = static_cast<size_t>(g) * k_group;
  for (int r = 0; r < k_group; ++r) {
    mean_step<Model, Q>(c, c.K, tg[first + r], m);
    store_rows<Model, Q>(m, mf + (first + r) * NB * Q);
  }
}

}  // namespace rodeo

namespace {

rodeo::QConst<3> host_qconst(const void* q_host) {
  rodeo::QConst<3> qc;
  std::memcpy(qc.q, q_host, sizeof(qc.q));
  return qc;
}

const float* in(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// model: 0 Lorenz63, 1 FitzHughNagumo (the numbering of _FUNCTORS in
// ops/fused_kalman.py).  q_host points to the 3 x 3 scaled transition in
// host memory; every other pointer is device memory laid out as
// mean_gain_chain, mean_boundary_chain and mean_recovery_chain document.
// Each returns a cudaError_t.
extern "C" int rodeo_mean_gain_single(int model, int n_steps,
                                      const void* q_host, const void* W,
                                      const void* tv, const void* x0,
                                      const void* theta, const void* tgrid,
                                      const void* gains, void* mf,
                                      void* stream) {
  using namespace rodeo;
  if (n_steps < 1) return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(mf);
  switch (model) {
    case 0:
      mean_gain_kernel<Lorenz63, 3><<<1, 1, 0, s>>>(
          qc, n_steps, in(W), in(tv), in(x0), in(theta), in(tgrid),
          in(gains), out);
      break;
    case 1:
      mean_gain_kernel<FitzHughNagumo, 3><<<1, 1, 0, s>>>(
          qc, n_steps, in(W), in(tv), in(x0), in(theta), in(tgrid),
          in(gains), out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The transition must be unit upper-triangular (the scaled IBM prior's,
// _static_scaled_qconst): for another, this returns cudaErrorInvalidValue.
extern "C" int rodeo_mean_boundary_single(int model, int n_group,
                                          int k_group, const void* q_host,
                                          const void* W, const void* tv,
                                          const void* m0, const void* theta,
                                          const void* tg, const void* kst,
                                          void* bnd, void* stream) {
  using namespace rodeo;
  if (n_group < 1 || k_group < 1) return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  if (!unit_upper(qc)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(bnd);
  switch (model) {
    case 0:
      return boundary_launch<Lorenz63>(qc, n_group, k_group, in(W), in(tv),
                                       in(m0), in(theta), in(tg), in(kst),
                                       out, s);
    case 1:
      return boundary_launch<FitzHughNagumo>(qc, n_group, k_group, in(W),
                                             in(tv), in(m0), in(theta),
                                             in(tg), in(kst), out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch rodeo_mean_boundary_single makes for the model on the current
// device, as nine ints in out (report_geometry in block_step.cuh).
// Returns a cudaError_t.
extern "C" int rodeo_mean_boundary_single_geometry(int model, void* out) {
  using namespace rodeo;
  auto* o = static_cast<int*>(out);
  switch (model) {
    case 0:
      return report_geometry(mean_boundary_kernel<Lorenz63, 3>,
                             boundary_geometry<Lorenz63>(), o);
    case 1:
      return report_geometry(mean_boundary_kernel<FitzHughNagumo, 3>,
                             boundary_geometry<FitzHughNagumo>(), o);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int rodeo_mean_recovery_single(int model, int n_group,
                                          int k_group, const void* q_host,
                                          const void* W, const void* tv,
                                          const void* bnd, const void* theta,
                                          const void* tg, const void* kst,
                                          void* mf, void* stream) {
  using namespace rodeo;
  if (n_group < 1 || k_group < 1) return cudaErrorInvalidValue;
  const QConst<3> qc = host_qconst(q_host);
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(mf);
  const int n_cta = (n_group + kRecoveryThreads - 1) / kRecoveryThreads;
  switch (model) {
    case 0:
      mean_recovery_kernel<Lorenz63, 3><<<n_cta, kRecoveryThreads, 0, s>>>(
          qc, n_group, k_group, in(W), in(tv), in(bnd), in(theta), in(tg),
          in(kst), out);
      break;
    case 1:
      mean_recovery_kernel<FitzHughNagumo, 3>
          <<<n_cta, kRecoveryThreads, 0, s>>>(qc, n_group, k_group, in(W),
                                              in(tv), in(bnd), in(theta),
                                              in(tg), in(kst), out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
