// ODE right-hand sides as device functors for the filter kernel.
//
// A functor has NB variables and NTHETA parameters, its number kNumber (that
// of _FUNCTORS in ops/fused_kalman.py), and static device functions on one
// lane's state:
//   f(x, th, t, out)     out[b] = f_b(x, theta, t), x[b][j] being the j-th
//                        derivative of variable b in original coordinates;
//   jac0(x, th, t, out)  out[b] = d f_b / d x[b][0], column 0 of the
//                        block-diagonal Jacobian.  Columns j > 0 are zero
//                        for these systems (f reads x[b][0] alone), and the
//                        kernel skips them as the plain path's jac_flat
//                        does.
// A functor with kDualJacobian has no jac0: the kernel evaluates f on Duals
// instead, seeding the thread's own block (jac0_own of block_step.cuh), as
// its twin's jac_flat does on ops/dual.py's Duals.
// Each one does the arithmetic of its *_flat counterpart in
// rodeo_tpu_torch/models/, in the same order, on the scalar type T of its
// arguments: float, or Dual (dual.cuh) in the tangent kernels, where theta
// carries the tangent of its direction.  The functors written for K1 and K3
// alone take the state (T) and theta (TH) as separate types, so that a Dual
// state meets a float theta as the twin's Dual meets a constant tensor.
// A functor without parameters has NTHETA = 1 (a zero-length array is
// ill-formed), the lanes' theta a row of zeros.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace rodeo {

// rodeo_tpu_torch/models/lorenz.py: lorenz_flat, lorenz_jac_flat
struct Lorenz63 {
  static constexpr int kNumber = 0;
  static constexpr bool kDualJacobian = false;
  static constexpr int NB = 3;
  static constexpr int NTHETA = 3;

  template <int Q, class T>
  __device__ __forceinline__ static void f(const T (&x)[NB][Q],
                                           const T (&th)[NTHETA], float t,
                                           T (&out)[NB]) {
    const T X = x[0][0], Y = x[1][0], Z = x[2][0];
    const T rho = th[0], sigma = th[1], beta = th[2];
    out[0] = -sigma * X + sigma * Y;
    out[1] = rho * X - Y - X * Z;
    out[2] = -beta * Z + X * Y;
  }

  template <int Q, class T>
  __device__ __forceinline__ static void jac0(const T (&x)[NB][Q],
                                              const T (&th)[NTHETA], float t,
                                              T (&out)[NB]) {
    out[0] = -th[1];
    out[1] = -T(1.0f);
    out[2] = -th[2];
  }
};

// rodeo_tpu_torch/models/fitzhugh.py: fitzhugh_flat, fitzhugh_jac_flat
struct FitzHughNagumo {
  static constexpr int kNumber = 1;
  static constexpr bool kDualJacobian = false;
  static constexpr int NB = 2;
  static constexpr int NTHETA = 3;

  template <int Q, class T>
  __device__ __forceinline__ static void f(const T (&x)[NB][Q],
                                           const T (&th)[NTHETA], float t,
                                           T (&out)[NB]) {
    const T V = x[0][0], R = x[1][0];
    const T a = th[0], b = th[1], c = th[2];
    out[0] = c * (V - V * V * V * (1.0f / 3.0f) + R);
    out[1] = -(V - a + b * R) / c;
  }

  template <int Q, class T>
  __device__ __forceinline__ static void jac0(const T (&x)[NB][Q],
                                              const T (&th)[NTHETA], float t,
                                              T (&out)[NB]) {
    const T V = x[0][0];
    out[0] = th[2] * (1.0f - V * V);
    out[1] = -th[1] / th[2];
  }
};

// rodeo_tpu_torch/models/chkrebtii.py: chkrebtii_flat, chkrebtii_jac_flat.
// x'' = sin(2 t) - x, one block of q = 4 or 5 derivatives; the only functor
// that reads t, through sinf, which rounds as PyTorch's CUDA sin does.
struct Chkrebtii {
  static constexpr int kNumber = 2;
  static constexpr bool kDualJacobian = false;
  static constexpr int NB = 1;
  static constexpr int NTHETA = 1;

  template <int Q, class T, class TH>
  __device__ __forceinline__ static void f(const T (&x)[NB][Q],
                                           const TH (&)[NTHETA], float t,
                                           T (&out)[NB]) {
    out[0] = sinf(2.0f * t) - x[0][0];
  }

  template <int Q, class T>
  __device__ __forceinline__ static void jac0(const T (&)[NB][Q],
                                              const T (&)[NTHETA], float,
                                              T (&out)[NB]) {
    out[0] = T(-1.0f);
  }
};

// rodeo_tpu_torch/models/hes1.py: hes1_flat, on the log scale; its
// Jacobian by Duals
struct Hes1 {
  static constexpr int kNumber = 3;
  static constexpr bool kDualJacobian = true;
  static constexpr int NB = 3;
  static constexpr int NTHETA = 7;

  template <int Q, class T, class TH>
  __device__ __forceinline__ static void f(const T (&x)[NB][Q],
                                           const TH (&th)[NTHETA], float,
                                           T (&out)[NB]) {
    const T P = exp_of(x[0][0]), M = exp_of(x[1][0]), H = exp_of(x[2][0]);
    const TH a = th[0], b = th[1], c = th[2], d = th[3], e = th[4], f = th[5],
             g = th[6];
    const T one_p2 = 1.0f + P * P;
    out[0] = -a * H + b * M / P - c;
    out[1] = -d + e / one_p2 / M;
    out[2] = -a * P + f / (H * one_p2) - g;
  }
};

// rodeo_tpu_torch/models/seirah.py: seirah_flat; its Jacobian by Duals
struct Seirah {
  static constexpr int kNumber = 4;
  static constexpr bool kDualJacobian = true;
  static constexpr int NB = 6;
  static constexpr int NTHETA = 6;

  template <int Q, class T, class TH>
  __device__ __forceinline__ static void f(const T (&x)[NB][Q],
                                           const TH (&th)[NTHETA], float,
                                           T (&out)[NB]) {
    // 1 / D_H, D_H = 30 the fixed hospitalisation duration: a product, as
    // PyTorch on CUDA takes the twin's division by a number
    constexpr float kInvDH = static_cast<float>(1.0 / 30.0);
    const T S = x[0][0], E = x[1][0], I = x[2][0], R = x[3][0], A = x[4][0],
            H = x[5][0];
    const TH b = th[0], r = th[1], alpha = th[2], D_e = th[3], D_I = th[4],
             D_q = th[5];
    const T N = S + E + I + R + A + H;
    const T inf = b * S * (I + alpha * A) / N;
    out[0] = -inf;
    out[1] = inf - E / D_e;
    out[2] = r * E / D_e - I / D_q - I / D_I;
    out[3] = (I + A) / D_I + H * kInvDH;
    out[4] = (1.0f - r) * E / D_e - A / D_I;
    out[5] = I / D_q - H * kInvDH;
  }
};

}  // namespace rodeo
