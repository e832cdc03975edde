// ODE right-hand sides as device functors for the filter kernel.
//
// A functor has NB variables and NTHETA parameters, and two static device
// functions on one lane's state:
//   f(x, th, t, out)     out[b] = f_b(x, theta, t), x[b][j] being the j-th
//                        derivative of variable b in original coordinates;
//   jac0(x, th, t, out)  out[b] = d f_b / d x[b][0], column 0 of the
//                        block-diagonal Jacobian.  Columns j > 0 are zero
//                        for these first-order systems, and the kernel
//                        skips them as the plain path's jac_flat does.
// Each one does the arithmetic of its *_flat counterpart in
// rodeo_tpu_torch/models/, in the same order.
#pragma once

#include <cuda_runtime.h>

namespace rodeo {

// rodeo_tpu_torch/models/lorenz.py: lorenz_flat, lorenz_jac_flat
struct Lorenz63 {
  static constexpr int NB = 3;
  static constexpr int NTHETA = 3;

  template <int Q>
  __device__ __forceinline__ static void f(const float (&x)[NB][Q],
                                           const float (&th)[NTHETA], float t,
                                           float (&out)[NB]) {
    const float X = x[0][0], Y = x[1][0], Z = x[2][0];
    const float rho = th[0], sigma = th[1], beta = th[2];
    out[0] = -sigma * X + sigma * Y;
    out[1] = rho * X - Y - X * Z;
    out[2] = -beta * Z + X * Y;
  }

  template <int Q>
  __device__ __forceinline__ static void jac0(const float (&x)[NB][Q],
                                              const float (&th)[NTHETA],
                                              float t, float (&out)[NB]) {
    out[0] = -th[1];
    out[1] = -1.0f;
    out[2] = -th[2];
  }
};

// rodeo_tpu_torch/models/fitzhugh.py: fitzhugh_flat, fitzhugh_jac_flat
struct FitzHughNagumo {
  static constexpr int NB = 2;
  static constexpr int NTHETA = 3;

  template <int Q>
  __device__ __forceinline__ static void f(const float (&x)[NB][Q],
                                           const float (&th)[NTHETA], float t,
                                           float (&out)[NB]) {
    const float V = x[0][0], R = x[1][0];
    const float a = th[0], b = th[1], c = th[2];
    out[0] = c * (V - V * V * V / 3.0f + R);
    out[1] = -(V - a + b * R) / c;
  }

  template <int Q>
  __device__ __forceinline__ static void jac0(const float (&x)[NB][Q],
                                              const float (&th)[NTHETA],
                                              float t, float (&out)[NB]) {
    const float V = x[0][0];
    out[0] = th[2] * (1.0f - V * V);
    out[1] = -th[1] / th[2];
  }
};

}  // namespace rodeo
