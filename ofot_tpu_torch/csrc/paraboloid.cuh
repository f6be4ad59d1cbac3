// Projection of one point onto the Benamou-Brenier paraboloid
//
//   K = { (a, b) in R x R^K : a + |b|^2 / 2 <= 0 },
//
// shared by the fused stepB/stepC/criterion kernel (fused_pointwise.cu) and
// the standalone projection kernel (projection.cu).  It is the math of the
// TPU kernels' _project_core / _project_point_nd
// (ofot_tpu/ops/pallas/kernels.py:59-127) in the direct form of
// ofot_tpu/ops/projection.py: CUDA has cbrtf and acosf, so the Pallas
// kernels' exp/log cube root and Newton-iterated cos(acos(x)/3) are not
// needed here.

#pragma once

#include <cuda_runtime.h>

namespace ofot {

constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kTrigCoef = 1.6329931618554521f;   // 2*sqrt(2/3)
constexpr float kAcosCoef = 1.8371173070873836f;   // (3/2)^(3/2)
constexpr float kEps = 1e-20f;

// Project (alpha, beta_1..beta_K) onto K in place.  The beta direction is
// kept: every beta rescales by rho_h / rho.
template <int K>
__device__ __forceinline__ void project_point(float& a, float (&b)[K]) {
  float rho2 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) rho2 += b[c] * b[c];
  if (2.f * a + rho2 <= 0.f) return;  // inside K: the point is its own image

  const float rho = sqrtf(rho2);
  const float ap1 = a + 1.f;
  const float radicand = (4.f / 3.f) * ap1 * ap1 * ap1 + 4.5f * rho2;
  float zh;
  if (radicand > 0.f) {
    // Cardano: single real root
    const float s = 0.25f * kSqrt2 * rho + (1.f / 6.f) * sqrtf(radicand);
    const float c = cbrtf(s);
    const float c_safe = c > 0.f ? c : 1.f;
    zh = -(1.f / 3.f) * ap1 / c_safe + c;
  } else {
    // trigonometric: three real roots (alpha < -1)
    const float nam = fmaxf(-ap1, kEps);
    const float arg =
        fminf(fmaxf(kAcosCoef * rho / (nam * sqrtf(nam)), 0.f), 1.f);
    zh = kTrigCoef * sqrtf(nam) * cosf(acosf(arg) / 3.f);
  }
  const bool single = radicand > 0.f;
  a = single ? -zh * zh : -0.5f * zh * zh;
  const float rho_h = single ? kSqrt2 * zh : zh;
  // the beta direction is kept; at rho = 0 the apex case gives rho_h = 0
  const float scale = rho_h / fmaxf(rho, kEps);
#pragma unroll
  for (int c = 0; c < K; ++c) b[c] *= scale;
}

}  // namespace ofot
