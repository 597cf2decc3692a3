// Device helpers shared by the calibration objective kernels K2
// (calibration_obj.cu) and K4 (calibration_dirderiv.cu): the float32
// forms of davo_tpu/utils/stable_trig.py's squared-angle ratios and the
// first-quadrant polynomial atan2 of davo_tpu/camera/calibration_fast.py,
// with its partial derivatives along the same where-branches.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNormFloor = 2.220446049250313e-16f;
constexpr float kTanPi8 = 0.41421356237309503f;
constexpr float kPi4 = 0.7853981633974483f;
constexpr float kPi2 = 1.5707963267948966f;
constexpr float kSmallSq = 0.0025f;    // 0.05^2
constexpr float kSmallSqF3 = 0.0625f;  // 0.25^2
constexpr float kAtan0 = 8.05374449538e-2f;
constexpr float kAtan1 = -1.38776856032e-1f;
constexpr float kAtan2 = 1.99777106478e-1f;
constexpr float kAtan3 = -3.33329491539e-1f;

// squared-angle ratios (davo_tpu/utils/stable_trig.py), x = sqrt(s)
__device__ __forceinline__ float sinc_sq(float s) {
  if (s < kSmallSq) return 1.f + s * (-1.f / 6.f + s * (1.f / 120.f + s * (-1.f / 5040.f)));
  const float x = sqrtf(s);
  return sinf(x) / x;
}

__device__ __forceinline__ float one_minus_cos_sq(float s) {
  if (s < kSmallSq) return 0.5f + s * (-1.f / 24.f + s * (1.f / 720.f + s * (-1.f / 40320.f)));
  const float h = sinf(0.5f * sqrtf(s));
  return 2.f * h * h / s;
}

__device__ __forceinline__ float cos_sin_sq(float s) {
  if (s < kSmallSq)
    return -1.f / 3.f + s * (1.f / 30.f + s * (-1.f / 840.f + s * (1.f / 45360.f)));
  const float x = sqrtf(s);
  return (cosf(x) - sinf(x) / x) / s;
}

__device__ __forceinline__ float sin_cubed_sq(float s) {
  if (s < kSmallSqF3)
    return -1.f / 12.f + s * (1.f / 180.f + s * (-1.f / 6720.f + s * (1.f / 453600.f)));
  const float x = sqrtf(s);
  const float h = sinf(0.5f * x);
  return (sinf(x) / x - 4.f * h * h / s) / s;
}

// atan2(y, x) for y, x >= 0 by the cephes polynomial, with its partial
// derivatives (dy, dx) along the same where-branches.
__device__ __forceinline__ float atan2_poly(float y, float x, float& dy, float& dx) {
  const bool swap = y > x;
  const float num = swap ? x : y;
  const float den_raw = swap ? y : x;
  const float den = fmaxf(den_raw, 1e-30f);
  const float t = num / den;
  const bool reduced = t > kTanPi8;
  const float tr = reduced ? (t - 1.f) / (t + 1.f) : t;
  const float z = tr * tr;
  float p = kAtan0 * z + kAtan1;
  p = p * z + kAtan2;
  p = p * z + kAtan3;
  const float a = p * z * tr + tr + (reduced ? kPi4 : 0.f);
  // d/dtr (p(z) z tr + tr) = 1 + 3 z p + 2 z^2 p'(z)
  const float dp = (3.f * kAtan0 * z + 2.f * kAtan1) * z + kAtan2;
  const float g_tr = (swap ? -1.f : 1.f) * (1.f + 3.f * z * p + 2.f * z * z * dp);
  const float g_t = reduced ? g_tr * 2.f / ((t + 1.f) * (t + 1.f)) : g_tr;
  const float g_num = g_t / den;
  const float g_den = den_raw > 1e-30f ? -g_t * t / den : 0.f;
  dy = swap ? g_den : g_num;
  dx = swap ? g_num : g_den;
  return swap ? kPi2 - a : a;
}

}  // namespace
