// Calibration objective value + directional derivative (kernel K4).
//
// Replaces the Pallas TPU kernel davo_tpu/ops/calibration_obj.py::
// calibration_value_and_dirderiv (kernel body `_dirderiv_kernel`, lines
// 70-83), which evaluates davo_tpu/camera/calibration_fast.py::
// calibration_error_channel_major(..., approx_atan2=True) and its
// directional derivative along d by jax.jvp at trace time: one line-search
// probe, phi(alpha) and phi'(alpha) = grad f . d, in forward mode.  Here
// the tangent pass is written out by hand; the plain PyTorch version of the
// same derivation is davo_tpu_torch/ops/calibration_obj.py::
// _value_and_dirderiv_plain.
//
// Design: one thread per batch element, as K2.  Every intermediate of the
// objective carries its tangent beside it (forward mode), so where K2's
// reverse pass accumulates P = 45 adjoints per thread, this kernel carries
// one scalar tangent of the sum.  Clamps follow jax.jvp: max(x, floor)
// passes the whole tangent above the floor, half at a tie and none below;
// |x| passes +tangent at x = 0.  A norm at or below its floor passes no
// tangent (jax.jvp gives NaN there: the 0 tangent of sqrt(0) times its
// infinite slope).  Parameters and the direction are (B, P) batch-major and
// are staged in turn through one [P][kBlock] shared tile for coalesced
// loads; the observations are channel-major (M, N, B), so a warp reads 32
// consecutive floats.
//
// What bounds it on this card: bytes.  An element reads 2P + 3MN floats
// (parameters, direction, u, v, vis) and writes 2 (error, dphi): 752 bytes
// at M = 4, N = 8, P = 45, 12.3 MB at B = 16384, about 3.7 us at 3.35 TB/s.
// Its ~8.9 k float32 operations an element (counted in chip_smoke.py::
// k4_operations) take about 2.2 us at 67 TFLOP/s.  One thread per element
// keeps only B threads in flight, so like K2 this first version is
// latency-bound well above both.

#include <cuda_runtime.h>

#include "calibration_common.cuh"

namespace {

constexpr int kDirBlock = 128;

// the tangent of max(x, floor), as jax.jvp takes it
__device__ __forceinline__ float max_tangent(float x, float floor, float tangent) {
  return x > floor ? tangent : (x == floor ? 0.5f * tangent : 0.f);
}

// the tangent of |x|, as jax.jvp takes it (+tangent at x = 0)
__device__ __forceinline__ float abs_tangent(float x, float tangent) {
  return x >= 0.f ? tangent : -tangent;
}

// out = a x b
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <int M, int N>
__global__ void __launch_bounds__(kDirBlock) calibration_dirderiv_kernel(
    const float* __restrict__ params, const float* __restrict__ direction,
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ vis,
    float* __restrict__ err, float* __restrict__ dphi, int B) {
  constexpr int P = 3 + 3 * N + 6 * (M - 1);
  constexpr int kT = 3 + 3 * N;          // first translation
  constexpr int kR = kT + 3 * (M - 1);   // first rotation
  __shared__ float tile[P * kDirBlock];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kDirBlock;
  const int nb = min(kDirBlock, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  float p[P], dp[P];
  for (int e = tid; e < nb * P; e += kDirBlock) {
    const int el = e / P;
    tile[(e - el * P) * kDirBlock + el] = params[base + e];
  }
  __syncthreads();
  if (tid < nb) {
#pragma unroll
    for (int k = 0; k < P; ++k) p[k] = tile[k * kDirBlock + tid];
  }
  __syncthreads();
  for (int e = tid; e < nb * P; e += kDirBlock) {
    const int el = e / P;
    tile[(e - el * P) * kDirBlock + el] = direction[base + e];
  }
  __syncthreads();
  if (tid >= nb) return;
#pragma unroll
  for (int k = 0; k < P; ++k) dp[k] = tile[k * kDirBlock + tid];
  const int b = b0 + tid;

  // ---- gauge rescale inv_scale = 1 / max(overall, 1e-6)
  float abs_w = 0.f, d_abs_w = 0.f, abs_t = 0.f, d_abs_t = 0.f;
#pragma unroll
  for (int k = 3; k < kT; ++k) {
    abs_w += fabsf(p[k]);
    d_abs_w += abs_tangent(p[k], dp[k]);
  }
#pragma unroll
  for (int k = kT; k < kR; ++k) {
    abs_t += fabsf(p[k]);
    d_abs_t += abs_tangent(p[k], dp[k]);
  }
  const float overall = (abs_w / N / 3.f * N + abs_t / (3.f * (M - 1)) * M) / (N + M);
  const float d_overall = (d_abs_w / N / 3.f * N + d_abs_t / (3.f * (M - 1)) * M) / (N + M);
  const float inv_scale = 1.f / fmaxf(overall, 1e-6f);
  const float d_inv_scale = -inv_scale * inv_scale * max_tangent(overall, 1e-6f, d_overall);

  // ---- focal length elu(f) + 1
  const float f = p[0], cx = p[1], cy = p[2];
  const float focal = f > 0.f ? f + 1.f : expf(f);
  const float d_focal = f > 0.f ? dp[0] : focal * dp[0];

  float total = 0.f, d_total = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float o[3] = {0.f, 0.f, 0.f}, d_o[3] = {0.f, 0.f, 0.f};
    float T[3] = {0.f, 0.f, 0.f}, d_T[3] = {0.f, 0.f, 0.f};
    float f1 = 0.f, f4 = 0.f, cos_t = 1.f, d_f1 = 0.f, d_f4 = 0.f, d_cos = 0.f;
    if (m > 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int kr = kR + 3 * (m - 1) + i, kt = kT + 3 * (m - 1) + i;
        o[i] = p[kr];
        d_o[i] = dp[kr];
        T[i] = p[kt] * inv_scale;
        d_T[i] = dp[kt] * inv_scale + p[kt] * d_inv_scale;
      }
      const float s = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
      const float d_s = 2.f * (o[0] * d_o[0] + o[1] * d_o[1] + o[2] * d_o[2]);
      f1 = sinc_sq(s);
      f4 = one_minus_cos_sq(s);
      // f1' = cos_sin_sq / 2, f4' = sin_cubed_sq / 2, cos = 1 - s f4
      d_f1 = 0.5f * cos_sin_sq(s) * d_s;
      d_f4 = 0.5f * sin_cubed_sq(s) * d_s;
      cos_t = 1.f - s * f4;
      d_cos = -(d_s * f4 + s * d_f4);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float w[3], d_w[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int k = 3 + 3 * n + i;
        w[i] = p[k] * inv_scale;
        d_w[i] = dp[k] * inv_scale + p[k] * d_inv_scale;
      }
      // ---- camera-relative point q = W cos + f4 (W.o) o + f1 (o x W) + T
      float q[3], d_q[3];
      if (m == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          q[i] = w[i];
          d_q[i] = d_w[i];
        }
      } else {
        const float dot = w[0] * o[0] + w[1] * o[1] + w[2] * o[2];
        const float d_dot = d_w[0] * o[0] + d_w[1] * o[1] + d_w[2] * o[2] +
                            w[0] * d_o[0] + w[1] * d_o[1] + w[2] * d_o[2];
        float c[3], c1[3], c2[3];
        cross3(o, w, c);
        cross3(d_o, w, c1);
        cross3(o, d_w, c2);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          q[i] = w[i] * cos_t + f4 * dot * o[i] + c[i] * f1 + T[i];
          d_q[i] = d_w[i] * cos_t + w[i] * d_cos + (d_f4 * dot + f4 * d_dot) * o[i] +
                   f4 * dot * d_o[i] + (c1[i] + c2[i]) * f1 + c[i] * d_f1 + d_T[i];
        }
      }
      const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
      const float inv_qn = 1.f / fmaxf(qn, kNormFloor);
      const float d_qn = qn > 0.f ? (q[0] * d_q[0] + q[1] * d_q[1] + q[2] * d_q[2]) / qn : 0.f;
      const float d_inv_qn = -inv_qn * inv_qn * max_tangent(qn, kNormFloor, d_qn);
      // ---- unit ray a = (u - cx, v - cy, f') / |.|
      const size_t idx = static_cast<size_t>(m * N + n) * B + b;
      const float r[3] = {u[idx] - cx, v[idx] - cy, focal};
      const float d_r[3] = {-dp[1], -dp[2], d_focal};
      const float rn = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
      const float inv_rn = 1.f / fmaxf(rn, kNormFloor);
      const float d_rn = rn > 0.f ? (r[0] * d_r[0] + r[1] * d_r[1] + r[2] * d_r[2]) / rn : 0.f;
      const float d_inv_rn = -inv_rn * inv_rn * max_tangent(rn, kNormFloor, d_rn);
      // ---- Kahan angle theta = 2 atan2(|a - b|, |a + b|), b = q / |q|
      float dm[3], sm[3], d_dm[3], d_sm[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a = r[i] * inv_rn, d_a = d_r[i] * inv_rn + r[i] * d_inv_rn;
        const float bq = q[i] * inv_qn, d_bq = d_q[i] * inv_qn + q[i] * d_inv_qn;
        dm[i] = a - bq;
        sm[i] = a + bq;
        d_dm[i] = d_a - d_bq;
        d_sm[i] = d_a + d_bq;
      }
      const float d2 = dm[0] * dm[0] + dm[1] * dm[1] + dm[2] * dm[2];
      const float s2 = sm[0] * sm[0] + sm[1] * sm[1] + sm[2] * sm[2];
      const float diff = d2 > 0.f ? sqrtf(d2) : 0.f;
      const float summ = s2 > 0.f ? sqrtf(s2) : 0.f;
      // guarded sqrt: d sqrt(x) = dx / (2 sqrt(x)), 0 at 0; dx = 2 dm . d_dm
      const float d_diff = d2 > 0.f ? (dm[0] * d_dm[0] + dm[1] * d_dm[1] + dm[2] * d_dm[2]) / diff : 0.f;
      const float d_summ = s2 > 0.f ? (sm[0] * d_sm[0] + sm[1] * d_sm[1] + sm[2] * d_sm[2]) / summ : 0.f;
      float p_diff, p_summ;
      const float angle = atan2_poly(diff, summ, p_diff, p_summ);
      const float weight = vis[idx];
      total += 2.f * angle * weight;
      d_total += 2.f * (p_diff * d_diff + p_summ * d_summ) * weight;
    }
  }
  err[b] = total;
  dphi[b] = d_total;
}

template <int M, int N>
int launch(const float* params, const float* direction, const float* u, const float* v,
           const float* vis, float* err, float* dphi, int B, cudaStream_t stream) {
  const int grid = (B + kDirBlock - 1) / kDirBlock;
  calibration_dirderiv_kernel<M, N><<<grid, kDirBlock, 0, stream>>>(params, direction, u, v, vis, err, dphi, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scene size compiled in: (M, N) = (4, 8), as K2.  Others return
// cudaErrorInvalidValue.
extern "C" int davo_calibration_value_and_dirderiv(const void* params, const void* direction,
                                                   const void* u, const void* v, const void* vis,
                                                   void* err, void* dphi, int B, int M, int N,
                                                   void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(params);
  const auto* df = static_cast<const float*>(direction);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(vis);
  auto* ef = static_cast<float*>(err);
  auto* of = static_cast<float*>(dphi);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 4 && N == 8) return launch<4, 8>(pf, df, uf, vf, wf, ef, of, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
