// Calibration objective value + full parameter gradient (kernel K2).
//
// Replaces the Pallas TPU kernel davo_tpu/ops/calibration_obj.py::
// calibration_value_and_grad (kernel body `_vg_kernel`, lines 55-67), which
// evaluates davo_tpu/camera/calibration_fast.py::
// calibration_error_channel_major(..., approx_atan2=True) and takes its
// gradient from jax.vjp at trace time.  Here the reverse pass is written
// out by hand; the plain PyTorch version of the same derivation is
// davo_tpu_torch/ops/calibration_obj.py::_value_and_grad_plain.
//
// Per batch element (one thread each): P = 3 + 3N + 6(M-1) parameters
// (f, cx, cy | N world points | M-1 translations | M-1 axis-angles);
// observations u, v, vis are channel-major (M, N, B).  The objective is a
// sum over (view, point) terms, each depending on the parameters only
// through the shared gauge scale, the focal length, the principal point,
// one world point and one pose.  So the reverse pass of a term runs right
// after its forward pass, while its intermediates are still in registers,
// and accumulates into per-thread gradient registers; only the gauge
// scale's chain (through |w| and |t|) is closed at the end.  Nothing is
// stored between the two passes.
//
// Order of the forward pass (and, reversed, of the hand-written adjoint):
//   gauge rescale  inv_scale = 1 / max(mean|coord|, 1e-6)
//   focal          f' = f > 0 ? f + 1 : exp(f)           (elu(f) + 1)
//   ray            a = (u - cx, v - cy, f') / max(|.|, eps)
//   Rodrigues      q = W cos + f4 (W.o) o + f1 (o x W) + T   (squared angle)
//   Kahan angle    theta = 2 atan2(|a - b|, |a + b|),  b = q / max(|q|, eps)
//   atan2          first-quadrant cephes polynomial (as the TPU kernel)
//
// What bounds it: bytes, narrowly.  An element reads ~564 bytes
// (parameters and observations) and writes ~184 (error and gradient), and
// does ~8 k float32 operations (counted in chip_smoke.py::k2_operations):
// at the card's published peaks (3.35 TB/s, 67 TFLOP/s float32) the bytes
// take about twice as long as the operations.  One thread per element
// keeps every intermediate in registers, at the cost of few threads in
// flight (B of them), so this first version is latency-bound well above
// either time.  Parameters and gradients are (B, P) batch-major, staged
// through shared memory in a [P][kBlock] layout for coalesced access.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
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

__device__ __forceinline__ float signf(float x) { return (x > 0.f) - (x < 0.f); }

template <int M, int N>
__global__ void __launch_bounds__(kBlock) calibration_vg_kernel(
    const float* __restrict__ params, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ vis, float* __restrict__ err,
    float* __restrict__ grad, int B) {
  constexpr int P = 3 + 3 * N + 6 * (M - 1);
  constexpr int kT = 3 + 3 * N;          // first translation
  constexpr int kR = kT + 3 * (M - 1);   // first rotation
  __shared__ float tile[P * kBlock];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kBlock;
  const int nb = min(kBlock, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int e = tid; e < nb * P; e += kBlock) {
    const int el = e / P;
    tile[(e - el * P) * kBlock + el] = params[base + e];
  }
  __syncthreads();

  if (tid < nb) {
    const int b = b0 + tid;
    float p[P], gp[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      p[k] = tile[k * kBlock + tid];
      gp[k] = 0.f;
    }

    // gauge rescale
    float abs_w = 0.f, abs_t = 0.f;
#pragma unroll
    for (int k = 3; k < kT; ++k) abs_w += fabsf(p[k]);
#pragma unroll
    for (int k = kT; k < kR; ++k) abs_t += fabsf(p[k]);
    const float overall = (abs_w / (3.f * N) * N + abs_t / (3.f * (M - 1)) * M) / (N + M);
    const float inv_scale = 1.f / fmaxf(overall, 1e-6f);

    const float f = p[0], cx = p[1], cy = p[2];
    const float focal = f > 0.f ? f + 1.f : expf(f);
    const float d_focal = f > 0.f ? 1.f : focal;

    // gp[3 + 3n + i] first accumulates the gradient w.r.t. the rescaled
    // point W = w inv_scale; the rescale's chain is applied at the end
    float g_inv_scale = 0.f, g_focal = 0.f, g_cx = 0.f, g_cy = 0.f, total = 0.f;

#pragma unroll
    for (int m = 0; m < M; ++m) {
      float o[3] = {0.f, 0.f, 0.f}, T[3] = {0.f, 0.f, 0.f};
      float s_ang = 0.f, cos_t = 1.f, f1 = 0.f, f4 = 0.f;
      if (m > 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          o[i] = p[kR + 3 * (m - 1) + i];
          T[i] = p[kT + 3 * (m - 1) + i] * inv_scale;
        }
        s_ang = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
        f1 = sinc_sq(s_ang);
        f4 = one_minus_cos_sq(s_ang);
        cos_t = 1.f - s_ang * f4;
      }
      float g_cos = 0.f, g_f1 = 0.f, g_f4 = 0.f;
      float g_o[3] = {0.f, 0.f, 0.f}, g_T[3] = {0.f, 0.f, 0.f};

#pragma unroll
      for (int n = 0; n < N; ++n) {
        float w[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) w[i] = p[3 + 3 * n + i] * inv_scale;
        const int kW = 3 + 3 * n;  // this point's slot in gp
        // ---- forward: camera-relative point q
        float q[3], c[3] = {0.f, 0.f, 0.f}, dot = 0.f;
        if (m == 0) {
          q[0] = w[0];
          q[1] = w[1];
          q[2] = w[2];
        } else {
          dot = w[0] * o[0] + w[1] * o[1] + w[2] * o[2];
          c[0] = o[1] * w[2] - o[2] * w[1];
          c[1] = o[2] * w[0] - o[0] * w[2];
          c[2] = o[0] * w[1] - o[1] * w[0];
#pragma unroll
          for (int i = 0; i < 3; ++i) q[i] = w[i] * cos_t + f4 * dot * o[i] + c[i] * f1 + T[i];
        }
        const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
        const float inv_qn = 1.f / fmaxf(qn, kNormFloor);
        // ---- forward: unit ray a and unit point direction bq
        const size_t idx = static_cast<size_t>(m * N + n) * B + b;
        const float r[3] = {u[idx] - cx, v[idx] - cy, focal};
        const float rn = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
        const float inv_rn = 1.f / fmaxf(rn, kNormFloor);
        float a[3], bq[3], dm[3], sm[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a[i] = r[i] * inv_rn;
          bq[i] = q[i] * inv_qn;
          dm[i] = a[i] - bq[i];
          sm[i] = a[i] + bq[i];
        }
        const float d2 = dm[0] * dm[0] + dm[1] * dm[1] + dm[2] * dm[2];
        const float s2 = sm[0] * sm[0] + sm[1] * sm[1] + sm[2] * sm[2];
        const float diff = d2 > 0.f ? sqrtf(d2) : 0.f;
        const float summ = s2 > 0.f ? sqrtf(s2) : 0.f;
        float d_diff, d_summ;
        const float angle = atan2_poly(diff, summ, d_diff, d_summ);
        const float weight = vis[idx];
        total += 2.f * angle * weight;

        // ---- reverse: theta -> |a - b|^2, |a + b|^2 (guarded sqrt)
        const float g_d2 = d2 > 0.f ? weight * d_diff / diff : 0.f;  // 2 w d_diff / (2 diff)
        const float g_s2 = s2 > 0.f ? weight * d_summ / summ : 0.f;
        float g_a[3], g_b[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          g_a[i] = 2.f * (g_d2 * dm[i] + g_s2 * sm[i]);
          g_b[i] = 2.f * (g_s2 * sm[i] - g_d2 * dm[i]);
        }
        // ---- reverse: normalisations (the max() passes the norm's
        // gradient only above the floor)
        const float ga_a = rn > kNormFloor ? g_a[0] * a[0] + g_a[1] * a[1] + g_a[2] * a[2] : 0.f;
        const float gb_b = qn > kNormFloor ? g_b[0] * bq[0] + g_b[1] * bq[1] + g_b[2] * bq[2] : 0.f;
        float g_q[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) g_q[i] = inv_qn * (g_b[i] - bq[i] * gb_b);
        g_cx -= inv_rn * (g_a[0] - a[0] * ga_a);
        g_cy -= inv_rn * (g_a[1] - a[1] * ga_a);
        g_focal += inv_rn * (g_a[2] - a[2] * ga_a);
        // ---- reverse: Rodrigues
        if (m == 0) {
#pragma unroll
          for (int i = 0; i < 3; ++i) gp[kW + i] += g_q[i];
        } else {
          const float gq_o = g_q[0] * o[0] + g_q[1] * o[1] + g_q[2] * o[2];
          const float g_dot = f4 * gq_o;
          g_cos += g_q[0] * w[0] + g_q[1] * w[1] + g_q[2] * w[2];
          g_f4 += gq_o * dot;
          g_f1 += g_q[0] * c[0] + g_q[1] * c[1] + g_q[2] * c[2];
          float g_c[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) g_c[i] = f1 * g_q[i];
          // c = o x W:  dc.o -> W x g_c,  dc.W -> g_c x o
          g_o[0] += f4 * dot * g_q[0] + g_dot * w[0] + (w[1] * g_c[2] - w[2] * g_c[1]);
          g_o[1] += f4 * dot * g_q[1] + g_dot * w[1] + (w[2] * g_c[0] - w[0] * g_c[2]);
          g_o[2] += f4 * dot * g_q[2] + g_dot * w[2] + (w[0] * g_c[1] - w[1] * g_c[0]);
          gp[kW + 0] += g_q[0] * cos_t + g_dot * o[0] + (g_c[1] * o[2] - g_c[2] * o[1]);
          gp[kW + 1] += g_q[1] * cos_t + g_dot * o[1] + (g_c[2] * o[0] - g_c[0] * o[2]);
          gp[kW + 2] += g_q[2] * cos_t + g_dot * o[2] + (g_c[0] * o[1] - g_c[1] * o[0]);
#pragma unroll
          for (int i = 0; i < 3; ++i) g_T[i] += g_q[i];
        }
      }
      if (m > 0) {
        // cos = 1 - s f4(s); f4' = sin_cubed_sq / 2; f1' = cos_sin_sq / 2
        const float g_omc = g_f4 - s_ang * g_cos;
        const float g_s = -f4 * g_cos + 0.5f * g_omc * sin_cubed_sq(s_ang) +
                          0.5f * g_f1 * cos_sin_sq(s_ang);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          gp[kR + 3 * (m - 1) + i] = g_o[i] + 2.f * g_s * o[i];
          gp[kT + 3 * (m - 1) + i] = g_T[i] * inv_scale;
          g_inv_scale += g_T[i] * p[kT + 3 * (m - 1) + i];
        }
      }
    }

    // ---- reverse: gauge rescale W = w inv_scale, inv_scale = 1/max(overall, 1e-6)
#pragma unroll
    for (int k = 3; k < kT; ++k) {
      g_inv_scale += gp[k] * p[k];
      gp[k] *= inv_scale;
    }
    const float g_overall = overall > 1e-6f ? -g_inv_scale * inv_scale * inv_scale : 0.f;
    const float g_abs_w = g_overall * N / (N + M) / (3.f * N);
    const float g_abs_t = g_overall * M / (N + M) / (3.f * (M - 1));
#pragma unroll
    for (int k = 3; k < kT; ++k) gp[k] += g_abs_w * signf(p[k]);
#pragma unroll
    for (int k = kT; k < kR; ++k) gp[k] += g_abs_t * signf(p[k]);
    gp[0] = g_focal * d_focal;
    gp[1] = g_cx;
    gp[2] = g_cy;

    err[b] = total;
#pragma unroll
    for (int k = 0; k < P; ++k) tile[k * kBlock + tid] = gp[k];
  }
  __syncthreads();
  for (int e = tid; e < nb * P; e += kBlock) {
    const int el = e / P;
    grad[base + e] = tile[(e - el * P) * kBlock + el];
  }
}

template <int M, int N>
int launch(const float* params, const float* u, const float* v, const float* vis,
           float* err, float* grad, int B, cudaStream_t stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  calibration_vg_kernel<M, N><<<grid, kBlock, 0, stream>>>(params, u, v, vis, err, grad, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scene size compiled in: (M, N) = (4, 8), the served model's and the bench
// shape's.  Others return cudaErrorInvalidValue.
extern "C" int davo_calibration_value_and_grad(const void* params, const void* u,
                                               const void* v, const void* vis, void* err,
                                               void* grad, int B, int M, int N,
                                               void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(params);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(vis);
  auto* ef = static_cast<float*>(err);
  auto* gf = static_cast<float*>(grad);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 4 && N == 8) return launch<4, 8>(pf, uf, vf, wf, ef, gf, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
