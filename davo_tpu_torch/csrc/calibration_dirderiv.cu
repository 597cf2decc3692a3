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
// Every intermediate of the objective carries its tangent beside it
// (forward mode), so where K2's reverse pass accumulates P = 45 adjoints,
// this kernel carries one scalar tangent of the sum.  Clamps follow
// jax.jvp: max(x, floor) passes the whole tangent above the floor, half at
// a tie and none below; |x| passes +tangent at x = 0.  A norm at or below
// its floor passes no tangent (jax.jvp gives NaN there: the 0 tangent of
// sqrt(0) times its infinite slope).
//
// What bounds it on this card: bytes.  An element reads 2P + 3MN floats
// (parameters, direction, u, v, vis) and writes 2 (error, dphi): 752 bytes
// at M = 4, N = 8, P = 45, 12.3 MB at B = 16384, about 3.7 us at 3.35 TB/s.
// Its ~8.9 k float32 operations an element (counted in chip_smoke.py::
// k4_operations) take about 2.2 us at 67 TFLOP/s.  At B = 8192-16384 that
// work is small enough that latency sets what the card reaches: the first
// port ran one thread per element (128 blocks of 128 threads at B = 16384,
// under one wave of 132 SMs), each a serial chain of ~8.9 k operations.
//
// The design is K2's (calibration_obj.cu): a warp per element, a lane per
// (view m, point n) term at M N = 32 (compiled for (4, 8), the bench
// shape), so the card runs 32 B threads and each chain is 1/32 as long:
//   - a block takes kWarps = 8 consecutive elements (256 threads); it
//     stages their parameters and direction ((B, P) batch-major, 8 P
//     contiguous floats each) and their observations (per term 8
//     consecutive floats) through shared memory with coalesced loads;
//   - the gauge sums of |w|, |t| and of their tangents are xor-butterfly
//     sums (lane l holds coordinate l), so every lane holds the same
//     inv_scale and d_inv_scale;
//   - each lane runs its term's value and tangent; view 0 runs the same
//     code with o = 0 and T = 0, which give q = W and dq = dW exactly;
//     the rotated views' four ratios come from one sincosf and one sinf
//     (pose_ratios);
//   - the error and dphi are summed over the warp in a fixed butterfly
//     order, and lane 0 writes them.
// Every lane of a block reaches every shuffle: the ragged last block's idle
// warps run on zeros and write nothing.

//
// Every other scene size with M >= 2, N >= 1 and M N <= kMaxTerms = 256
// takes the general kernel below (M and N at run time), which the same
// entry point launches with the same term code (term_value_and_tangent):
// a warp's lanes walk its element's terms in chunks of 32 (lane l takes
// terms l, l + 32, ...; spare lanes run term 0 with weight 0), sum their
// values and tangents in registers and meet in the butterfly; the gauge
// sums take lane l's coordinates l, l + 32, ... first.  Its shared memory
// is dynamic: 8 x 2P + 27 M N floats a block (up to 123 KB, at (256, 1)).
// It is written to be right at every size, not tuned.

#include <cuda_runtime.h>

#include "calibration_common.cuh"

namespace {

constexpr int kWarps = 8;  // elements a block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kObsStride = kWarps + 1;  // [term][element] rows, padded: no bank conflicts
constexpr int kMaxTerms = 256;          // the general kernel's largest M N

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

// An element's gauge rescale and focal length, with their tangents.
struct ElementScale {
  float inv_scale, d_inv_scale, focal, d_focal;
};

__device__ __forceinline__ ElementScale element_scale(const float* pe, const float* de, float abs_w,
                                                      float d_abs_w, float abs_t, float d_abs_t,
                                                      int M, int N) {
  ElementScale e;
  const float overall = (abs_w / N / 3.f * N + abs_t / (3.f * (M - 1)) * M) / (N + M);
  const float d_overall = (d_abs_w / N / 3.f * N + d_abs_t / (3.f * (M - 1)) * M) / (N + M);
  e.inv_scale = 1.f / fmaxf(overall, 1e-6f);
  e.d_inv_scale = -e.inv_scale * e.inv_scale * max_tangent(overall, 1e-6f, d_overall);
  // ---- focal length elu(f) + 1
  const float f = pe[0];
  e.focal = f > 0.f ? f + 1.f : expf(f);
  e.d_focal = f > 0.f ? de[0] : e.focal * de[0];
  return e;
}

// Term (m, n) of the element whose parameters and direction are ``pe`` and
// ``de`` (the first translation at kT, the first rotation at kR): its
// value 2 angle weight and that value's tangent.  View 0 runs the same
// code with o = 0 and T = 0, which give q = W and dq = dW exactly.
__device__ __forceinline__ void term_value_and_tangent(const float* pe, const float* de, int kT,
                                                       int kR, int m, int n, const ElementScale& e,
                                                       float u, float v, float weight,
                                                       float& value, float& tangent) {
  const float inv_scale = e.inv_scale, d_inv_scale = e.d_inv_scale;
  const float cx = pe[1], cy = pe[2];
  // ---- this term's pose (view 0: o = 0, T = 0) and point
  float o[3] = {0.f, 0.f, 0.f}, d_o[3] = {0.f, 0.f, 0.f};
  float T[3] = {0.f, 0.f, 0.f}, d_T[3] = {0.f, 0.f, 0.f};
  if (m > 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int kr = kR + 3 * (m - 1) + i, kt = kT + 3 * (m - 1) + i;
      o[i] = pe[kr];
      d_o[i] = de[kr];
      T[i] = pe[kt] * inv_scale;
      d_T[i] = de[kt] * inv_scale + pe[kt] * d_inv_scale;
    }
  }
  float w[3], d_w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k = 3 + 3 * n + i;
    w[i] = pe[k] * inv_scale;
    d_w[i] = de[k] * inv_scale + pe[k] * d_inv_scale;
  }
  const float s = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  const float d_s = 2.f * (o[0] * d_o[0] + o[1] * d_o[1] + o[2] * d_o[2]);
  float f1, f4, cs_sq, sc3_sq;
  pose_ratios(s, f1, f4, cs_sq, sc3_sq);
  // f1' = cos_sin_sq / 2, f4' = sin_cubed_sq / 2, cos = 1 - s f4
  const float d_f1 = 0.5f * cs_sq * d_s;
  const float d_f4 = 0.5f * sc3_sq * d_s;
  const float cos_t = 1.f - s * f4;
  const float d_cos = -(d_s * f4 + s * d_f4);

  // ---- camera-relative point q = W cos + f4 (W.o) o + f1 (o x W) + T
  const float dot = w[0] * o[0] + w[1] * o[1] + w[2] * o[2];
  const float d_dot = d_w[0] * o[0] + d_w[1] * o[1] + d_w[2] * o[2] + w[0] * d_o[0] +
                      w[1] * d_o[1] + w[2] * d_o[2];
  float c[3], c1[3], c2[3];
  cross3(o, w, c);
  cross3(d_o, w, c1);
  cross3(o, d_w, c2);
  float q[3], d_q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q[i] = w[i] * cos_t + f4 * dot * o[i] + c[i] * f1 + T[i];
    d_q[i] = d_w[i] * cos_t + w[i] * d_cos + (d_f4 * dot + f4 * d_dot) * o[i] +
             f4 * dot * d_o[i] + (c1[i] + c2[i]) * f1 + c[i] * d_f1 + d_T[i];
  }
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
  const float inv_qn = 1.f / fmaxf(qn, kNormFloor);
  const float d_qn = qn > 0.f ? (q[0] * d_q[0] + q[1] * d_q[1] + q[2] * d_q[2]) / qn : 0.f;
  const float d_inv_qn = -inv_qn * inv_qn * max_tangent(qn, kNormFloor, d_qn);
  // ---- unit ray a = (u - cx, v - cy, f') / |.|
  const float r[3] = {u - cx, v - cy, e.focal};
  const float d_r[3] = {-de[1], -de[2], e.d_focal};
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
  value = 2.f * angle * weight;
  tangent = 2.f * (p_diff * d_diff + p_summ * d_summ) * weight;
}

template <int M, int N>
__global__ void __launch_bounds__(kThreads) calibration_dirderiv_kernel(
    const float* __restrict__ params, const float* __restrict__ direction,
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ vis,
    float* __restrict__ err, float* __restrict__ dphi, int B) {
  static_assert(M * N == 32 && (N & (N - 1)) == 0, "one lane per (view, point) term");
  constexpr int P = 3 + 3 * N + 6 * (M - 1);
  constexpr int kT = 3 + 3 * N;          // first translation
  constexpr int kR = kT + 3 * (M - 1);   // first rotation
  constexpr int kObs = 32 * kObsStride;  // one channel of observations
  __shared__ float p_sh[kWarps * P];     // [element][P]
  __shared__ float d_sh[kWarps * P];     // the direction, [element][P]
  __shared__ float obs_sh[3 * kObs];     // u, v, vis: [term][element]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kWarps;
  const int nb = min(kWarps, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int k = tid; k < kWarps * P; k += kThreads) {
    const bool in = k < nb * P;
    p_sh[k] = in ? params[base + k] : 0.f;
    d_sh[k] = in ? direction[base + k] : 0.f;
  }
  for (int k = tid; k < 32 * kWarps; k += kThreads) {
    const int term = k / kWarps;
    const int el = k - term * kWarps;
    const size_t idx = static_cast<size_t>(term) * B + b0 + el;
    const bool in = el < nb;
    obs_sh[term * kObsStride + el] = in ? u[idx] : 0.f;
    obs_sh[kObs + term * kObsStride + el] = in ? v[idx] : 0.f;
    obs_sh[2 * kObs + term * kObsStride + el] = in ? vis[idx] : 0.f;
  }
  __syncthreads();

  const float* pe = p_sh + warp * P;
  const float* de = d_sh + warp * P;
  const int m = lane / N;  // view
  const int n = lane % N;  // point

  // ---- gauge rescale inv_scale = 1 / max(overall, 1e-6): lane l holds
  // coordinate l of the points and of the translations, summed over the warp
  const bool has_w = lane < 3 * N, has_t = lane < 3 * (M - 1);
  const float abs_w = lane_sum<1, 32>(has_w ? fabsf(pe[3 + lane]) : 0.f);
  const float d_abs_w = lane_sum<1, 32>(has_w ? abs_tangent(pe[3 + lane], de[3 + lane]) : 0.f);
  const float abs_t = lane_sum<1, 32>(has_t ? fabsf(pe[kT + lane]) : 0.f);
  const float d_abs_t = lane_sum<1, 32>(has_t ? abs_tangent(pe[kT + lane], de[kT + lane]) : 0.f);
  const ElementScale e = element_scale(pe, de, abs_w, d_abs_w, abs_t, d_abs_t, M, N);

  const int obs = lane * kObsStride + warp;
  float value, tangent;
  term_value_and_tangent(pe, de, kT, kR, m, n, e, obs_sh[obs], obs_sh[kObs + obs],
                         obs_sh[2 * kObs + obs], value, tangent);

  // ---- the element's sums over the warp
  const float total = lane_sum<1, 32>(value);
  const float d_total = lane_sum<1, 32>(tangent);
  if (lane == 0 && warp < nb) {
    err[b0 + warp] = total;
    dphi[b0 + warp] = d_total;
  }
}

// The general kernel: any M >= 2, N >= 1 with M N <= kMaxTerms, at run
// time.  Dynamic shared memory, per block: parameters and direction rows
// (kWarps x P each) and the observations (3 x M N x kObsStride).
__global__ void __launch_bounds__(kThreads) calibration_dirderiv_general_kernel(
    const float* __restrict__ params, const float* __restrict__ direction,
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ vis,
    float* __restrict__ err, float* __restrict__ dphi, int B, int M, int N) {
  extern __shared__ float smem[];
  const int MN = M * N;
  const int P = 3 + 3 * N + 6 * (M - 1);
  const int kT = 3 + 3 * N;          // first translation
  const int kR = kT + 3 * (M - 1);   // first rotation
  const int kObs = MN * kObsStride;  // one channel of observations
  float* p_sh = smem;                // [element][P]
  float* d_sh = p_sh + kWarps * P;   // the direction, [element][P]
  float* obs_sh = d_sh + kWarps * P;  // u, v, vis: [term][element]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kWarps;
  const int nb = min(kWarps, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int k = tid; k < kWarps * P; k += kThreads) {
    const bool in = k < nb * P;
    p_sh[k] = in ? params[base + k] : 0.f;
    d_sh[k] = in ? direction[base + k] : 0.f;
  }
  for (int k = tid; k < MN * kWarps; k += kThreads) {
    const int term = k / kWarps;
    const int el = k - term * kWarps;
    const size_t idx = static_cast<size_t>(term) * B + b0 + el;
    const bool in = el < nb;
    obs_sh[term * kObsStride + el] = in ? u[idx] : 0.f;
    obs_sh[kObs + term * kObsStride + el] = in ? v[idx] : 0.f;
    obs_sh[2 * kObs + term * kObsStride + el] = in ? vis[idx] : 0.f;
  }
  __syncthreads();

  const float* pe = p_sh + warp * P;
  const float* de = d_sh + warp * P;

  // ---- gauge rescale: lane l sums coordinates l, l + 32, ... of the
  // points and of the translations, then the warp's butterfly
  float part_w = 0.f, part_dw = 0.f, part_t = 0.f, part_dt = 0.f;
  for (int k = 3 + lane; k < 3 + 3 * N; k += 32) {
    part_w += fabsf(pe[k]);
    part_dw += abs_tangent(pe[k], de[k]);
  }
  for (int k = kT + lane; k < kR; k += 32) {
    part_t += fabsf(pe[k]);
    part_dt += abs_tangent(pe[k], de[k]);
  }
  const float abs_w = lane_sum<1, 32>(part_w);
  const float d_abs_w = lane_sum<1, 32>(part_dw);
  const float abs_t = lane_sum<1, 32>(part_t);
  const float d_abs_t = lane_sum<1, 32>(part_dt);
  const ElementScale e = element_scale(pe, de, abs_w, d_abs_w, abs_t, d_abs_t, M, N);

  float total = 0.f, d_total = 0.f;
  for (int t0 = 0; t0 < MN; t0 += 32) {
    const int term = t0 + lane;
    const bool active = term < MN;
    const int obs = (active ? term : 0) * kObsStride + warp;
    float value, tangent;
    term_value_and_tangent(pe, de, kT, kR, active ? term / N : 0, active ? term % N : 0, e,
                           obs_sh[obs], obs_sh[kObs + obs], active ? obs_sh[2 * kObs + obs] : 0.f,
                           value, tangent);
    total += value;
    d_total += tangent;
  }
  // ---- the element's sums over the warp
  total = lane_sum<1, 32>(total);
  d_total = lane_sum<1, 32>(d_total);
  if (lane == 0 && warp < nb) {
    err[b0 + warp] = total;
    dphi[b0 + warp] = d_total;
  }
}

template <int M, int N>
int launch(const float* params, const float* direction, const float* u, const float* v,
           const float* vis, float* err, float* dphi, int B, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  calibration_dirderiv_kernel<M, N><<<grid, kThreads, 0, stream>>>(params, direction, u, v, vis, err, dphi, B);
  return static_cast<int>(cudaGetLastError());
}

int launch_general(const float* params, const float* direction, const float* u, const float* v,
                   const float* vis, float* err, float* dphi, int B, int M, int N,
                   cudaStream_t stream) {
  const int P = 3 + 3 * N + 6 * (M - 1);
  const size_t shared = sizeof(float) * (kWarps * 2 * P + 3 * M * N * kObsStride);
  const cudaError_t attr = cudaFuncSetAttribute(calibration_dirderiv_general_kernel,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(shared));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (B + kWarps - 1) / kWarps;
  calibration_dirderiv_general_kernel<<<grid, kThreads, shared, stream>>>(params, direction, u, v, vis, err, dphi,
                                                                          B, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (M, N) = (4, 8) runs its own instantiation, as K2; any other M >= 2,
// N >= 1 with M N <= 256 the general kernel.  Others return
// cudaErrorInvalidValue.
extern "C" int davo_calibration_value_and_dirderiv(const void* params, const void* direction,
                                                   const void* u, const void* v, const void* vis,
                                                   void* err, void* dphi, int B, int M, int N,
                                                   void* stream) {
  if (B <= 0 || M < 2 || N < 1 || M * N > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(params);
  const auto* df = static_cast<const float*>(direction);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(vis);
  auto* ef = static_cast<float*>(err);
  auto* of = static_cast<float*>(dphi);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 4 && N == 8) return launch<4, 8>(pf, df, uf, vf, wf, ef, of, B, st);
  return launch_general(pf, df, uf, vf, wf, ef, of, B, M, N, st);
}
