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
// Per batch element: P = 3 + 3N + 6(M-1) parameters (f, cx, cy | N world
// points | M-1 translations | M-1 axis-angles); observations u, v, vis
// are channel-major (M, N, B).  The objective is a sum of M N (view,
// point) terms, each depending on the parameters only through the shared
// gauge scale, the focal length, the principal point, one world point and
// one pose.
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
// take about twice as long as the operations, 0.0018 ms at B = 8192.  At
// the served batch the work is small enough that what the card can reach
// is set by latency: the first port ran one thread per element (B threads,
// 64 blocks at B = 8192, fewer than the 132 SMs), each a serial chain of
// ~8 k operations.
//
// The design splits an element over a warp, one lane per (view m, point
// n) term at M N = 32 (compiled for (4, 8), the served and bench shape), so
// the card runs 32 B threads and each chain is 1/32 as long:
//   - a block takes kWarps = 8 consecutive elements (256 threads); it
//     stages their parameters ((B, P) batch-major, 8 P contiguous floats)
//     and their observations (per term 8 consecutive floats: whole 32-byte
//     sectors) through shared memory with coalesced loads;
//   - each lane runs its term's forward pass and, while the intermediates
//     are in registers, its reverse pass; view 0 runs the same code with
//     o = 0 and T = 0, which give q = W and g_W = g_q exactly;
//   - the shared partials are reduced with xor-butterfly shuffles, a fixed
//     order that leaves the same bits on every lane it spans: the error,
//     g_focal, g_cx and g_cy over the warp; a point's gradient over the M
//     lanes that share n; a pose's g_T, g_o, g_cos, g_f1 and g_f4 over the
//     N lanes that share m; then the gauge's chain over the warp;
//   - the gauge sums |w| and |t| are xor-butterfly sums too (lane l holds
//     coordinate l), so every lane holds the same scale;
//   - a lane's pose ratios take one sincosf and one sinf (pose_ratios), not
//     the seven sines and cosines of the four helpers called apart.
// Every lane of a block reaches every shuffle and barrier: the ragged last
// block's idle warps run on zeros and write nothing.  At 64 registers a
// lane four blocks fit an SM, so B = 8192 runs in two waves and the time
// grows with B: the lanes' instruction streams (divisions, sines, shuffles),
// not the bytes, set it.

//
// Every other scene size with M >= 2, N >= 1 and M N <= kMaxTerms = 256
// takes the general kernel below (M and N at run time), which the same
// entry point launches.  It runs the same term code (term_value_and_grad):
//   - a warp still takes one element; its lanes walk the terms in chunks
//     of 32 (lane l takes terms l, l + 32, ...; when M N < 32 the spare
//     lanes run term 0 with weight 0 and add nothing);
//   - the error, g_focal, g_cx and g_cy accumulate in a lane's registers
//     over its terms, then meet in the warp's butterfly;
//   - a chunk's point and pose partials go through a (32 x 12) shared
//     scratch: point n's owner (lane n % 32) adds its terms' g_W in
//     ascending m, pose m's owner (lane m % 32) its g_o, g_T, g_cos, g_f1
//     and g_f4 in ascending n, into the element's rows in shared memory;
//     a fixed order, each sum on one lane;
//   - the gauge sums take lane l's coordinates l, l + 32, ... before the
//     butterfly; the gauge's chain likewise sums the owners' points and
//     poses;
//   - shared memory grows with the size (dynamic: 8 x (2P + 3(M - 1) +
//     384) + 27 M N floats, 163 KB a block at the largest P, (M, N) =
//     (256, 1); 34 KB at (4, 32)).
// It is written to be right at every size, not tuned.

#include <cuda_runtime.h>

#include "calibration_common.cuh"

namespace {

constexpr int kWarps = 8;  // elements a block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kObsStride = kWarps + 1;  // [term][element] rows, padded: no bank conflicts
constexpr int kMaxTerms = 256;          // the general kernel's largest M N
constexpr int kPartials = 12;           // a term's point (3) and pose (9) partials

__device__ __forceinline__ float signf(float x) { return (x > 0.f) - (x < 0.f); }

// One (view m, point n) term's value and partials.
struct TermGrad {
  float value;      // 2 angle weight
  float g_ray[3];   // d value / d(u - cx, v - cy, f')
  float g_w[3];     // d value / dW, W the rescaled point
  float g_pose[9];  // g_o, g_T, then g_cos, g_f1, g_f4 (the pose's ratios)
  float s_ang, f4, cs_sq, sc3_sq;  // the pose's squared angle and ratios
  float o[3], t_raw[3], w_raw[3];  // the pose's rotation and raw translation, the raw point
};

// Term (m, n) of the element whose parameters are ``pe`` (the first
// translation at kT, the first rotation at kR): its forward pass and, while
// the intermediates are in registers, its reverse pass.  View 0 runs the
// same code with o = 0 and T = 0, which give q = W and g_W = g_q exactly.
__device__ __forceinline__ void term_value_and_grad(const float* pe, int kT, int kR, int m, int n,
                                                    float inv_scale, float focal, float cx,
                                                    float cy, float u, float v, float weight,
                                                    TermGrad& g) {
  // this term's pose (view 0: o = 0, T = 0) and point
  float* o = g.o;
  float T[3], w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = m > 0 ? pe[kR + 3 * (m - 1) + i] : 0.f;
    g.t_raw[i] = m > 0 ? pe[kT + 3 * (m - 1) + i] : 0.f;
    T[i] = g.t_raw[i] * inv_scale;
    g.w_raw[i] = pe[3 + 3 * n + i];
    w[i] = g.w_raw[i] * inv_scale;
  }
  const float s_ang = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  float f1, f4;
  pose_ratios(s_ang, f1, f4, g.cs_sq, g.sc3_sq);
  g.s_ang = s_ang;
  g.f4 = f4;
  const float cos_t = 1.f - s_ang * f4;

  // ---- forward: camera-relative point q
  const float dot = w[0] * o[0] + w[1] * o[1] + w[2] * o[2];
  const float c[3] = {o[1] * w[2] - o[2] * w[1], o[2] * w[0] - o[0] * w[2],
                      o[0] * w[1] - o[1] * w[0]};
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = w[i] * cos_t + f4 * dot * o[i] + c[i] * f1 + T[i];
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
  const float inv_qn = 1.f / fmaxf(qn, kNormFloor);
  // ---- forward: unit ray a and unit point direction bq
  const float r[3] = {u - cx, v - cy, focal};
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
  g.value = 2.f * angle * weight;

  // ---- reverse: theta -> |a - b|^2, |a + b|^2 (guarded sqrt)
  const float g_d2 = d2 > 0.f ? weight * d_diff / diff : 0.f;  // 2 w d_diff / (2 diff)
  const float g_s2 = s2 > 0.f ? weight * d_summ / summ : 0.f;
  float g_a[3], g_b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_a[i] = 2.f * (g_d2 * dm[i] + g_s2 * sm[i]);
    g_b[i] = 2.f * (g_s2 * sm[i] - g_d2 * dm[i]);
  }
  // ---- reverse: normalisations (the max() passes the norm's gradient
  // only above the floor)
  const float ga_a = rn > kNormFloor ? g_a[0] * a[0] + g_a[1] * a[1] + g_a[2] * a[2] : 0.f;
  const float gb_b = qn > kNormFloor ? g_b[0] * bq[0] + g_b[1] * bq[1] + g_b[2] * bq[2] : 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) g.g_ray[i] = inv_rn * (g_a[i] - a[i] * ga_a);
  float g_q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_q[i] = inv_qn * (g_b[i] - bq[i] * gb_b);
  // ---- reverse: Rodrigues (view 0: g_W = g_q; its pose terms unused)
  const float gq_o = g_q[0] * o[0] + g_q[1] * o[1] + g_q[2] * o[2];
  const float g_dot = f4 * gq_o;
  float g_c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_c[i] = f1 * g_q[i];
  // c = o x W:  dc.o -> W x g_c,  dc.W -> g_c x o
  g.g_w[0] = g_q[0] * cos_t + g_dot * o[0] + (g_c[1] * o[2] - g_c[2] * o[1]);
  g.g_w[1] = g_q[1] * cos_t + g_dot * o[1] + (g_c[2] * o[0] - g_c[0] * o[2]);
  g.g_w[2] = g_q[2] * cos_t + g_dot * o[2] + (g_c[0] * o[1] - g_c[1] * o[0]);
  // the pose's partials: g_o, g_T, then g_cos, g_f1, g_f4
  g.g_pose[0] = f4 * dot * g_q[0] + g_dot * w[0] + (w[1] * g_c[2] - w[2] * g_c[1]);
  g.g_pose[1] = f4 * dot * g_q[1] + g_dot * w[1] + (w[2] * g_c[0] - w[0] * g_c[2]);
  g.g_pose[2] = f4 * dot * g_q[2] + g_dot * w[2] + (w[0] * g_c[1] - w[1] * g_c[0]);
  g.g_pose[3] = g_q[0];
  g.g_pose[4] = g_q[1];
  g.g_pose[5] = g_q[2];
  g.g_pose[6] = g_q[0] * w[0] + g_q[1] * w[1] + g_q[2] * w[2];
  g.g_pose[7] = g_q[0] * c[0] + g_q[1] * c[1] + g_q[2] * c[2];
  g.g_pose[8] = gq_o * dot;
}

// The reverse pass through a pose's trigonometric ratios (cos = 1 - s
// f4(s); f4' = sin_cubed_sq / 2; f1' = cos_sin_sq / 2): d value / d s.
__device__ __forceinline__ float ratios_adjoint(float s_ang, float f4, float cs_sq, float sc3_sq,
                                                float g_cos, float g_f1, float g_f4) {
  const float g_omc = g_f4 - s_ang * g_cos;
  return -f4 * g_cos + 0.5f * g_omc * sc3_sq + 0.5f * g_f1 * cs_sq;
}

// The gauge rescale inv_scale = 1 / max(overall, 1e-6) from the summed
// |coordinates| of the points and translations.
__device__ __forceinline__ float gauge_overall(float abs_w, float abs_t, int M, int N) {
  return (abs_w / (3.f * N) * N + abs_t / (3.f * (M - 1)) * M) / (N + M);
}

template <int M, int N>
__global__ void __launch_bounds__(kThreads) calibration_vg_kernel(
    const float* __restrict__ params, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ vis, float* __restrict__ err,
    float* __restrict__ grad, int B) {
  static_assert(M * N == 32 && (N & (N - 1)) == 0, "one lane per (view, point) term");
  constexpr int P = 3 + 3 * N + 6 * (M - 1);
  constexpr int kT = 3 + 3 * N;          // first translation
  constexpr int kR = kT + 3 * (M - 1);   // first rotation
  constexpr int kObs = 32 * kObsStride;  // one channel of observations
  __shared__ float p_sh[kWarps * P];     // [element][P]
  __shared__ float g_sh[kWarps * P];     // the gradient, [element][P]
  __shared__ float obs_sh[3 * kObs];     // u, v, vis: [term][element]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kWarps;
  const int nb = min(kWarps, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int k = tid; k < kWarps * P; k += kThreads) p_sh[k] = k < nb * P ? params[base + k] : 0.f;
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
  const int m = lane / N;  // view
  const int n = lane % N;  // point

  // gauge rescale: lane l holds |coordinate l| of the points and of the
  // translations, summed over the warp
  const float abs_w = lane_sum<1, 32>(lane < 3 * N ? fabsf(pe[3 + lane]) : 0.f);
  const float abs_t = lane_sum<1, 32>(lane < 3 * (M - 1) ? fabsf(pe[kT + lane]) : 0.f);
  const float overall = gauge_overall(abs_w, abs_t, M, N);
  const float inv_scale = 1.f / fmaxf(overall, 1e-6f);

  const float f = pe[0], cx = pe[1], cy = pe[2];
  const float focal = f > 0.f ? f + 1.f : expf(f);
  const float d_focal = f > 0.f ? 1.f : focal;

  const int obs = lane * kObsStride + warp;
  TermGrad g;
  term_value_and_grad(pe, kT, kR, m, n, inv_scale, focal, cx, cy, obs_sh[obs], obs_sh[kObs + obs],
                      obs_sh[2 * kObs + obs], g);

  // ---- reductions: the element's sums over the warp, a point's over the
  // M lanes that share n, a pose's over the N lanes that share m
  const float total = lane_sum<1, 32>(g.value);
  const float g_cx = lane_sum<1, 32>(-g.g_ray[0]);
  const float g_cy = lane_sum<1, 32>(-g.g_ray[1]);
  const float g_focal = lane_sum<1, 32>(g.g_ray[2]);
  float g_w[3], g_pose[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_w[i] = lane_sum<N, 32>(g.g_w[i]);
#pragma unroll
  for (int k = 0; k < 9; ++k) g_pose[k] = lane_sum<1, N>(g.g_pose[k]);

  const float g_s = ratios_adjoint(g.s_ang, g.f4, g.cs_sq, g.sc3_sq, g_pose[6], g_pose[7], g_pose[8]);
  // ---- reverse: gauge rescale W = w inv_scale, T = t inv_scale,
  // inv_scale = 1/max(overall, 1e-6): each point once (view 0's lanes),
  // each translation once (point 0's lanes of the other views)
  const float* w_raw = g.w_raw;
  const float* t_raw = g.t_raw;
  float g_inv = 0.f;
  if (m == 0) g_inv = g_w[0] * w_raw[0] + g_w[1] * w_raw[1] + g_w[2] * w_raw[2];
  if (m > 0 && n == 0)
    g_inv = g_pose[3] * t_raw[0] + g_pose[4] * t_raw[1] + g_pose[5] * t_raw[2];
  const float g_inv_scale = lane_sum<1, 32>(g_inv);
  const float g_overall = overall > 1e-6f ? -g_inv_scale * inv_scale * inv_scale : 0.f;
  const float g_abs_w = g_overall * N / (N + M) / (3.f * N);
  const float g_abs_t = g_overall * M / (N + M) / (3.f * (M - 1));

  float* ge = g_sh + warp * P;
  if (m == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) ge[3 + 3 * n + i] = g_w[i] * inv_scale + g_abs_w * signf(w_raw[i]);
  }
  if (m > 0 && n == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ge[kT + 3 * (m - 1) + i] = g_pose[3 + i] * inv_scale + g_abs_t * signf(t_raw[i]);
      ge[kR + 3 * (m - 1) + i] = g_pose[i] + 2.f * g_s * g.o[i];
    }
  }
  if (lane == 0) {
    ge[0] = g_focal * d_focal;
    ge[1] = g_cx;
    ge[2] = g_cy;
    if (warp < nb) err[b0 + warp] = total;
  }
  __syncthreads();
  for (int k = tid; k < nb * P; k += kThreads) grad[base + k] = g_sh[k];
}

// The general kernel: any M >= 2, N >= 1 with M N <= kMaxTerms, at run
// time (the file's head says how).  Dynamic shared memory, per block:
// parameters and gradient rows (kWarps x P each), the poses' ratio
// partials (kWarps x 3 (M - 1)), the chunk scratch (kWarps x 32 x 12) and
// the observations (3 x M N x kObsStride).
__global__ void __launch_bounds__(kThreads) calibration_vg_general_kernel(
    const float* __restrict__ params, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ vis, float* __restrict__ err,
    float* __restrict__ grad, int B, int M, int N) {
  extern __shared__ float smem[];
  const int MN = M * N;
  const int P = 3 + 3 * N + 6 * (M - 1);
  const int kT = 3 + 3 * N;         // first translation
  const int kR = kT + 3 * (M - 1);  // first rotation
  const int kObs = MN * kObsStride;  // one channel of observations
  float* p_sh = smem;                           // [element][P]
  float* g_sh = p_sh + kWarps * P;              // the gradient, [element][P]
  float* r_sh = g_sh + kWarps * P;              // g_cos, g_f1, g_f4: [element][M - 1][3]
  float* x_sh = r_sh + kWarps * 3 * (M - 1);    // the chunk's partials: [element][32][12]
  float* obs_sh = x_sh + kWarps * 32 * kPartials;  // u, v, vis: [term][element]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kWarps;
  const int nb = min(kWarps, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int k = tid; k < kWarps * P; k += kThreads) {
    p_sh[k] = k < nb * P ? params[base + k] : 0.f;
    g_sh[k] = 0.f;
  }
  for (int k = tid; k < kWarps * 3 * (M - 1); k += kThreads) r_sh[k] = 0.f;
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
  float* ge = g_sh + warp * P;
  float* re = r_sh + warp * 3 * (M - 1);
  float* xe = x_sh + warp * 32 * kPartials;

  // gauge rescale: lane l sums |coordinates| l, l + 32, ... of the points
  // and of the translations, then the warp's butterfly
  float part_w = 0.f, part_t = 0.f;
  for (int k = lane; k < 3 * N; k += 32) part_w += fabsf(pe[3 + k]);
  for (int k = lane; k < 3 * (M - 1); k += 32) part_t += fabsf(pe[kT + k]);
  const float abs_w = lane_sum<1, 32>(part_w);
  const float abs_t = lane_sum<1, 32>(part_t);
  const float overall = gauge_overall(abs_w, abs_t, M, N);
  const float inv_scale = 1.f / fmaxf(overall, 1e-6f);

  const float f = pe[0], cx = pe[1], cy = pe[2];
  const float focal = f > 0.f ? f + 1.f : expf(f);
  const float d_focal = f > 0.f ? 1.f : focal;

  float total = 0.f, g_cx = 0.f, g_cy = 0.f, g_focal = 0.f;
  for (int t0 = 0; t0 < MN; t0 += 32) {
    const int term = t0 + lane;
    const bool active = term < MN;
    const int m = active ? term / N : 0;  // view
    const int n = active ? term % N : 0;  // point
    const int obs = (active ? term : 0) * kObsStride + warp;
    TermGrad g;
    term_value_and_grad(pe, kT, kR, m, n, inv_scale, focal, cx, cy, obs_sh[obs], obs_sh[kObs + obs],
                        active ? obs_sh[2 * kObs + obs] : 0.f, g);
    total += g.value;
    g_cx -= g.g_ray[0];
    g_cy -= g.g_ray[1];
    g_focal += g.g_ray[2];
    float* x = xe + lane * kPartials;
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = g.g_w[i];
#pragma unroll
    for (int k = 0; k < 9; ++k) x[3 + k] = g.g_pose[k];
    __syncwarp();
    // each owner adds this chunk's terms of its points (ascending m) and
    // of its poses (ascending n)
    const int t1 = min(t0 + 32, MN);
    for (int pn = lane; pn < N; pn += 32) {
      for (int t = t0 + (pn - t0 % N + N) % N; t < t1; t += N) {
        const float* y = xe + (t - t0) * kPartials;
#pragma unroll
        for (int i = 0; i < 3; ++i) ge[3 + 3 * pn + i] += y[i];
      }
    }
    for (int pm = 1 + lane; pm < M; pm += 32) {
      const int first = pm * N > t0 ? pm * N : t0;
      for (int t = first; t < min(t1, pm * N + N); ++t) {
        const float* y = xe + (t - t0) * kPartials;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ge[kR + 3 * (pm - 1) + i] += y[3 + i];  // g_o
          ge[kT + 3 * (pm - 1) + i] += y[6 + i];  // g_T
          re[3 * (pm - 1) + i] += y[9 + i];       // g_cos, g_f1, g_f4
        }
      }
    }
    __syncwarp();
  }
  total = lane_sum<1, 32>(total);
  g_cx = lane_sum<1, 32>(g_cx);
  g_cy = lane_sum<1, 32>(g_cy);
  g_focal = lane_sum<1, 32>(g_focal);

  // ---- reverse: gauge rescale W = w inv_scale, T = t inv_scale: each
  // owner's points and translations, then the warp's butterfly
  float g_inv = 0.f;
  for (int pn = lane; pn < N; pn += 32) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g_inv += ge[3 + 3 * pn + i] * pe[3 + 3 * pn + i];
  }
  for (int pm = 1 + lane; pm < M; pm += 32) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g_inv += ge[kT + 3 * (pm - 1) + i] * pe[kT + 3 * (pm - 1) + i];
  }
  const float g_inv_scale = lane_sum<1, 32>(g_inv);
  const float g_overall = overall > 1e-6f ? -g_inv_scale * inv_scale * inv_scale : 0.f;
  const float g_abs_w = g_overall * N / (N + M) / (3.f * N);
  const float g_abs_t = g_overall * M / (N + M) / (3.f * (M - 1));

  for (int pn = lane; pn < N; pn += 32) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int k = 3 + 3 * pn + i;
      ge[k] = ge[k] * inv_scale + g_abs_w * signf(pe[k]);
    }
  }
  for (int pm = 1 + lane; pm < M; pm += 32) {
    const float* o = pe + kR + 3 * (pm - 1);
    const float s_ang = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
    float f1, f4, cs_sq, sc3_sq;
    pose_ratios(s_ang, f1, f4, cs_sq, sc3_sq);
    const float* rp = re + 3 * (pm - 1);
    const float g_s = ratios_adjoint(s_ang, f4, cs_sq, sc3_sq, rp[0], rp[1], rp[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int kt = kT + 3 * (pm - 1) + i;
      ge[kt] = ge[kt] * inv_scale + g_abs_t * signf(pe[kt]);
      ge[kR + 3 * (pm - 1) + i] += 2.f * g_s * o[i];
    }
  }
  if (lane == 0) {
    ge[0] = g_focal * d_focal;
    ge[1] = g_cx;
    ge[2] = g_cy;
    if (warp < nb) err[b0 + warp] = total;
  }
  __syncthreads();
  for (int k = tid; k < nb * P; k += kThreads) grad[base + k] = g_sh[k];
}

template <int M, int N>
int launch(const float* params, const float* u, const float* v, const float* vis,
           float* err, float* grad, int B, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  calibration_vg_kernel<M, N><<<grid, kThreads, 0, stream>>>(params, u, v, vis, err, grad, B);
  return static_cast<int>(cudaGetLastError());
}

int launch_general(const float* params, const float* u, const float* v, const float* vis,
                   float* err, float* grad, int B, int M, int N, cudaStream_t stream) {
  const int P = 3 + 3 * N + 6 * (M - 1);
  const size_t shared =
      sizeof(float) * (kWarps * (2 * P + 3 * (M - 1) + 32 * kPartials) + 3 * M * N * kObsStride);
  const cudaError_t attr = cudaFuncSetAttribute(
      calibration_vg_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (B + kWarps - 1) / kWarps;
  calibration_vg_general_kernel<<<grid, kThreads, shared, stream>>>(params, u, v, vis, err, grad, B, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (M, N) = (4, 8), the served model's and the bench shape, runs its own
// instantiation; any other M >= 2, N >= 1 with M N <= 256 the general
// kernel.  Others return cudaErrorInvalidValue.
extern "C" int davo_calibration_value_and_grad(const void* params, const void* u,
                                               const void* v, const void* vis, void* err,
                                               void* grad, int B, int M, int N,
                                               void* stream) {
  if (B <= 0 || M < 2 || N < 1 || M * N > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(params);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(vis);
  auto* ef = static_cast<float*>(err);
  auto* gf = static_cast<float*>(grad);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 4 && N == 8) return launch<4, 8>(pf, uf, vf, wf, ef, gf, B, st);
  return launch_general(pf, uf, vf, wf, ef, gf, B, M, N, st);
}
