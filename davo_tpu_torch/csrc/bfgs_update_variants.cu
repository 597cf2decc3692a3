// Tuning variants of the fused BFGS inverse-Hessian update + search
// direction (kernel K1').
//
// Replaces the Pallas TPU kernels of scripts/tune_bfgs_kernel.py (`build`,
// line 122, pallas_call at 128): `rowloop_kernel` (lines 27-66) and
// `rowloop2_kernel` (lines 69-119), the two orderings of the N&W eq. 6.20
// rescale that the TPU sweep compared with the shipped kernel.  Per batch
// element, with s, y, g the step, gradient change and gradient:
//
//   c = y.s, inv_c = c > 0 ? 1/c : 0,  scale = is_second ? max(c / max(y.y, 1e-5), 1e-4) : 1
//   rowloop   Hs = scale H row by row; hy = Hs y and yth = y'Hs reduce the scaled rows
//   rowloop2  hy = scale (H y) and yth = scale (y'H) reduce the raw rows, scaled once after
//   H+_ij = scale H_ij + applied (s_i/c ((1 + yth.y/c) s_j - yth_j) - hy_i s_j/c)
//   d = is_first ? -g : -H+ g          (applied = updating and not the first step)
//
// The two orderings agree in exact arithmetic and round differently in
// float32: rowloop multiplies every entry of H by the scale before both
// reductions, rowloop2 scales the two reduced vectors.  Neither uses the
// symmetry of H: y'H is reduced over the rows on its own (the shipped K1,
// csrc/bfgs_update.cu, takes y'H = (Hy)' instead).
//
// Layout, as K1: H channel-major (P, P, B), entry (i, j) of element b at
// (i * P + j) * B + b; s, y, g, d batch-major (B, P), staged through shared
// memory in a [P][kElems] layout.  A block takes kElems consecutive elements
// (16, 32 or 64: the counterpart of the TPU sweep's block_b 128, 256, 512,
// which were lane counts) on threadIdx.x and splits the rows of H over
// kRowGroups = 8 threads per element (threadIdx.y takes rows y, y + 8, ...).
// Pass 1 reads each row once: its dot product with y gives hy_i, and each
// entry adds y_i H_ij into a per-thread partial of yth_j held in registers
// (P <= kMaxP); the 8 row groups' partials are summed into shared memory in
// a fixed order.  Pass 2 reads H again, writes H+ and the matching
// component of -H+ g.  H may be stored float32 or bfloat16; the arithmetic
// is float32.
//
// What bounds it: device-memory bytes, as K1: H read once and written once
// plus s, y, g read and d written, (2 P^2 sizeof(H) + 16 P) B bytes.  Like
// K1 this kernel reads H twice, the second time from L2 where it fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowGroups = 8;
constexpr int kMaxP = 48;

__device__ __forceinline__ float load_h(const float* p) { return *p; }
__device__ __forceinline__ float load_h(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_h(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_h(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// kScaleRows: true = rowloop (scale each row before the reductions),
// false = rowloop2 (reduce the raw rows, scale the results)
template <bool kScaleRows, int kElems, typename T>
__global__ void __launch_bounds__(kElems * kRowGroups) bfgs_variant_kernel(
    const T* __restrict__ h, T* __restrict__ h_out, const float* __restrict__ s,
    const float* __restrict__ y, const float* __restrict__ g,
    const unsigned char* __restrict__ updating, float* __restrict__ d, int B, int P,
    int is_first, int is_second) {
  extern __shared__ float smem[];
  float* s_sh = smem;                 // [P][kElems]
  float* y_sh = s_sh + P * kElems;    // y in pass 1, then d
  float* g_sh = y_sh + P * kElems;
  float* hy_sh = g_sh + P * kElems;
  float* yth_sh = hy_sh + P * kElems;
  float* inv_c_sh = yth_sh + P * kElems;  // [kElems] each
  float* scale_sh = inv_c_sh + kElems;
  float* coef_sh = scale_sh + kElems;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kElems + tx;
  constexpr int kThreads = kElems * kRowGroups;
  const int b0 = blockIdx.x * kElems;
  const int nb = min(kElems, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  for (int e = tid; e < P * kElems; e += kThreads) yth_sh[e] = 0.f;
  for (int e = tid; e < nb * P; e += kThreads) {
    const int el = e / P;
    const int j = e - el * P;
    s_sh[j * kElems + el] = s[base + e];
    y_sh[j * kElems + el] = y[base + e];
    g_sh[j * kElems + el] = g[base + e];
  }
  __syncthreads();

  const bool active = tx < nb;
  const int b = b0 + tx;
  const size_t col = static_cast<size_t>(B);
  if (active && ty == 0) {
    float curvature = 0.f, y_sq = 0.f;
    for (int j = 0; j < P; ++j) {
      const float yj = y_sh[j * kElems + tx];
      curvature += s_sh[j * kElems + tx] * yj;
      y_sq += yj * yj;
    }
    inv_c_sh[tx] = curvature > 0.f ? 1.f / curvature : 0.f;
    scale_sh[tx] = is_second ? fmaxf(curvature / fmaxf(y_sq, 1e-5f), 1e-4f) : 1.f;
  }
  __syncthreads();

  // pass 1: hy_i = sum_j H_ij y_j per row; partial yth_j = sum_i y_i H_ij
  // over this thread's rows
  float part[kMaxP];
#pragma unroll
  for (int j = 0; j < kMaxP; ++j) part[j] = 0.f;
  if (active) {
    const float row_scale = kScaleRows ? scale_sh[tx] : 1.f;
    for (int i = ty; i < P; i += kRowGroups) {
      const T* row = h + static_cast<size_t>(i) * P * col + b;
      const float yi = y_sh[i * kElems + tx];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) {
        if (j < P) {
          const float hij = kScaleRows ? load_h(row + j * col) * row_scale : load_h(row + j * col);
          acc += hij * y_sh[j * kElems + tx];
          part[j] += yi * hij;
        }
      }
      hy_sh[i * kElems + tx] = acc;
    }
  }
  // the row groups' partials of yth, summed in a fixed order
  for (int r = 0; r < kRowGroups; ++r) {
    if (active && ty == r) {
#pragma unroll
      for (int j = 0; j < kMaxP; ++j)
        if (j < P) yth_sh[j * kElems + tx] += part[j];
    }
    __syncthreads();
  }
  // reduced-vector scale: 1 for rowloop (its rows were scaled), scale for rowloop2
  if (active && ty == 0) {
    const float vec_scale = kScaleRows ? 1.f : scale_sh[tx];
    float yhy = 0.f;
    for (int j = 0; j < P; ++j) yhy += vec_scale * yth_sh[j * kElems + tx] * y_sh[j * kElems + tx];
    coef_sh[tx] = 1.f + yhy * inv_c_sh[tx];
  }
  __syncthreads();

  // pass 2: H+ row by row; d_i = -(row i of H+) . g
  if (active) {
    const float inv_c = inv_c_sh[tx];
    const float scale = scale_sh[tx];
    const float vec_scale = kScaleRows ? 1.f : scale;
    const float coef = coef_sh[tx];
    const float applied = (updating[b] != 0 && !is_first) ? 1.f : 0.f;
    for (int i = ty; i < P; i += kRowGroups) {
      const size_t offset = static_cast<size_t>(i) * P * col + b;
      const float s_on_c_i = s_sh[i * kElems + tx] * inv_c;
      const float hy_i = vec_scale * hy_sh[i * kElems + tx];
      float acc = 0.f;
      for (int j = 0; j < P; ++j) {
        const float sj = s_sh[j * kElems + tx];
        const float common = coef * sj - vec_scale * yth_sh[j * kElems + tx];
        const float value = load_h(h + offset + j * col) * scale +
                            applied * (s_on_c_i * common - hy_i * (sj * inv_c));
        store_h(h_out + offset + j * col, value);
        acc += value * g_sh[j * kElems + tx];
      }
      y_sh[i * kElems + tx] = is_first ? -g_sh[i * kElems + tx] : -acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * P; e += kThreads) {
    const int el = e / P;
    const int j = e - el * P;
    d[base + e] = y_sh[j * kElems + el];
  }
}

template <bool kScaleRows, int kElems, typename T>
int launch(const void* h, void* h_out, const float* s, const float* y, const float* g,
           const unsigned char* updating, float* d, int B, int P, int is_first,
           int is_second, cudaStream_t stream) {
  const size_t shared = (5 * static_cast<size_t>(P) + 3) * kElems * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        bfgs_variant_kernel<kScaleRows, kElems, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  const dim3 block(kElems, kRowGroups);
  const dim3 grid((B + kElems - 1) / kElems);
  bfgs_variant_kernel<kScaleRows, kElems, T><<<grid, block, shared, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(h_out), s, y, g, updating, d, B, P,
      is_first, is_second);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScaleRows, typename T>
int dispatch_elems(int elems, const void* h, void* h_out, const float* s, const float* y,
                   const float* g, const unsigned char* updating, float* d, int B, int P,
                   int is_first, int is_second, cudaStream_t stream) {
  switch (elems) {
    case 16:
      return launch<kScaleRows, 16, T>(h, h_out, s, y, g, updating, d, B, P, is_first, is_second, stream);
    case 32:
      return launch<kScaleRows, 32, T>(h, h_out, s, y, g, updating, d, B, P, is_first, is_second, stream);
    case 64:
      return launch<kScaleRows, 64, T>(h, h_out, s, y, g, updating, d, B, P, is_first, is_second, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scale_rows: 1 = rowloop, 0 = rowloop2; elems_per_block in {16, 32, 64};
// P <= 48.  Anything else returns cudaErrorInvalidValue.
extern "C" int davo_bfgs_update_variant(const void* h, void* h_out, const void* s,
                                        const void* y, const void* g, const void* updating,
                                        void* d, int B, int P, int is_first, int is_second,
                                        int h_is_bf16, int scale_rows, int elems_per_block,
                                        void* stream) {
  if (B <= 0 || P <= 0 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const auto* sf = static_cast<const float*>(s);
  const auto* yf = static_cast<const float*>(y);
  const auto* gf = static_cast<const float*>(g);
  const auto* upd = static_cast<const unsigned char*>(updating);
  auto* df = static_cast<float*>(d);
  auto st = static_cast<cudaStream_t>(stream);
  const int e = elems_per_block;
  if (scale_rows) {
    if (h_is_bf16)
      return dispatch_elems<true, __nv_bfloat16>(e, h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
    return dispatch_elems<true, float>(e, h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
  }
  if (h_is_bf16)
    return dispatch_elems<false, __nv_bfloat16>(e, h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
  return dispatch_elems<false, float>(e, h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
}
