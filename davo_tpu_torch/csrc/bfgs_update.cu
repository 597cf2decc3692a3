// Fused BFGS inverse-Hessian update + search direction (kernel K1).
//
// Replaces the Pallas TPU kernel davo_tpu/ops/bfgs_update.py::
// fused_bfgs_update_direction (kernel body `_kernel`, lines 38-109).
//
// Per batch element b, with s, y, g the step, gradient change and gradient:
//   c = y.s, inv_c = c > 0 ? 1/c : 0           (update skipped where c <= 0)
//   scale = is_second ? max(c / max(y.y, 1e-5), 1e-4) : 1   (N&W eq. 6.20)
//   H+ = scale H + applied [ (1 + y'Hy/c)(s/c)s' - (s/c)(y'H) - (Hy)(s/c)' ]
//        (scale folded in; applied = updating[b] and not the first step)
//   d  = is_first ? -g : -H+ g
// H is symmetric, so y'H = (Hy)'.
//
// Layout: H is channel-major (P, P, B): entry (i, j) of element b lies at
// (i * P + j) * B + b.  A block takes kElems = 32 consecutive elements
// (threadIdx.x, so a warp reads and writes 32 consecutive addresses) and
// splits the rows of H over kRowGroups = 8 threads per element
// (threadIdx.y takes rows y, y + 8, ...).  s, y, g and d are batch-major
// (B, P) as the solver holds them; the block stages its rows through
// shared memory in a [P][kElems] layout (coalesced global access,
// conflict-free banks).  Pass 1 computes Hy row by row; the per-element
// sums (curvature, y.y, y'Hy) are reduced by one thread per element
// between the passes; pass 2 writes H+ row by row and the matching
// component of -H+ g.
//
// What bounds it: device-memory bytes.  The least traffic is H read once
// and written once plus s, y, g read and d written:
// (2 P^2 sizeof(H) + 4 P * 4) B bytes, 277 MB at P = 45, B = 16384 in
// float32.  This kernel reads H twice (once per pass); where H exceeds the
// 50 MB L2 the second read comes from device memory, so it moves ~1.5x the
// least traffic.  Storage may be float32 or bfloat16; the arithmetic is
// float32 either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kElems = 32;
constexpr int kRowGroups = 8;

__device__ __forceinline__ float load_h(const float* p) { return *p; }
__device__ __forceinline__ float load_h(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_h(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_h(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kElems * kRowGroups) bfgs_update_kernel(
    const T* __restrict__ h, T* __restrict__ h_out, const float* __restrict__ s,
    const float* __restrict__ y, const float* __restrict__ g,
    const unsigned char* __restrict__ updating, float* __restrict__ d, int B, int P,
    int is_first, int is_second) {
  extern __shared__ float smem[];
  float* s_sh = smem;               // [P][kElems]
  float* y_sh = s_sh + P * kElems;  // y in pass 1, then d
  float* g_sh = y_sh + P * kElems;
  float* hy_sh = g_sh + P * kElems;
  float* inv_c_sh = hy_sh + P * kElems;  // [kElems] each
  float* scale_sh = inv_c_sh + kElems;
  float* coef_sh = scale_sh + kElems;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kElems + tx;
  constexpr int kThreads = kElems * kRowGroups;
  const int b0 = blockIdx.x * kElems;
  const int nb = min(kElems, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
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
  // pass 1: Hy on the raw (unscaled) carry
  if (active) {
    for (int i = ty; i < P; i += kRowGroups) {
      const T* row = h + static_cast<size_t>(i) * P * col + b;
      float acc = 0.f;
      for (int j = 0; j < P; ++j) acc += load_h(row + j * col) * y_sh[j * kElems + tx];
      hy_sh[i * kElems + tx] = acc;
    }
  }
  __syncthreads();
  if (active && ty == 0) {
    float yhy = 0.f;
    for (int i = 0; i < P; ++i) yhy += hy_sh[i * kElems + tx] * y_sh[i * kElems + tx];
    coef_sh[tx] = 1.f + scale_sh[tx] * yhy * inv_c_sh[tx];
  }
  __syncthreads();

  // pass 2: H+ row by row; d_i = -(row i of H+) . g
  if (active) {
    const float inv_c = inv_c_sh[tx];
    const float scale = scale_sh[tx];
    const float coef = coef_sh[tx];
    const float applied = (updating[b] != 0 && !is_first) ? 1.f : 0.f;
    for (int i = ty; i < P; i += kRowGroups) {
      const size_t offset = static_cast<size_t>(i) * P * col + b;
      const float s_on_c_i = s_sh[i * kElems + tx] * inv_c;
      const float hy_i = scale * hy_sh[i * kElems + tx];
      float acc = 0.f;
      for (int j = 0; j < P; ++j) {
        const float sj = s_sh[j * kElems + tx];
        const float common = coef * sj - scale * hy_sh[j * kElems + tx];
        const float value = scale * load_h(h + offset + j * col) +
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

template <typename T>
int launch(const void* h, void* h_out, const float* s, const float* y, const float* g,
           const unsigned char* updating, float* d, int B, int P, int is_first,
           int is_second, cudaStream_t stream) {
  const size_t shared = (4 * static_cast<size_t>(P) + 3) * kElems * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        bfgs_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  const dim3 block(kElems, kRowGroups);
  const dim3 grid((B + kElems - 1) / kElems);
  bfgs_update_kernel<T><<<grid, block, shared, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(h_out), s, y, g, updating, d, B, P,
      is_first, is_second);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int davo_bfgs_update_direction(const void* h, void* h_out, const void* s,
                                          const void* y, const void* g,
                                          const void* updating, void* d, int B, int P,
                                          int is_first, int is_second, int h_is_bf16,
                                          void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* sf = static_cast<const float*>(s);
  const auto* yf = static_cast<const float*>(y);
  const auto* gf = static_cast<const float*>(g);
  const auto* upd = static_cast<const unsigned char*>(updating);
  auto* df = static_cast<float*>(d);
  auto st = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    return launch<__nv_bfloat16>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
  return launch<float>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
}

extern "C" const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
