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
// (i * P + j) * B + b.  s, y, g and d are batch-major (B, P) as the solver
// holds them; a block stages its elements' rows of them through shared
// memory in a [P][elements] layout (coalesced global access, conflict-free
// banks).
//
// What bounds it: device-memory bytes.  The least traffic is H read once
// and written once plus s, y, g read and d written:
// (2 P^2 sizeof(H) + 4 P * 4) B bytes, 133 MB at P = 45, B = 8192 in
// float32 (0.041 ms at 3.35 TB/s).  At that size H (66 MB) exceeds the
// 50 MB L2, so a second read of an entry would come from device memory.
//
// The design reads each entry of H from device memory once
// (bfgs_update_rows_kernel, P <= kMaxRows):
//   - a block has kThreadsX = 16 threads along the batch (threadIdx.x) and
//     one thread per row i (threadIdx.y), 16 P threads (720 at P = 45);
//     a thread takes one element in float32, and in bfloat16 a pair of
//     consecutive elements (one 32-bit load and store; B even and H, H+
//     4-byte aligned, else one element a thread), so a warp
//     covers 16 or 32 consecutive elements of two rows: 64-byte segments
//     either way (16-element bfloat16 blocks read no faster than float32);
//   - each thread loads its row of H once into registers, with streaming
//     (evict-first) loads, and pass 1 forms (Hy)_i from them;
//   - the per-element sums y.s, y.y and y'Hy are reduced through shared
//     memory in a fixed order (no atomics: two runs give the same bits),
//     and each row's factors s_i/c and coef s_i - scale (Hy)_i are formed
//     once, in shared memory, for every row that uses them;
//   - pass 2 writes row i of H+ (streaming stores) and d_i =
//     -(row i of H+).g from the same registers.
// One 720-thread block fits an SM (80 registers a thread); its row loads
// put up to 130 KB (float32) in flight at once.
// The row lives in registers, so the route has a ceiling: kMaxRows = 48
// (a 48-entry row plus the addressing fit the 80 registers a thread of a
// 768-thread block may hold, with no spill).  Above it (P > 48) the launch
// takes bfgs_update_two_pass_kernel, the first port's design: 32 elements
// by 8 row threads, H read once per pass (twice in all).  The route is
// chosen from the shape and layout alone (P, and for bfloat16 the parity of
// B and the carries' 4-byte alignment); all share the semantics above.
// Storage may be float32 or bfloat16; the arithmetic is float32 either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 16;  // threads along the batch of a register-route block
constexpr int kMaxRows = 48;
constexpr int kTwoPassElems = 32;
constexpr int kTwoPassRowGroups = 8;

__device__ __forceinline__ float load_h(const float* p) { return *p; }
__device__ __forceinline__ float load_h(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_h(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_h(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The register route touches each entry of H once: loads and stores are
// streaming (evict-first), so H and H+ do not push other data out of L2.
__device__ __forceinline__ float load_streaming(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_streaming(const __nv_bfloat16* p) { return __bfloat162float(__ldcs(p)); }
__device__ __forceinline__ void store_streaming(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_streaming(__nv_bfloat16* p, float v) { __stcs(p, __float2bfloat16(v)); }

// V consecutive elements' entry (i, j) of H as one register: float32 or
// bfloat16 one element a thread (held as float32), bfloat16 two (a packed
// pair, one 32-bit load and store).
template <typename T, int V>
struct Entries {
  using Reg = float;
  static __device__ __forceinline__ Reg zero() { return 0.f; }
  static __device__ __forceinline__ Reg load(const T* p) { return load_streaming(p); }
  static __device__ __forceinline__ float get(Reg r, int) { return r; }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) { store_streaming(p, v[0]); }
};

template <>
struct Entries<__nv_bfloat16, 2> {
  using Reg = __nv_bfloat162;
  static __device__ __forceinline__ Reg zero() { return __floats2bfloat162_rn(0.f, 0.f); }
  static __device__ __forceinline__ Reg load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float get(Reg r, int v) {
    return v == 0 ? __low2float(r) : __high2float(r);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
    __stcs(reinterpret_cast<__nv_bfloat162*>(p), __floats2bfloat162_rn(v[0], v[1]));
  }
};

// V consecutive floats of a [P][elements] shared row
template <int V>
__device__ __forceinline__ void lds(const float* p, float (&out)[V]) {
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// Stage the block's rows of s, y, g ((B, P) batch-major) into [P][elems].
__device__ __forceinline__ void stage_vectors(const float* s, const float* y, const float* g,
                                              float* s_sh, float* y_sh, float* g_sh,
                                              size_t base, int nb, int P, int elems, int tid,
                                              int threads) {
  for (int e = tid; e < nb * P; e += threads) {
    const int el = e / P;
    const int j = e - el * P;
    s_sh[j * elems + el] = s[base + e];
    y_sh[j * elems + el] = y[base + e];
    g_sh[j * elems + el] = g[base + e];
  }
}

__device__ __forceinline__ void write_direction(const float* d_sh, float* d, size_t base, int nb,
                                                int P, int elems, int tid, int threads) {
  for (int e = tid; e < nb * P; e += threads) {
    const int el = e / P;
    const int j = e - el * P;
    d[base + e] = d_sh[j * elems + el];
  }
}

// The register route: thread (x, i) holds row i of H of elements
// b0 + V x + v, v < V, for the whole kernel.  V = 2 takes bfloat16 pairs
// (B even and H, H+ 4-byte aligned, so each pair is); a block is 16 V
// elements.
template <typename T, int V>
__global__ void __launch_bounds__(kThreadsX * kMaxRows, 1) bfgs_update_rows_kernel(
    const T* __restrict__ h, T* __restrict__ h_out, const float* __restrict__ s,
    const float* __restrict__ y, const float* __restrict__ g,
    const unsigned char* __restrict__ updating, float* __restrict__ d, int B, int P,
    int is_first, int is_second) {
  using E = Entries<T, V>;
  constexpr int kE = kThreadsX * V;  // elements a block
  extern __shared__ float smem[];
  float* s_sh = smem;           // [P][kE]
  float* y_sh = s_sh + P * kE;  // y in pass 1, then d
  float* g_sh = y_sh + P * kE;
  float* hy_sh = g_sh + P * kE;      // (Hy)_i
  float* inv_c_sh = hy_sh + P * kE;  // [kE] each
  float* scale_sh = inv_c_sh + kE;
  float* coef_sh = scale_sh + kE;

  const int i = threadIdx.y;          // row of H
  const int e0 = V * threadIdx.x;     // first element of the thread in the block
  const int tid = i * kThreadsX + threadIdx.x;
  const int threads = kThreadsX * P;
  const int b0 = blockIdx.x * kE;
  const int nb = min(kE, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  const bool active = e0 < nb;  // B - b0 is a multiple of V: all V or none
  const size_t col = static_cast<size_t>(B);
  stage_vectors(s, y, g, s_sh, y_sh, g_sh, base, nb, P, kE, tid, threads);
  __syncthreads();

  // row i of H into registers: the one read of these entries
  const size_t row_offset = static_cast<size_t>(i) * P * col + b0 + e0;
  typename E::Reg row[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j)
    row[j] = (active && j < P) ? E::load(h + row_offset + j * col) : E::zero();

  if (i == 0) {  // while the rows arrive: y.s and y.y
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float curvature = 0.f, y_sq = 0.f;
      for (int j = 0; j < P; ++j) {
        const float yj = y_sh[j * kE + e0 + v];
        curvature += s_sh[j * kE + e0 + v] * yj;
        y_sq += yj * yj;
      }
      inv_c_sh[e0 + v] = curvature > 0.f ? 1.f / curvature : 0.f;
      scale_sh[e0 + v] = is_second ? fmaxf(curvature / fmaxf(y_sq, 1e-5f), 1e-4f) : 1.f;
    }
  }
  // pass 1: Hy on the raw (unscaled) carry
  float hy[V];
#pragma unroll
  for (int v = 0; v < V; ++v) hy[v] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < P) {
      float yj[V];
      lds<V>(y_sh + j * kE + e0, yj);
#pragma unroll
      for (int v = 0; v < V; ++v) hy[v] += E::get(row[j], v) * yj[v];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) hy_sh[i * kE + e0 + v] = hy[v];
  __syncthreads();
  if (i == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int el = e0 + v;
      float yhy = 0.f;
      for (int k = 0; k < P; ++k) yhy += hy_sh[k * kE + el] * y_sh[k * kE + el];
      coef_sh[el] = 1.f + scale_sh[el] * yhy * inv_c_sh[el];
    }
  }
  __syncthreads();

  // row i's factors of the update, formed once for every row that uses
  // them: s_i / c replaces s_i and coef s_i - scale (Hy)_i replaces (Hy)_i
  // (each thread reads and writes only its own slots until the barrier)
  float scale[V], applied[V], s_on_c_i[V], hy_i[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int el = e0 + v;
    const float inv_c = inv_c_sh[el];
    scale[v] = scale_sh[el];
    applied[v] = (active && updating[b0 + el] != 0 && !is_first) ? 1.f : 0.f;
    const float si = s_sh[i * kE + el];
    s_on_c_i[v] = si * inv_c;
    hy_i[v] = scale[v] * hy[v];
    acc[v] = 0.f;
    s_sh[i * kE + el] = s_on_c_i[v];
    hy_sh[i * kE + el] = coef_sh[el] * si - scale[v] * hy[v];
  }
  __syncthreads();

  // pass 2: row i of H+ from the registers; d_i = -(row i of H+) . g
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < P) {
      float s_on_c_j[V], common_j[V], gj[V], value[V];
      lds<V>(s_sh + j * kE + e0, s_on_c_j);
      lds<V>(hy_sh + j * kE + e0, common_j);
      lds<V>(g_sh + j * kE + e0, gj);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        value[v] = scale[v] * E::get(row[j], v) +
                   applied[v] * (s_on_c_i[v] * common_j[v] - hy_i[v] * s_on_c_j[v]);
        acc[v] += value[v] * gj[v];
      }
      if (active) E::store(h_out + row_offset + j * col, value);
    }
  }
  // y is not read after the barrier above: its slots take d
#pragma unroll
  for (int v = 0; v < V; ++v)
    y_sh[i * kE + e0 + v] = is_first ? -g_sh[i * kE + e0 + v] : -acc[v];
  __syncthreads();
  write_direction(y_sh, d, base, nb, P, kE, tid, threads);
}

template <typename T>
__global__ void __launch_bounds__(kTwoPassElems * kTwoPassRowGroups) bfgs_update_two_pass_kernel(
    const T* __restrict__ h, T* __restrict__ h_out, const float* __restrict__ s,
    const float* __restrict__ y, const float* __restrict__ g,
    const unsigned char* __restrict__ updating, float* __restrict__ d, int B, int P,
    int is_first, int is_second) {
  constexpr int kE = kTwoPassElems;
  extern __shared__ float smem[];
  float* s_sh = smem;            // [P][kE]
  float* y_sh = s_sh + P * kE;   // y in pass 1, then d
  float* g_sh = y_sh + P * kE;
  float* hy_sh = g_sh + P * kE;
  float* inv_c_sh = hy_sh + P * kE;  // [kE] each
  float* scale_sh = inv_c_sh + kE;
  float* coef_sh = scale_sh + kE;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kE + tx;
  constexpr int kThreads = kE * kTwoPassRowGroups;
  const int b0 = blockIdx.x * kE;
  const int nb = min(kE, B - b0);
  const size_t base = static_cast<size_t>(b0) * P;
  stage_vectors(s, y, g, s_sh, y_sh, g_sh, base, nb, P, kE, tid, kThreads);
  __syncthreads();

  const bool active = tx < nb;
  const int b = b0 + tx;
  const size_t col = static_cast<size_t>(B);
  if (active && ty == 0) {
    float curvature = 0.f, y_sq = 0.f;
    for (int j = 0; j < P; ++j) {
      const float yj = y_sh[j * kE + tx];
      curvature += s_sh[j * kE + tx] * yj;
      y_sq += yj * yj;
    }
    inv_c_sh[tx] = curvature > 0.f ? 1.f / curvature : 0.f;
    scale_sh[tx] = is_second ? fmaxf(curvature / fmaxf(y_sq, 1e-5f), 1e-4f) : 1.f;
  }
  // pass 1: Hy on the raw (unscaled) carry
  if (active) {
    for (int i = ty; i < P; i += kTwoPassRowGroups) {
      const T* row = h + static_cast<size_t>(i) * P * col + b;
      float acc = 0.f;
      for (int j = 0; j < P; ++j) acc += load_h(row + j * col) * y_sh[j * kE + tx];
      hy_sh[i * kE + tx] = acc;
    }
  }
  __syncthreads();
  if (active && ty == 0) {
    float yhy = 0.f;
    for (int i = 0; i < P; ++i) yhy += hy_sh[i * kE + tx] * y_sh[i * kE + tx];
    coef_sh[tx] = 1.f + scale_sh[tx] * yhy * inv_c_sh[tx];
  }
  __syncthreads();

  // pass 2: H+ row by row (H read again); d_i = -(row i of H+) . g
  if (active) {
    const float inv_c = inv_c_sh[tx];
    const float scale = scale_sh[tx];
    const float coef = coef_sh[tx];
    const float applied = (updating[b] != 0 && !is_first) ? 1.f : 0.f;
    for (int i = ty; i < P; i += kTwoPassRowGroups) {
      const size_t offset = static_cast<size_t>(i) * P * col + b;
      const float s_on_c_i = s_sh[i * kE + tx] * inv_c;
      const float hy_i = scale * hy_sh[i * kE + tx];
      float acc = 0.f;
      for (int j = 0; j < P; ++j) {
        const float sj = s_sh[j * kE + tx];
        const float common = coef * sj - scale * hy_sh[j * kE + tx];
        const float value = scale * load_h(h + offset + j * col) +
                            applied * (s_on_c_i * common - hy_i * (sj * inv_c));
        store_h(h_out + offset + j * col, value);
        acc += value * g_sh[j * kE + tx];
      }
      y_sh[i * kE + tx] = is_first ? -g_sh[i * kE + tx] : -acc;
    }
  }
  __syncthreads();
  write_direction(y_sh, d, base, nb, P, kE, tid, kThreads);
}

template <typename K, typename T>
int launch_kernel(K kernel, dim3 grid, dim3 block, size_t shared, const T* h, T* h_out,
                  const float* s, const float* y, const float* g, const unsigned char* updating,
                  float* d, int B, int P, int is_first, int is_second, cudaStream_t stream) {
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, block, shared, stream>>>(h, h_out, s, y, g, updating, d, B, P, is_first, is_second);
  return static_cast<int>(cudaGetLastError());
}

// The route by shape: P <= kMaxRows the register route (bfloat16 two
// elements a thread where B is even and the carries 4-byte aligned), above
// it the two-pass route.
template <typename T, int V>
int launch(const void* h, void* h_out, const float* s, const float* y, const float* g,
           const unsigned char* updating, float* d, int B, int P, int is_first,
           int is_second, cudaStream_t stream) {
  const bool rows = P <= kMaxRows;
  const int elems = rows ? kThreadsX * V : kTwoPassElems;
  const size_t shared = (4 * static_cast<size_t>(P) + 3) * elems * sizeof(float);
  const dim3 grid((B + elems - 1) / elems);
  const T* hc = static_cast<const T*>(h);
  T* ho = static_cast<T*>(h_out);
  if (rows)
    return launch_kernel(bfgs_update_rows_kernel<T, V>, grid, dim3(kThreadsX, P), shared, hc, ho,
                         s, y, g, updating, d, B, P, is_first, is_second, stream);
  return launch_kernel(bfgs_update_two_pass_kernel<T>, grid, dim3(kTwoPassElems, kTwoPassRowGroups),
                       shared, hc, ho, s, y, g, updating, d, B, P, is_first, is_second, stream);
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
  // a packed pair is one 4-byte load and store: B even and both carries
  // 4-byte aligned (a view may start at an odd element)
  const bool pairs = B % 2 == 0 && reinterpret_cast<uintptr_t>(h) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(h_out) % 4 == 0;
  if (h_is_bf16 && pairs)
    return launch<__nv_bfloat16, 2>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
  if (h_is_bf16)
    return launch<__nv_bfloat16, 1>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
  return launch<float, 1>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, st);
}

extern "C" const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
