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
// symmetry of H: yth_j = sum_i y_i H_ij is a column reduction over the
// rows, as in both TPU kernels.  The shipped K1 (csrc/bfgs_update.cu)
// takes y'H = (Hy)' instead; on a carry that is not exactly symmetric the
// two give different results.
//
// Layout, as K1: H channel-major (P, P, B), entry (i, j) of element b at
// (i * P + j) * B + b; s, y, g, d batch-major (B, P), staged through shared
// memory in a [P][elements] layout.
//
// What bounds it: device-memory bytes, as K1: H read once and written once
// plus s, y, g read and d written, (2 P^2 sizeof(H) + 16 P) B bytes, 266 MB
// at P = 45, B = 16384 in float32 (0.083 ms at 3.35 TB/s); H alone (133 MB)
// exceeds the 50 MB L2, so a second read of an entry would come from
// device memory.
//
// The design is K1's register route (bfgs_update_rows_kernel there), and
// reads each entry of H from device memory once:
//   - a block has kThreadsX = 16 threads along the batch (threadIdx.x) and
//     one thread per row i (threadIdx.y), 16 P threads (720 at P = 45); a
//     thread takes one element, or in bfloat16 a packed pair of consecutive
//     elements (one 32-bit load and store) where the block is 32 or 64
//     elements, B is even and H, H+ are 4-byte aligned;
//   - a block walks elems_per_block elements (16, 32 or 64: the TPU sweep's
//     block_b 128, 256, 512, which were lane counts) as register tiles of
//     16 elements, or 32 in pairs, one tile after another, a grid's stride
//     apart (tiles next to each other in memory run at the same time);
//   - thread (x, i) loads row i of its tile's element(s) once into
//     registers, with streaming (evict-first) loads; pass 1 forms hy_i from
//     them and, in the same sweep, writes the products y_i H_ij (H_ij
//     scaled first for rowloop) for every j into a [P][P][16] shared
//     buffer; thread (x, j) then sums column j over i = 0, 1, ..., P - 1 in
//     order, the TPU kernels' own order (no atomics: two runs give the same
//     bits).  A pair's second element passes the buffer after the first;
//   - the sums y.s, y.y and yth.y are reduced through shared memory in a
//     fixed order, and each row's factors s_j/c and coef s_j - yth_j are
//     formed once, in shared memory, for every row that uses them;
//   - pass 2 writes row i of H+ (streaming stores) and d_i =
//     -(row i of H+).g from the same registers.
// The row lives in registers, so P <= kMaxP = 48: a 48-entry row and the
// rest fit the 80 registers a thread of a 768-thread block may hold, with
// no spill, because hy_i waits in shared memory across the column sums and
// the update's factors carry the applied flag (multiplied in once, exact
// for a flag of 0 or 1).  The buffer takes P (P | 1) 64 bytes (129,600 at
// P = 45; the row stride is padded to an odd count of 16-word groups, so
// the two rows of a warp fall on disjoint banks) beside the (5 P + 3) 16 V
// floats of the vectors: 144,192 bytes a block at P = 45 (158,784 for
// bfloat16 pairs), one 720-thread block an SM, which its registers set
// anyway.  H may be stored float32 or bfloat16; the arithmetic is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 16;  // threads along the batch
constexpr int kMaxP = 48;

// Each entry of H is touched once: loads and stores are streaming
// (evict-first), so H and H+ do not push other data out of L2.
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

// kScaleRows: true = rowloop (scale each entry before the reductions),
// false = rowloop2 (reduce the raw rows, scale the results).  Thread
// (x, i) holds row i of H of elements b0 + V x + v, v < V, for the tile.
template <bool kScaleRows, typename T, int V>
__global__ void __launch_bounds__(kThreadsX * kMaxP, 1) bfgs_variant_rows_kernel(
    const T* __restrict__ h, T* __restrict__ h_out, const float* __restrict__ s,
    const float* __restrict__ y, const float* __restrict__ g,
    const unsigned char* __restrict__ updating, float* __restrict__ d, int B, int P,
    int is_first, int is_second, int tiles) {
  using E = Entries<T, V>;
  constexpr int kE = kThreadsX * V;  // elements a tile
  const int row_stride = (P | 1) * kThreadsX;
  extern __shared__ float smem[];
  float* prod_sh = smem;                     // [P][P | 1][16]: y_i H_ij, one element a thread
  float* s_sh = prod_sh + P * row_stride;    // [P][kE]: s, then s / c
  float* y_sh = s_sh + P * kE;               // y, then d
  float* g_sh = y_sh + P * kE;
  float* yth_sh = g_sh + P * kE;             // yth, then coef s - yth
  float* hy_sh = yth_sh + P * kE;            // hy, across the column sums
  float* inv_c_sh = hy_sh + P * kE;          // [kE] each
  float* scale_sh = inv_c_sh + kE;
  float* coef_sh = scale_sh + kE;

  const int i = threadIdx.y;          // row of H
  const int x = threadIdx.x;
  const int e0 = V * x;               // first element of the thread in the tile
  const int tid = i * kThreadsX + x;
  const int threads = kThreadsX * P;
  const size_t col = static_cast<size_t>(B);
  float* prod_row = prod_sh + i * row_stride + x;  // this thread's products y_i H_ij
  const float* prod_col = prod_sh + i * kThreadsX + x;  // column i, read over the rows

  // tile blockIdx.x, then a grid's stride on: the blocks on the card at
  // once cover consecutive tiles, so their loads stream through whole
  // device-memory pages
  const int num_tiles = (B + kE - 1) / kE;
  const int stride = (num_tiles + tiles - 1) / tiles;  // the grid's blocks
  for (int tile = blockIdx.x; tile < num_tiles; tile += stride) {
    const int b0 = tile * kE;
    if (tile != blockIdx.x) __syncthreads();  // the last tile's d is written out
    const int nb = min(kE, B - b0);
    const size_t base = static_cast<size_t>(b0) * P;
    const bool active = e0 < nb;  // B - b0 is a multiple of V: all V or none
    for (int e = tid; e < nb * P; e += threads) {
      const int el = e / P;
      const int j = e - el * P;
      s_sh[j * kE + el] = s[base + e];
      y_sh[j * kE + el] = y[base + e];
      g_sh[j * kE + el] = g[base + e];
    }
    __syncthreads();

    // row i of H into registers: the one read of these entries
    const size_t row_offset = static_cast<size_t>(i) * P * col + b0 + e0;
    typename E::Reg row[kMaxP];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j)
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
    __syncthreads();

    // pass 1: hy_i = sum_j H_ij y_j from the registers, and the products
    // y_i H_ij of the first element of the thread into the buffer (rowloop:
    // each entry scaled first, as it enters either reduction)
    float scale[V], hy[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      scale[v] = scale_sh[e0 + v];
      hy[v] = 0.f;
    }
    const float yi = y_sh[i * kE + e0];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
      if (j < P) {
        float yj[V];
        lds<V>(y_sh + j * kE + e0, yj);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float hij = kScaleRows ? E::get(row[j], v) * scale[v] : E::get(row[j], v);
          hy[v] += hij * yj[v];
          if (v == 0) prod_row[j * kThreadsX] = yi * hij;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) hy_sh[i * kE + e0 + v] = hy[v];
    // yth_j = sum_i y_i H_ij over the rows: thread (x, j) sums column j of
    // the buffer in row order; a pair's second element passes the buffer
    // after the first
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v > 0) {
        __syncthreads();  // the first element's column sums are read
        const float yv = y_sh[i * kE + e0 + v];
#pragma unroll
        for (int j = 0; j < kMaxP; ++j) {
          if (j < P) {
            const float hij = kScaleRows ? E::get(row[j], v) * scale[v] : E::get(row[j], v);
            prod_row[j * kThreadsX] = yv * hij;
          }
        }
      }
      __syncthreads();
      float yth = 0.f;
#pragma unroll 8
      for (int k = 0; k < P; ++k) yth += prod_col[k * row_stride];
      yth_sh[i * kE + e0 + v] = kScaleRows ? yth : yth * scale[v];
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int el = e0 + v;
        float yhy = 0.f;
        for (int k = 0; k < P; ++k) yhy += yth_sh[k * kE + el] * y_sh[k * kE + el];
        coef_sh[el] = 1.f + yhy * inv_c_sh[el];
      }
    }
    __syncthreads();

    // row i's factors of the update, formed once for every row that uses
    // them: s_i / c replaces s_i and coef s_i - yth_i replaces yth_i (each
    // thread reads and writes only its own slots until the barrier)
    float s_on_c_i[V], hy_i[V], acc[V];  // s_i / c and hy_i, times applied
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int el = e0 + v;
      const float si = s_sh[i * kE + el];
      const float applied = (active && updating[b0 + el] != 0 && !is_first) ? 1.f : 0.f;
      const float s_on_c = si * inv_c_sh[el];
      s_on_c_i[v] = applied * s_on_c;
      hy_i[v] = applied * (kScaleRows ? hy_sh[i * kE + el] : hy_sh[i * kE + el] * scale[v]);
      acc[v] = 0.f;
      s_sh[i * kE + el] = s_on_c;
      yth_sh[i * kE + el] = coef_sh[el] * si - yth_sh[i * kE + el];
    }
    __syncthreads();

    // pass 2: row i of H+ from the registers; d_i = -(row i of H+) . g
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
      if (j < P) {
        float s_on_c_j[V], common_j[V], gj[V], value[V];
        lds<V>(s_sh + j * kE + e0, s_on_c_j);
        lds<V>(yth_sh + j * kE + e0, common_j);
        lds<V>(g_sh + j * kE + e0, gj);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          value[v] = E::get(row[j], v) * scale[v] + (s_on_c_i[v] * common_j[v] - hy_i[v] * s_on_c_j[v]);
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
    for (int e = tid; e < nb * P; e += threads) {
      const int el = e / P;
      const int j = e - el * P;
      d[base + e] = y_sh[j * kE + el];
    }
  }
}

template <bool kScaleRows, typename T, int V>
int launch(const void* h, void* h_out, const float* s, const float* y, const float* g,
           const unsigned char* updating, float* d, int B, int P, int is_first,
           int is_second, int tiles, cudaStream_t stream) {
  constexpr int kE = kThreadsX * V;
  const size_t shared = (static_cast<size_t>(P) * (P | 1) * kThreadsX +
                         (5 * static_cast<size_t>(P) + 3) * kE) * sizeof(float);
  auto kernel = bfgs_variant_rows_kernel<kScaleRows, T, V>;
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  const int per_block = kE * tiles;
  const dim3 grid((B + per_block - 1) / per_block);
  kernel<<<grid, dim3(kThreadsX, P), shared, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(h_out), s, y, g, updating, d, B, P,
      is_first, is_second, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The tile by storage: float32 and unpaired bfloat16 tiles of 16 elements,
// bfloat16 pairs tiles of 32.
template <bool kScaleRows>
int dispatch(const void* h, void* h_out, const float* s, const float* y, const float* g,
             const unsigned char* updating, float* d, int B, int P, int is_first, int is_second,
             bool bf16, bool pairs, int elems, cudaStream_t stream) {
  if (bf16 && pairs)
    return launch<kScaleRows, __nv_bfloat16, 2>(h, h_out, s, y, g, updating, d, B, P, is_first,
                                                 is_second, elems / (2 * kThreadsX), stream);
  if (bf16)
    return launch<kScaleRows, __nv_bfloat16, 1>(h, h_out, s, y, g, updating, d, B, P, is_first,
                                                 is_second, elems / kThreadsX, stream);
  return launch<kScaleRows, float, 1>(h, h_out, s, y, g, updating, d, B, P, is_first, is_second,
                                      elems / kThreadsX, stream);
}

}  // namespace

// scale_rows: 1 = rowloop, 0 = rowloop2; elems_per_block in {16, 32, 64}:
// float32 1, 2 or 4 tiles of 16; bfloat16 16 one tile of single elements,
// 32 and 64 one or two tiles of 32 in pairs (B even and H, H+ 4-byte
// aligned; else 2 or 4 tiles of 16 single elements).  P <= 48.  Anything
// else returns cudaErrorInvalidValue.
extern "C" int davo_bfgs_update_variant(const void* h, void* h_out, const void* s,
                                        const void* y, const void* g, const void* updating,
                                        void* d, int B, int P, int is_first, int is_second,
                                        int h_is_bf16, int scale_rows, int elems_per_block,
                                        void* stream) {
  if (B <= 0 || P <= 0 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  if (elems_per_block != 16 && elems_per_block != 32 && elems_per_block != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sf = static_cast<const float*>(s);
  const auto* yf = static_cast<const float*>(y);
  const auto* gf = static_cast<const float*>(g);
  const auto* upd = static_cast<const unsigned char*>(updating);
  auto* df = static_cast<float*>(d);
  auto st = static_cast<cudaStream_t>(stream);
  // a packed pair is one 4-byte load and store: B even and both carries
  // 4-byte aligned (a view may start at an odd element)
  const bool pairs = elems_per_block > kThreadsX && B % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(h) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(h_out) % 4 == 0;
  const bool bf16 = h_is_bf16 != 0;
  if (scale_rows)
    return dispatch<true>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, bf16, pairs,
                          elems_per_block, st);
  return dispatch<false>(h, h_out, sf, yf, gf, upd, df, B, P, is_first, is_second, bf16, pairs,
                         elems_per_block, st);
}
