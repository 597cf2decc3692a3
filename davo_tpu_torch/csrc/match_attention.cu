// Masked online-softmax attention over feature descriptors (kernel K3).
//
// Replaces the Pallas TPU kernel davo_tpu/ops/attention.py::
// flash_match_attention (kernel body `_flash_kernel`, lines 52-119).
//
// Per problem b and query row i, over the valid keys j (j < K and
// mask[b, j], or every j < K without a mask):
//   s_j   = (q_i . k_j) / sqrt(D)
//   out_i = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30),
//   m     = max_j s_j  (running, from -1e30)
// A masked key gets exactly zero weight; a row with no valid key returns
// zeros.  Query (B, Q, D), key (B, K, D), value (B, K, C), out (B, Q, C),
// all row-major float32; the mask is (B, K) bytes or null.  Any B, Q, K,
// D <= 128, C <= 8.
//
// What bounds it: bytes.  At the matcher's shape (B = 3072 problems,
// Q = K = 144, D = 64, C = 2) the inputs and output are 234 MB, 0.070 ms
// at 3.35 TB/s.  On the tensor cores QK^T is three TF32 products (below)
// of 8.2 GFLOP each, 0.049 ms at 495 TFLOP/s; PV and the exponentials,
// 0.32 GFLOP on the CUDA cores, 0.005 ms at 67 TFLOP/s.  (On the CUDA
// cores alone QK^T and PV are 8.4 GFLOP, 0.126 ms: the bound of the first
// port, which ran there.)
//
// Float32 accuracy on the tensor cores ("3xTF32").  One TF32 product keeps
// 10 mantissa bits an operand: on D = 64 products of unit normals that is
// a score error of ~5e-4, against K3's tolerance of 1e-5 normwise.  So each
// operand is split, x = big + small with big = tf32(x) and small =
// tf32(x - big), and S = Qs Kb^T + Qb Ks^T + Qb Kb^T: what is dropped,
// Qs Ks^T, is 2^-22 of a product, and the sums are float32 on the tensor
// cores.  The split costs three products where one would do; they still
// take less time than the bytes.
//
// Design:
//   - a block takes one problem's 144 queries (kTileQ = 9 warps x 16-row
//     fragments, the matcher's 12 x 12 cells: no fragment is padded at the
//     served shape); a ragged query tile is zero-filled in shared memory;
//   - the block stages its queries in shared memory once; keys stream
//     through shared memory kTileK = 48 at a time (144 = 3 tiles), each
//     staged once for the block by 16-byte asynchronous copies (cp.async),
//     double-buffered: tile t + 1 is in flight while the block computes on
//     tile t.  The block splits each key tile once into its tf32 parts (big
//     in place, small beside).  Values and the key mask are small (C floats
//     and a byte a key): each thread reads its share into registers a tile
//     ahead;
//   - scores: mma.sync m16n8k8 TF32 products (mma_tf32.cuh), the three
//     above, into float32 accumulators that stay in registers.  ldmatrix
//     loads the fragments, four 8 x 4 tiles an instruction; the tiles'
//     16-byte chunks are permuted by row (swizzled), so its 8 rows meet no
//     bank conflict without padding.  The query fragment is split on the
//     fly, a k-step at a time;
//   - softmax and PV on the CUDA cores, in registers: a lane holds rows g
//     and g + 8 of its warp's fragment and keys 2t, 2t + 1 of every 8; the
//     row max is shared across the lane's quad by two shuffles once a tile,
//     each score takes one exp, and the quad's shares of the normaliser and
//     of the C-wide accumulator are added by two shuffles at the end.  A
//     masked key carries a bias of -inf, so it takes no part in the max and
//     its weight, exp(-inf), is exactly zero;
//   - rows and keys beyond Q and K are masked inside the block, columns
//     beyond D are zero in shared memory: nothing is padded in device
//     memory.
// Every thread reaches every barrier and shuffle: the loops' bounds are
// the block's own.  Shared memory: 74,304 bytes at D <= 64, C = 2, so
// three blocks (27 warps, 72 registers a thread) fit an SM; 149,184 bytes
// at D <= 128, C = 8.
//
// Why mma.sync and not nvcuda::wmma: wmma's TF32 fragment loads compile to
// generic (not shared-memory) loads, four scalar ones a fragment, its
// m16n16k8 product to four m16n8k4 instructions, and its accumulators'
// layout is opaque, so the softmax has to go through shared memory.  That
// form of this kernel read about twice this one's time (PERF.md, section 6).

#include <cmath>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;   // queries a block
constexpr int kTileK = 48;            // keys a tile
constexpr float kNegInf = -1e30f;   // the running max starts here

template <int DMAX, int CMAX>
constexpr size_t kSharedBytes = sizeof(float) * ((kTileQ + 3 * kTileK) * DMAX + kTileK * CMAX + kTileK);

// Offset of (row r, column c) in a tile of DMAX-float rows: the 16-byte
// chunks of a row are permuted by r & 7 (no padding), so the 8 rows an
// ldmatrix tile reads fall on 8 different chunks of the 32 banks.
template <int DMAX>
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * DMAX + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

// Copy rows [row0, row0 + rows) of a (n_rows, D) row-major matrix into
// dst (swizzled rows of DMAX floats) asynchronously, zero beyond n_rows
// and D: 16 bytes a copy where D % 4 == 0 and the matrix is 16-byte
// aligned (vec), else 4.  One commit group.
template <int DMAX>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int rows,
                                           int n_rows, int D, bool vec) {
  if (vec) {
    constexpr int kQuads = DMAX / 4;
    for (int e = threadIdx.x; e < rows * kQuads; e += kThreads) {
      const int r = e / kQuads;
      const int c = (e - r * kQuads) * 4;
      float* d = dst + swizzled<DMAX>(r, c);
      if (row0 + r < n_rows && c < D)
        __pipeline_memcpy_async(d, src + static_cast<size_t>(row0 + r) * D + c, 16);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DMAX; e += kThreads) {
      const int r = e / DMAX;
      const int c = e - r * DMAX;
      float* d = dst + swizzled<DMAX>(r, c);
      if (row0 + r < n_rows && c < D)
        __pipeline_memcpy_async(d, src + static_cast<size_t>(row0 + r) * D + c, 4);
      else
        *d = 0.f;
    }
  }
  __pipeline_commit();
}

// x = big + small, both exact in TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  big = tf32_round(x);
  small = tf32_round(x - big);
}

template <int DMAX, int CMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 64 ? 3 : 1) match_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, int Q, int K, int D,
    int C, int q_tiles, float scale, bool vec) {
  constexpr int kTile = kTileK * DMAX;  // floats of one key tile
  constexpr int kSteps = DMAX / 8;      // k-steps of the m16n8k8 products
  constexpr int kN8 = kTileK / 8;       // 8-key column tiles of the scores
  constexpr int kVals = (kTileK * CMAX + kThreads - 1) / kThreads;  // values a thread prefetches
  extern __shared__ __align__(16) float smem[];  // 16-byte copies and ldmatrix rows
  float* const q_sh = smem;                      // [kTileQ][DMAX], swizzled
  float* const k_big = q_sh + kTileQ * DMAX;     // [2][kTileK][DMAX], swizzled
  float* const k_small = k_big + 2 * kTile;      // [kTileK][DMAX], swizzled
  float* const v_sh = k_small + kTile;           // [kTileK][CMAX]
  float* const bias_sh = v_sh + kTileK * CMAX;   // [kTileK]: 0, or -inf for a masked key

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * kTileQ;
  const float* kb = k + static_cast<size_t>(b) * K * D;
  const float* vb = v + static_cast<size_t>(b) * K * C;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * K;
  const int n_tiles = (K + kTileK - 1) / kTileK;

  // a key tile's values and mask bias, read into registers a tile ahead
  float v_next[kVals];
  float bias_next = 0.f;
  auto prefetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / CMAX;
      const int c = e - j * CMAX;
      v_next[i] = (e < kTileK * CMAX && k0 + j < K && c < C) ? vb[static_cast<size_t>(k0 + j) * C + c] : 0.f;
    }
    if (tid < kTileK)
      bias_next = (k0 + tid < K && (mb == nullptr || mb[k0 + tid] != 0)) ? 0.f : -INFINITY;
  };

  // ---- the block's queries and its first key tile, in flight together
  if (n_tiles > 0) {
    stage_rows<DMAX>(q_sh, q + static_cast<size_t>(b) * Q * D, q0, kTileQ, Q, D, vec);
    stage_rows<DMAX>(k_big, kb, 0, kTileK, K, D, vec);
    prefetch(0);
  }

  // this lane's ldmatrix row: row lane & 15 of a 16-row fragment (which
  // starts at a multiple of 8 rows), columns 8 s + 4 (lane >> 4) .. + 3
  const int ld_row = lane & 15;
  const int ld_col = 4 * (lane >> 4);
  const float* q_warp = q_sh + warp * 16 * DMAX;
  // rows g and g + 8 of the warp's fragment: running max, normaliser and
  // this lane's share of the C-wide accumulators (its keys 2t, 2t + 1 of
  // each 8)
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[2][CMAX];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[h][c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTileK;
    float* const kt_big = k_big + (tile & 1) * kTile;
    __pipeline_wait_prior(0);
    __syncthreads();  // tile `tile` has landed; every warp is done with the one before
    if (tile + 1 < n_tiles)
      stage_rows<DMAX>(k_big + ((tile + 1) & 1) * kTile, kb, k0 + kTileK, kTileK, K, D, vec);
    // ---- split the tile's keys once for the block; its values and mask
    for (int e = tid; e < kTileK * (DMAX / 4); e += kThreads) {
      const int off = 4 * e;  // the split is per element: the swizzle does not matter
      float4 x = *reinterpret_cast<float4*>(kt_big + off);
      float4 lo;
      split_tf32(x.x, x.x, lo.x);
      split_tf32(x.y, x.y, lo.y);
      split_tf32(x.z, x.z, lo.z);
      split_tf32(x.w, x.w, lo.w);
      *reinterpret_cast<float4*>(kt_big + off) = x;
      *reinterpret_cast<float4*>(k_small + off) = lo;
    }
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      if (tid + i * kThreads < kTileK * CMAX) v_sh[tid + i * kThreads] = v_next[i];
    if (tid < kTileK) bias_sh[tid] = bias_next;
    if (tile + 1 < n_tiles) prefetch(k0 + kTileK);
    __syncthreads();

    // ---- scores of the warp's 16 rows against the tile's 48 keys, in
    // registers: S = Qs Kb^T + Qb Ks^T + Qb Kb^T, the query fragment split
    // on the fly
    float s_acc[kN8][4];
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_acc[n][i] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (8 * s < D) {
        uint32_t a_raw[4], a_big[4], a_small[4];
        ldmatrix_x4(a_raw, q_warp + swizzled<DMAX>(ld_row, 8 * s + ld_col));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float hi, lo;
          split_tf32(__uint_as_float(a_raw[i]), hi, lo);
          a_big[i] = __float_as_uint(hi);
          a_small[i] = __float_as_uint(lo);
        }
#pragma unroll
        for (int j = 0; j < kN8 / 2; ++j) {  // 16 keys: two 8-key column tiles
          uint32_t kb_big[4], kb_small[4];
          const int off = 16 * j * DMAX + swizzled<DMAX>(ld_row, 8 * s + ld_col);
          ldmatrix_x4(kb_big, kt_big + off);
          ldmatrix_x4(kb_small, k_small + off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // keys 16 j + 8 h ..: words h (k 0-3) and h + 2 (k 4-7)
            float(&d)[4] = s_acc[2 * j + h];
            mma_tf32_16x8x8(d, a_small, kb_big[h], kb_big[h + 2]);
            mma_tf32_16x8x8(d, a_big, kb_small[h], kb_small[h + 2]);
            mma_tf32_16x8x8(d, a_big, kb_big[h], kb_big[h + 2]);
          }
        }
      }
    }

    // ---- online softmax and PV in registers: rows g and g + 8, this lane's
    // keys 8 n + 2 t, + 1; a masked key's bias is -inf, so it takes no part
    // in the max and its weight exp(-inf) is exactly zero whatever its score
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(bias_sh + 8 * n + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_acc[n][2 * h] = s_acc[n][2 * h] * scale + bias.x;
        s_acc[n][2 * h + 1] = s_acc[n][2 * h + 1] * scale + bias.y;
        tile_max[h] = fmaxf(tile_max[h], fmaxf(s_acc[n][2 * h], s_acc[n][2 * h + 1]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_next = fmaxf(m_run[h], tile_max[h]);
      const float alpha = expf(m_run[h] - m_next);
      l_run[h] *= alpha;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) acc[h][c] *= alpha;
      m_run[h] = m_next;
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* vk = v_sh + (8 * n + 2 * t + e) * CMAX;
        float vv[CMAX];
#pragma unroll
        for (int c = 0; c < CMAX; c += 2) {
          const float2 w = *reinterpret_cast<const float2*>(vk + c);
          vv[c] = w.x;
          vv[c + 1] = w.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = expf(s_acc[n][2 * h + e] - m_run[h]);
          l_run[h] += p;
#pragma unroll
          for (int c = 0; c < CMAX; ++c) acc[h][c] = fmaf(p, vv[c], acc[h][c]);
        }
      }
    }
  }

  // ---- the quad's shares of each row (xor 1, 2: the same sum on its four
  // lanes), then out = acc / max(l, 1e-30) from lane t = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], x);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], x);
    }
    const int q_row = q0 + warp * 16 + g + 8 * h;
    if (t == 0 && q_row < Q) {
      const float normaliser = fmaxf(l_run[h], 1e-30f);
      float* ob = out + (static_cast<size_t>(b) * Q + q_row) * C;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) ob[c] = acc[h][c] / normaliser;
    }
  }
}

template <int DMAX, int CMAX>
int launch(const float* q, const float* k, const float* v, const unsigned char* mask,
           float* out, int B, int Q, int K, int D, int C, cudaStream_t stream) {
  const int q_tiles = (Q + kTileQ - 1) / kTileQ;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const bool vec = D % 4 == 0 && (reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k)) % 16 == 0;
  const size_t shared = kSharedBytes<DMAX, CMAX>;
  const cudaError_t status = cudaFuncSetAttribute(
      match_attention_kernel<DMAX, CMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * q_tiles);
  match_attention_kernel<DMAX, CMAX><<<grid, kThreads, shared, stream>>>(
      q, k, v, mask, out, Q, K, D, C, q_tiles, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_c(const float* q, const float* k, const float* v, const unsigned char* mask,
             float* out, int B, int Q, int K, int D, int C, cudaStream_t stream) {
  if (C <= 2) return launch<DMAX, 2>(q, k, v, mask, out, B, Q, K, D, C, stream);
  return launch<DMAX, 8>(q, k, v, mask, out, B, Q, K, D, C, stream);
}

}  // namespace

extern "C" int davo_match_attention(const void* query, const void* key, const void* value,
                                    const void* mask, void* out, int B, int Q, int K, int D,
                                    int C, void* stream) {
  if (B <= 0 || Q <= 0 || K < 0 || D <= 0 || D > 128 || C <= 0 || C > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * ((Q + kTileQ - 1) / kTileQ);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(query);
  const auto* kf = static_cast<const float*>(key);
  const auto* vf = static_cast<const float*>(value);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_c<32>(qf, kf, vf, mk, of, B, Q, K, D, C, st);
  if (D <= 64) return launch_c<64>(qf, kf, vf, mk, of, B, Q, K, D, C, st);
  return launch_c<128>(qf, kf, vf, mk, of, B, Q, K, D, C, st);
}
