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
// all row-major float32; the mask is (B, K) bytes or null.
//
// Design: one block of kTileQ = 64 threads per (problem, tile of 64
// queries), one query row per thread; the grid is 1-D with blockIdx.x =
// b * q_tiles + tile.  The tile's queries pass through shared memory
// (coalesced reads) into registers: DMAX floats a thread, zero beyond D
// (DMAX = 32, 64 or 128 by template, so the dot products unroll fully).
// Keys, values and the mask stream through shared memory kTileK = 64 keys
// at a time; every thread of the block reads the same key, so a 16-byte
// shared load is a broadcast.  Scores are taken kChunk = 16 keys at a time
// into registers and the running max is raised once per chunk, so a key
// costs one exp.  The running max, the normaliser and the CMAX-wide
// accumulator (CMAX = 2 or 8) stay in registers, in float32.  Rows and
// keys beyond Q and K are masked inside the block: nothing is padded in
// device memory.
//
// What bounds it: operations.  At the matcher's shape (B = 3072 problems,
// Q = K = 144, D = 64, C = 2) the work is B (2QKD + 2QKC) = 8.4 GFLOP,
// 0.126 ms at the H100's 67 TFLOP/s float32 rate, against 234 MB of
// inputs and outputs (0.070 ms at 3.35 TB/s).  This design runs on the
// CUDA cores (no tensor cores, which would need TF32 or a split-precision
// product) and reads K and V once per query tile.

#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kChunk = 16;
constexpr float kNegInf = -1e30f;

template <int DMAX, int CMAX>
__global__ void __launch_bounds__(kTileQ) match_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, int Q, int K, int D,
    int C, int q_tiles, float scale) {
  // row stride DMAX + 4: 16-byte aligned rows, and the per-thread float4
  // reads of the query tile fall on distinct banks
  constexpr int kStride = DMAX + 4;
  __shared__ __align__(16) float kq_sh[kTileK * kStride];  // the queries, then each key tile
  __shared__ float v_sh[kTileK * CMAX];
  __shared__ float valid_sh[kTileK];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * kTileQ;

  const float* qb = q + static_cast<size_t>(b) * Q * D;
  for (int e = tid; e < kTileQ * DMAX; e += kTileQ) {
    const int r = e / DMAX;
    const int dd = e - r * DMAX;
    kq_sh[r * kStride + dd] =
        (q0 + r < Q && dd < D) ? qb[static_cast<size_t>(q0 + r) * D + dd] : 0.f;
  }
  __syncthreads();
  float qr[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(kq_sh + tid * kStride + i);
    qr[i] = x.x;
    qr[i + 1] = x.y;
    qr[i + 2] = x.z;
    qr[i + 3] = x.w;
  }
  __syncthreads();

  const float* kb = k + static_cast<size_t>(b) * K * D;
  const float* vb = v + static_cast<size_t>(b) * K * C;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * K;
  float m = kNegInf;
  float l = 0.f;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = tid; e < kTileK * DMAX; e += kTileQ) {
      const int r = e / DMAX;
      const int dd = e - r * DMAX;
      kq_sh[r * kStride + dd] =
          (k0 + r < K && dd < D) ? kb[static_cast<size_t>(k0 + r) * D + dd] : 0.f;
    }
    for (int e = tid; e < kTileK * CMAX; e += kTileQ) {
      const int r = e / CMAX;
      const int c = e - r * CMAX;
      v_sh[e] = (k0 + r < K && c < C) ? vb[static_cast<size_t>(k0 + r) * C + c] : 0.f;
    }
    for (int r = tid; r < kTileK; r += kTileQ) {
      const int j = k0 + r;
      valid_sh[r] = (j < K && (mb == nullptr || mb[j] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();
    const int n = min(kTileK, K - k0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      float m_next = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = kq_sh + (c0 + j) * kStride;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DMAX; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(kr + i);
          dot = fmaf(qr[i], x.x, dot);
          dot = fmaf(qr[i + 1], x.y, dot);
          dot = fmaf(qr[i + 2], x.z, dot);
          dot = fmaf(qr[i + 3], x.w, dot);
        }
        s[j] = dot * scale;
        if (valid_sh[c0 + j] != 0.f) m_next = fmaxf(m_next, s[j]);
      }
      const float alpha = expf(m - m_next);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) acc[c] *= alpha;
      m = m_next;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        // the explicit zero keeps a masked key out whatever its score
        const float p = valid_sh[c0 + j] != 0.f ? expf(s[j] - m) : 0.f;
        l += p;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) acc[c] = fmaf(p, v_sh[(c0 + j) * CMAX + c], acc[c]);
      }
    }
    __syncthreads();
  }

  const int row = q0 + tid;
  if (row < Q) {
    const float normaliser = fmaxf(l, 1e-30f);
    float* ob = out + (static_cast<size_t>(b) * Q + row) * C;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) ob[c] = acc[c] / normaliser;
  }
}

template <int DMAX, int CMAX>
int launch(const float* q, const float* k, const float* v, const unsigned char* mask,
           float* out, int B, int Q, int K, int D, int C, cudaStream_t stream) {
  const int q_tiles = (Q + kTileQ - 1) / kTileQ;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(B * q_tiles);
  match_attention_kernel<DMAX, CMAX><<<grid, kTileQ, 0, stream>>>(
      q, k, v, mask, out, Q, K, D, C, q_tiles, scale);
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
