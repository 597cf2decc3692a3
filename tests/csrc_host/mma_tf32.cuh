// Host stand-in for davo_tpu_torch/csrc/mma_tf32.cuh (the warp's TF32
// tensor-core product, its ldmatrix fragment loads and TF32 rounding), for
// the host build of the port's kernels.  It has the same name, so the host
// build, which searches this directory first, takes it in place of the
// card's inline PTX.
//
// The instructions are warp-collective, and each lane holds only its part
// of a fragment, in the layouts the card uses (mma_tf32.cuh lists them).  So
// each lane posts what it holds (the words of its fragments, its ldmatrix
// row address) in the block's exchange (cuda_runtime.h), meets the block
// at a barrier, gathers the whole tiles and computes its own part of the
// result, and meets the block again before the exchange is reused.  Every
// thread of the block must reach every such call, as the kernels ensure.
//
// As on the card, the product reads a TF32 operand's top 19 bits (a float
// that was not rounded has its low 13 mantissa bits dropped) and sums in
// float32; tf32_round rounds to nearest, ties away from zero, to 10
// mantissa bits (cvt.rna.tf32.f32 for a finite float), as the card's does.  An ldmatrix row address must be
// 16-byte aligned: elsewhere the launch reports the card's
// misaligned-address error.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

inline float tf32_round(float x) { return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u); }

inline float tf32_operand(uint32_t word) { return __uint_as_float(word & 0xffffe000u); }

inline void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  if (reinterpret_cast<uintptr_t>(row) % 16 != 0) g_misaligned = true;
  g_lane_rows[t_linear] = row;
  g_barrier->arrive_and_wait();
  const int warp0 = t_linear & ~31, lane = t_linear & 31;
  for (int i = 0; i < 4; ++i) r[i] = __float_as_uint(g_lane_rows[warp0 + 8 * i + (lane >> 2)][lane & 3]);
  g_barrier->arrive_and_wait();
}

inline void mma_tf32_16x8x8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint32_t* mine = &g_lane_words[12 * t_linear];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  for (int i = 0; i < 4; ++i) mine[6 + i] = __float_as_uint(d[i]);
  g_barrier->arrive_and_wait();
  const uint32_t* warp = &g_lane_words[12 * (t_linear & ~31)];
  // A[r][k]: lane 4 (r % 8) + k % 4, word (r >= 8) + 2 (k >= 4); B[k][n]:
  // lane 4 n + k % 4, word 4 + (k >= 4); C[r][n]: lane 4 (r % 8) + n / 2,
  // word 6 + 2 (r >= 8) + n % 2
  auto A = [&](int r, int k) { return tf32_operand(warp[12 * (4 * (r % 8) + k % 4) + (r >= 8) + 2 * (k >= 4)]); };
  auto B = [&](int k, int n) { return tf32_operand(warp[12 * (4 * n + k % 4) + 4 + (k >= 4)]); };
  auto Cw = [&](int r, int n) { return __uint_as_float(warp[12 * (4 * (r % 8) + n / 2) + 6 + 2 * (r >= 8) + n % 2]); };
  const int g = (t_linear & 31) >> 2, t = t_linear & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    float sum = Cw(r, n);
    for (int k = 0; k < 8; ++k) sum = std::fmaf(A(r, k), B(k, n), sum);
    out[i] = sum;
  }
  g_barrier->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
