// Warp-level TF32 tensor-core primitives for the port's kernels (K3,
// match_attention.cu): the mma.sync m16n8k8 product, the ldmatrix load of
// its fragments from shared memory, and the TF32 rounding.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g + 8][t],
//                          a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   B (8 x 16 -> 8 x 8, column-major): b0 = B[t][g], b1 = B[t + 4][g]
//   C, D (16 x 8): c0 = C[g][2t], c1 = C[g][2t + 1],
//                  c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
// ldmatrix.x4 reads four 8 x 4 tiles of 32-bit words (8 rows of 16 bytes;
// lanes 8i .. 8i + 7 give the row addresses of tile i) and hands lane 4 g
// + t the word at row g, column t of each tile: from a row-major 16 x 8
// tile of A (rows r = lane & 15, columns 4 (lane >> 4) ..) it yields a0-a3;
// from 16 rows of a row-major K (B = K^T) it yields b0, b1 of two 8-column
// halves.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// x rounded to TF32: round to nearest, ties away from zero, 10 mantissa
// bits.  For a finite x this is cvt.rna.tf32.f32 (half an ulp added to the
// magnitude, the low 13 bits cleared), in two integer instructions where
// the PTX instruction takes four; inf stays inf and NaN stays non-finite.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Four 8 x 4 tiles of 32-bit words from shared memory (see above); row: this
// lane's row address, 16-byte aligned.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b on the tensor cores: a 16 x 8 and b 8 x 8 in TF32, d float32
__device__ __forceinline__ void mma_tf32_16x8x8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));  // registers only: free to schedule
}

}  // namespace
