#pragma once
// Host stand-in for cuda_bf16.h: bfloat16 storage (single and packed
// pairs) with round-to-nearest-even.
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = uint32_t(h.x) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) { uint32_t u; std::memcpy(&u, &f, 4); u += 0x7FFF + ((u >> 16) & 1); return {uint16_t(u >> 16)}; }
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float __low2float(__nv_bfloat162 h) { return __bfloat162float(h.x); }
inline float __high2float(__nv_bfloat162 h) { return __bfloat162float(h.y); }
