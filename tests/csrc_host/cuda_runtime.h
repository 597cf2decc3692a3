// Host stand-in for the part of the CUDA runtime the port's kernels use,
// so tests can compile csrc/*.cu with a C++20 host compiler: the threads of
// a block run as std::threads that meet at a barrier for __syncthreads.
// A warp shuffle is an exchange through a per-block buffer between two
// barrier arrivals, and __syncwarp is a block barrier: both hold only where
// every thread of the block reaches every shuffle, as the kernels ensure
// (a ragged block's idle lanes are masked, never returned early).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
// block-shared arrays: one copy that a block's threads share (blocks run in turn)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 {
  int x, y, z;
  dim3(int x_ = 1, int y_ = 1, int z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx;
inline thread_local int t_linear;  // threadIdx.x + threadIdx.y * blockDim.x: warps are runs of 32
inline dim3 blockIdx, blockDim;
inline std::barrier<>* g_barrier = nullptr;
inline std::vector<float> g_dyn_smem;
inline std::vector<float> g_exchange;  // one slot per thread of the block
// warp-collective matrix instructions (mma_tf32.cuh): 12 words and a row
// address per thread of the block
inline std::vector<uint32_t> g_lane_words;
inline std::vector<const float*> g_lane_rows;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_barrier->arrive_and_wait(); }
inline float shuffle_from(float v, int src_lane) {
  g_exchange[t_linear] = v;
  g_barrier->arrive_and_wait();
  const float r = g_exchange[(t_linear & ~31) | (src_lane & 31)];
  g_barrier->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask, int = 32) {
  return shuffle_from(v, (t_linear & 31) ^ lane_mask);
}
inline float __shfl_sync(unsigned, float v, int src_lane, int = 32) { return shuffle_from(v, src_lane); }
inline float __uint_as_float(uint32_t u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
inline uint32_t __float_as_uint(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return u;
}
// The card faults on an access that is not aligned to its type's size;
// here such an access is recorded and the launch reports the card's error.
inline std::atomic<bool> g_misaligned{false};
template <typename T> void check_aligned(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % alignof(T) != 0) g_misaligned = true;
}
// cache-streaming loads and stores: plain ones on the host
template <typename T> T __ldcs(const T* p) { check_aligned(p); return *p; }
template <typename T> void __stcs(T* p, T v) { check_aligned(p); *p = v; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() {
  return g_misaligned.exchange(false) ? cudaErrorMisalignedAddress : cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline void emulate(dim3 grid, dim3 block, size_t shared, cudaStream_t,
                    const std::function<void()>& body) {
  g_dyn_smem.assign(shared / sizeof(float) + 1, 0.f);
  blockDim = block;
  const int threads_per_block = block.x * block.y;
  g_exchange.assign(threads_per_block, 0.f);
  g_lane_words.assign(12 * threads_per_block, 0u);
  g_lane_rows.assign(threads_per_block, nullptr);
  for (int b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(threads_per_block);
    g_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < threads_per_block; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t % block.x, t / block.x);
        t_linear = t;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
