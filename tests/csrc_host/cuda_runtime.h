// Host stand-in for the part of the CUDA runtime the port's kernels use,
// so tests can compile csrc/*.cu with a C++20 host compiler: the threads of
// a block run as std::threads that meet at a barrier for __syncthreads.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
// block-shared arrays: one copy that a block's threads share (blocks run in turn)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) float4 {
  float x, y, z, w;
};
struct dim3 {
  int x, y, z;
  dim3(int x_ = 1, int y_ = 1, int z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
inline std::barrier<>* g_barrier = nullptr;
inline std::vector<float> g_dyn_smem;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline void emulate(dim3 grid, dim3 block, size_t shared, cudaStream_t,
                    const std::function<void()>& body) {
  g_dyn_smem.assign(shared / sizeof(float) + 1, 0.f);
  blockDim = block;
  const int threads_per_block = block.x * block.y;
  for (int b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(threads_per_block);
    g_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < threads_per_block; ++t)
      threads.emplace_back([&, t] { threadIdx = dim3(t % block.x, t / block.x); body(); });
    for (auto& th : threads) th.join();
  }
}
