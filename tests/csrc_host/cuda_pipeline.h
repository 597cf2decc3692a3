// Host stand-in for CUDA's asynchronous copies into shared memory
// (<cuda_pipeline.h>: cp.async), for the host build of the port's kernels.
// Each thread queues its copies; __pipeline_commit closes a group, and
// __pipeline_wait_prior(n) performs every committed group but the newest
// n.  So a copy lands only where the card guarantees it has, and a kernel
// that reads its tile before waiting for it reads stale data here too.
// Source and destination must be aligned to the copy's size (4, 8 or 16
// bytes); elsewhere the launch reports the card's misaligned-address error.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

#include "cuda_runtime.h"

struct PendingCopy {
  void* dst;
  const void* src;
  size_t bytes;
};
inline thread_local std::vector<PendingCopy> t_open_group;
inline thread_local std::deque<std::vector<PendingCopy>> t_committed;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes) {
  if ((bytes != 4 && bytes != 8 && bytes != 16) ||
      (reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % bytes != 0)
    g_misaligned = true;
  t_open_group.push_back({dst, src, bytes});
}

inline void __pipeline_commit() {
  t_committed.push_back(std::move(t_open_group));
  t_open_group.clear();
}

inline void __pipeline_wait_prior(size_t prior) {
  while (t_committed.size() > prior) {
    for (const PendingCopy& c : t_committed.front()) std::memcpy(c.dst, c.src, c.bytes);
    t_committed.pop_front();
  }
}
