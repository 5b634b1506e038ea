// CPU stand-in for the cp.async part of ops/csrc/hopper.cuh.  A thread's
// copies are queued and land only when a wait retires their group, the
// latest the card may land them; with -DEAGER they land when issued, the
// earliest.  A kernel right under both orders reads no tile too early and
// overwrites none too soon.
#pragma once
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>

#include "cuda_runtime.h"

extern char* g_smem_base;

namespace hopper {

inline uint32_t smem_u32(const void* p) {
  return (uint32_t)((const char*)p - g_smem_base);
}

struct Copy {
  uint32_t dst;
  const void* src;
  int bytes;
};
inline thread_local std::vector<Copy> open_group;
inline thread_local std::deque<std::vector<Copy>> groups;

inline void copy(uint32_t dst, const void* src, int bytes) {
  if (dst % bytes || (uintptr_t)src % bytes) {
    std::fprintf(stderr, "cp.async of %d bytes misaligned\n", bytes);
    std::abort();
  }
#ifdef EAGER
  std::memcpy(g_smem_base + dst, src, bytes);
#else
  open_group.push_back({dst, src, bytes});
#endif
}
inline void cp_async_16(uint32_t dst, const void* src) { copy(dst, src, 16); }
inline void cp_async_8(uint32_t dst, const void* src) { copy(dst, src, 8); }
inline void cp_async_commit() {
  groups.push_back(std::move(open_group));
  open_group.clear();
}
template <int N>
inline void cp_async_wait() {
  while ((int)groups.size() > N) {
    for (const Copy& c : groups.front())
      std::memcpy(g_smem_base + c.dst, c.src, c.bytes);
    groups.pop_front();
  }
}

}  // namespace hopper
