// CPU stand-in for cuda_bf16.h: bfloat16 as its 16 bits, converted as the
// card converts (widening exactly, narrowing to nearest even).
#pragma once
#include <cstring>

#include "cuda_runtime.h"

struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };

inline float bf2f(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {bf2f(v.a), bf2f(v.b)};
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
