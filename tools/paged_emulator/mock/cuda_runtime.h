// CPU stand-in for the parts of the CUDA runtime and device intrinsics that
// ops/csrc/paged_attention.cu uses.  Threads of a block are std::threads
// (harness.cpp): threadIdx is thread-local, __syncthreads a barrier and
// __shfl_xor_sync an exchange through a per-warp buffer.  The explicitly
// rounded intrinsics are IEEE float operations here as on the card.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  dim3(int = 1, int = 1, int = 1) {}
};
struct uint3_ {
  unsigned x, y, z;
};
extern thread_local uint3_ threadIdx;
extern uint3_ blockIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
struct int2 { int x, y; };

inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
float __shfl_sync(unsigned mask, float v, int src_lane);
void __syncthreads();

using std::max;
using std::min;
inline int min(int a, int b) { return a < b ? a : b; }
