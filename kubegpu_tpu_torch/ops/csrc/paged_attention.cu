// Paged decode attention for Hopper (sm_90a): one query token per slot
// over a KV page pool shared by every slot.
//
// Replaces the TPU kernel kubegpu_tpu/ops/paged_attention.py::_paged_kernel
// (called through paged_decode_attention).  It computes what that kernel
// computes, not its grid: the Pallas kernel walks a (slot, page) grid in
// order on one core and carries the online-softmax state in VMEM scratch
// from one grid step to the next; here one thread block owns one
// (slot, head) pair and walks the slot's page table in a loop, keeping
// the state in registers.
//
// Bound: the kernel is bandwidth-bound.  It must read each live K/V row
// once, about 2 * sum_b len_b * h * hd * itemsize bytes, over the card's
// 3.35 TB/s; the arithmetic is 4 flops per K/V element, far below the
// card's rate for those bytes.  The design spends bytes only on live
// pages: a block reads lengths[b], walks table[b, 0 : ceil(len/page)] and
// never touches a page past the slot's length (the GPU form of the TPU
// kernel's dead-page DMA elision), and within the last live page it
// reads only rows below the length.  Loads are 16 bytes a thread with
// neighbouring threads on neighbouring addresses: a group of
// HD * sizeof(T) / 16 threads reads one whole row, and the block reads
// kRowGroups consecutive rows per pass.
//
// Layouts (as in the JAX package): q (b, h, hd); pools (P, h, page, hd);
// table (b, table_width) int32; lengths (b,) int32; out (b, h, hd) in q's
// dtype.  Scores, softmax state and the accumulator are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 16-byte vector loads widened to float32.
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a JAX cast
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Thread layout over one (page, HD) block: kLanes threads per row, each
// holding kVec consecutive elements of the row; kRowGroups rows in
// flight.  Thread t is lane t % kLanes of row group t / kLanes.
template <typename T, int HD>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLanes = HD / kVec;
  static constexpr int kRowGroups = kThreads / kLanes;
  static_assert(HD % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "a row must fit a power-of-two share of one warp");
};

// The online-softmax state one thread carries across pages.  m and l are
// the same in every thread of the block; acc holds this thread's kVec
// columns summed over the rows of its row group only (the row groups are
// added up once, at the end).
template <int VEC>
struct FoldState {
  float m;
  float l;
  float acc[VEC];
};

// Fold one live page into the state, in the order of the Pallas kernel:
// page max, shift, p = exp(s - shift), correction, l, acc.  kpage/vpage
// point at this head's (page, HD) block; n_rows (>= 1) rows lie below the
// slot's length — the rest of the page is masked, which leaves max and
// sums as if its scores were -inf.  s_smem holds one float per page row.
// Shared by every kernel that walks a page table (the multi-query verify
// kernel folds each of its rows through this same routine, which is what
// keeps its row j bit-identical to this kernel at length + j).
template <typename T, int HD>
__device__ __forceinline__ void fold_page(
    const T* __restrict__ kpage, const T* __restrict__ vpage, int n_rows,
    const float (&q)[Layout<T, HD>::kVec], float sm_scale, float* s_smem,
    float* red, FoldState<Layout<T, HD>::kVec>& st) {
  using L = Layout<T, HD>;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;
  // scores: each row group dots its rows with q across its kLanes lanes
  for (int r0 = 0; r0 < n_rows; r0 += L::kRowGroups) {
    const int r = r0 + group;
    float part = 0.f;
    if (r < n_rows) {
      float kf[L::kVec];
      load16(kpage + (size_t)r * HD + lane * L::kVec, kf);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i) part += q[i] * kf[i];
    }
#pragma unroll
    for (int o = L::kLanes / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0 && r < n_rows) s_smem[r] = part * sm_scale;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int r = threadIdx.x; r < n_rows; r += kThreads)
    mx = fmaxf(mx, s_smem[r]);
  const float m_cur = block_max(mx, red);
  const float m_new = fmaxf(st.m, m_cur);
  const float shift = isfinite(m_new) ? m_new : 0.f;
  const float correction = isfinite(st.m) ? expf(st.m - shift) : 0.f;
  float psum = 0.f;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const float p = expf(s_smem[r] - shift);
    s_smem[r] = p;
    psum += p;
  }
  // block_sum's barriers also publish the p values written above
  st.l = correction * st.l + block_sum(psum, red);
#pragma unroll
  for (int i = 0; i < L::kVec; ++i) st.acc[i] *= correction;
  for (int r = group; r < n_rows; r += L::kRowGroups) {
    const float p = s_smem[r];
    float vf[L::kVec];
    load16(vpage + (size_t)r * HD + lane * L::kVec, vf);
#pragma unroll
    for (int i = 0; i < L::kVec; ++i) st.acc[i] += p * vf[i];
  }
  st.m = m_new;
  __syncthreads();  // s_smem is rewritten by the next page
}

// grid (h, b); one block per (slot, head).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int heads,
    int page, int table_width, float sm_scale) {
  using L = Layout<T, HD>;
  extern __shared__ float smem[];
  float* red = smem;            // kWarps floats (padded to 32)
  float* s_smem = smem + 32;    // page floats
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;

  float qf[L::kVec];
  load16(q + ((size_t)b * heads + h) * HD + lane * L::kVec, qf);
  FoldState<L::kVec> st;
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < L::kVec; ++i) st.acc[i] = 0.f;

  const int len = lengths[b];
  // pages past the table's width are never visited, as on the TPU grid
  const int n_live = len > 0 ? min((len + page - 1) / page, table_width) : 0;
  for (int p = 0; p < n_live; ++p) {
    const int phys = table[(size_t)b * table_width + p];
    const size_t base = (((size_t)phys * heads + h) * page) * HD;
    fold_page<T, HD>(k_pool + base, v_pool + base, min(page, len - p * page),
                     qf, sm_scale, s_smem, red, st);
  }

  // add up the row groups' partial accumulators, then divide; a length-0
  // slot has l == 0 and writes zeros
  float* accs = smem + 32;      // kRowGroups * HD floats
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kVec; ++i)
    accs[group * HD + lane * L::kVec + i] = st.acc[i];
  __syncthreads();
  const float denom = st.l == 0.f ? 1.f : st.l;
  T* o = out + ((size_t)b * heads + h) * HD;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < L::kRowGroups; ++g) a += accs[g * HD + d];
    store(o + d, a / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int b,
                   int h, int page, int table_width, float sm_scale,
                   cudaStream_t stream) {
  using L = Layout<T, HD>;
  const int floats = 32 + (page > L::kRowGroups * HD ? page
                                                     : L::kRowGroups * HD);
  const size_t smem = (size_t)floats * sizeof(float);
  auto kernel = paged_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(out), h,
      page, table_width, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, pools and out alike); hd must be 128,
// the serving path's head width.  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream`.
int kg_paged_decode_attention(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* lengths, void* out, int b, int h,
                              int hd, int page, int table_width,
                              float sm_scale, void* stream) {
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || h > 65535 || b > 65535 || page <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 128)
    return (int)launch<float, 128>(q, k_pool, v_pool, tbl, len, out, b, h,
                                   page, table_width, sm_scale, s);
  if (dtype == 1 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k_pool, v_pool, tbl, len, out,
                                           b, h, page, table_width,
                                           sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
