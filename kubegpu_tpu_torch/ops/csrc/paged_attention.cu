// Paged attention for Hopper (sm_90a) over a KV page pool shared by every
// slot: one query token per slot (K1, the decode step) and a window of L
// query tokens per slot (K2, the speculative verify).
//
// K1 replaces the TPU kernel kubegpu_tpu/ops/paged_attention.py::_paged_kernel
// (called through paged_decode_attention); K2 replaces
// ::_paged_chunk_kernel (called through paged_chunk_attention).  They
// compute what those kernels compute, not their grid: a Pallas kernel walks
// a (slot, page) grid in order on one core and carries the online-softmax
// state in VMEM scratch from one grid step to the next; here one thread
// block owns one (slot, head) pair and walks the slot's page table in a
// loop, keeping the state in registers.
//
// Bound: both kernels are bandwidth-bound.  K1 must read each live K/V row
// once, about 2 * sum_b len_b * h * hd * itemsize bytes, over the card's
// 3.35 TB/s; the arithmetic is 4 flops per K/V element, far below the
// card's rate for those bytes.  K2 reads the rows of its widest query row
// (len_b + L - 1) and does 4 * L flops per element, still below the
// card's flops-to-bytes ratio for L <= 8.  The design spends bytes only on
// live pages: a block reads lengths[b], walks table[b, 0 : ceil(len/page)]
// (K2: the widest row's len + L - 1) and never touches a page past it (the
// GPU form of the TPU kernels' dead-page DMA elision), and within the last
// live page it reads only rows below the length.  Loads are 16 bytes a
// thread with neighbouring threads on neighbouring addresses: a group of
// HD * sizeof(T) / 16 threads reads one whole row, and the block reads
// kRowGroups consecutive rows per pass.  K2 folds each of its query rows
// through K1's fold_page in turn, re-reading a page once per row that
// reaches it (L1/L2 serve the repeats); that keeps its row j bit-identical
// to K1 at length + j.  A window wider than kMaxRows rows is walked in
// groups of kMaxRows rows, each group walking the pages of its own widest
// row, so the states in registers and the q rows in shared memory stay
// bounded whatever L is.
//
// Head widths.  The reference's blocks span any hd; these kernels take every
// multiple of 8 up to 128.  The serving path's widths, 64 and 128, have
// exact instantiations (HD == hd: every lane of a row reads, no mask).
// Every other width runs a padded instantiation, HD = 32 for hd <= 32 and
// 128 above: the lane count stays a power of two (the shfl_xor tree of a
// row's dot), lanes whose columns lie at or past hd neither load nor add,
// and rows are hd elements apart.  A padded int8 pool is read 8 bytes a
// lane (its rows, hd bytes apart, are only 8-byte aligned when hd is an odd
// multiple of 8).
//
// Pages.  A page's scores sit in shared memory, one f32 per page row, so
// the page max comes first, as in the Pallas body; any page whose scores
// (beside K2's q rows) fit the card's opt-in shared memory is taken.
//
// Layouts (as in the JAX package): q (b, h, hd) for K1, (b, L, h, hd) for
// K2; pools (P, h, page, hd); table (b, table_width) int32; lengths (b,)
// int32 (K2: rows attendable by query row 0, row j sees lengths + j); out
// shaped as q, in q's dtype.  Scores, softmax state and the accumulator are
// float32.
//
// K1q and K2q replace the same two Pallas bodies' quant=True branch: the
// pools hold int8 and two (P, h) float32 arrays hold one scale per page per
// head.  They are the same kernels instantiated with an int8 pool type TP:
// each load brings 16 (padded: 8) int8 values of a row, which are cast to
// f32 and multiplied by the page's per-head scale (loaded once per page)
// before the dot with q or the weighting by p -- the Pallas order; the
// scale is never folded into q or the score.  q (bf16 or f32) is loaded to
// the pool's layout, one to four 16-byte loads a lane.  The bound halves
// with the bytes: about 1 byte per live K/V element plus 8 bytes of scales
// per live page and head.  The full-width instantiations (TP == T) never
// read the scale pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;

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

__device__ __forceinline__ void load16(const int8_t* p, float (&out)[16]) {
  const int4 r = *reinterpret_cast<const int4*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(v[i]);
}

// 8 int8 values: a padded int8 row's lane.
__device__ __forceinline__ void load16(const int8_t* p, float (&out)[8]) {
  const int2 r = *reinterpret_cast<const int2*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(v[i]);
}

// N consecutive elements widened to float32, in 16-byte loads: one load
// when T is the pool's type, two or four when q (bf16 or f32) is read to an
// int8 pool's layout.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&out)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "a lane reads whole 16-byte vectors");
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    float f[kPer];
    load16(p + c * kPer, f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = f[i];
  }
}

template <typename TP>
constexpr bool kQuantPool = std::is_same<TP, int8_t>::value;

// One vector of a pool row as float32; an int8 row is dequantized by its
// page's per-head scale, cast first and multiplied after (the explicitly
// rounded product keeps it from being contracted into the dot).
template <typename TP, int N>
__device__ __forceinline__ void load_pool(const TP* p, float scale,
                                          float (&out)[N]) {
  load16(p, out);
  if constexpr (kQuantPool<TP>) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __fmul_rn(out[i], scale);
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

// Thread layout over one (page, HD) block of a pool of element type TP:
// kLanes threads per row, each holding kVec consecutive elements of the
// row; kRowGroups rows in flight.  Thread t is lane t % kLanes of row group
// t / kLanes.  kPadded: the run-time width hd may be below HD (rows are hd
// elements apart and lanes at or past hd are idle).
template <typename TP, int HD, bool kPadded>
struct Layout {
  static constexpr int kVec = kQuantPool<TP> && kPadded ? 8 : 16 / sizeof(TP);
  static constexpr int kLanes = HD / kVec;
  static constexpr int kRowGroups = kThreads / kLanes;
  static_assert(HD % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "a row must fit a power-of-two share of one warp");
  // the elements between two rows, and whether this lane holds columns
  // of the row (always, at an exact width)
  static __device__ __forceinline__ int row(int hd) {
    return kPadded ? hd : HD;
  }
  static __device__ __forceinline__ bool active(int lane, int hd) {
    return !kPadded || lane * kVec < hd;
  }
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
// point at this head's (page, hd) block; n_rows (>= 1) rows lie below the
// slot's length — the rest of the page is masked, which leaves max and
// sums as if its scores were -inf.  s_smem holds one float per page row.
// k_scale/v_scale dequantize an int8 page (unused at full width); q is
// zero in an idle lane.  Shared by both kernels: K2 folds each of its
// query rows through this same routine, which is what keeps its row j
// bit-identical to K1 at length + j.  The multiply-adds are spelled as
// explicit round-to-nearest intrinsics, which the compiler never contracts
// or reorders, so the two kernels cannot round differently around the
// inlined copies.
template <typename TP, int HD, bool kPadded>
__device__ __forceinline__ void fold_page(
    const TP* __restrict__ kpage, const TP* __restrict__ vpage,
    float k_scale, float v_scale, int n_rows, int hd,
    const float (&q)[Layout<TP, HD, kPadded>::kVec], float sm_scale,
    float* s_smem, float* red,
    FoldState<Layout<TP, HD, kPadded>::kVec>& st) {
  using L = Layout<TP, HD, kPadded>;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;
  const int row = L::row(hd);
  const bool active = L::active(lane, hd);
  // scores: each row group dots its rows with q across its kLanes lanes
  for (int r0 = 0; r0 < n_rows; r0 += L::kRowGroups) {
    const int r = r0 + group;
    float part = 0.f;
    if (r < n_rows && active) {
      float kf[L::kVec];
      load_pool(kpage + (size_t)r * row + lane * L::kVec, k_scale, kf);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i) part = __fmaf_rn(q[i], kf[i], part);
    }
#pragma unroll
    for (int o = L::kLanes / 2; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (lane == 0 && r < n_rows) s_smem[r] = __fmul_rn(part, sm_scale);
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int r = threadIdx.x; r < n_rows; r += kThreads)
    mx = fmaxf(mx, s_smem[r]);
  const float m_cur = block_max(mx, red);
  const float m_new = fmaxf(st.m, m_cur);
  const float shift = isfinite(m_new) ? m_new : 0.f;
  const float correction =
      isfinite(st.m) ? expf(__fsub_rn(st.m, shift)) : 0.f;
  float psum = 0.f;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const float p = expf(__fsub_rn(s_smem[r], shift));
    s_smem[r] = p;
    psum = __fadd_rn(psum, p);
  }
  // block_sum's barriers also publish the p values written above
  st.l = __fmaf_rn(correction, st.l, block_sum(psum, red));
#pragma unroll
  for (int i = 0; i < L::kVec; ++i) st.acc[i] = __fmul_rn(st.acc[i], correction);
  if (active) {
    for (int r = group; r < n_rows; r += L::kRowGroups) {
      const float p = s_smem[r];
      float vf[L::kVec];
      load_pool(vpage + (size_t)r * row + lane * L::kVec, v_scale, vf);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i)
        st.acc[i] = __fmaf_rn(p, vf[i], st.acc[i]);
    }
  }
  st.m = m_new;
  __syncthreads();  // s_smem is rewritten by the next page
}

template <int VEC>
__device__ __forceinline__ void init_state(FoldState<VEC>& st) {
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) st.acc[i] = 0.f;
}

// This lane's kVec columns of a q row (at its first element) as float32,
// zero in an idle lane.
template <typename T, typename TP, int HD, bool kPadded>
__device__ __forceinline__ void load_q(
    const T* __restrict__ q_row, int lane, int hd,
    float (&qf)[Layout<TP, HD, kPadded>::kVec]) {
  using L = Layout<TP, HD, kPadded>;
  if (L::active(lane, hd)) {
    load_floats(q_row + lane * L::kVec, qf);
  } else {
#pragma unroll
    for (int i = 0; i < L::kVec; ++i) qf[i] = 0.f;
  }
}

// Add up the row groups' partial accumulators of one query row, divide and
// store its hd outputs at o (in q's type T); a row that attended nothing
// has l == 0 and writes zeros.  accs holds kRowGroups * HD floats of shared
// memory; the leading barrier lets a caller finish several rows through
// one buffer.
template <typename T, typename TP, int HD, bool kPadded>
__device__ __forceinline__ void finish_row(
    const FoldState<Layout<TP, HD, kPadded>::kVec>& st, int hd, float* accs,
    T* o) {
  using L = Layout<TP, HD, kPadded>;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;
  const int width = L::row(hd);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kVec; ++i)
    accs[group * HD + lane * L::kVec + i] = st.acc[i];
  __syncthreads();
  const float denom = st.l == 0.f ? 1.f : st.l;
  for (int d = threadIdx.x; d < width; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < L::kRowGroups; ++g) a = __fadd_rn(a, accs[g * HD + d]);
    store(o + d, __fdiv_rn(a, denom));
  }
}

// The per-head scales of one physical page: read once per page, by every
// thread (one broadcast load each); 1 at full width, where nothing is read.
template <typename TP>
__device__ __forceinline__ void page_scales(const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            size_t at, float& k, float& v) {
  if constexpr (kQuantPool<TP>) {
    k = ks[at];
    v = vs[at];
  } else {
    k = v = 1.f;
  }
}

// grid (h, b); one block per (slot, head).  T is q's and out's type, TP the
// pool's (T at full width, int8 for K1q).
template <typename T, typename TP, int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const TP* __restrict__ k_pool,
    const TP* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int heads, int hd,
    int page, int table_width, float sm_scale) {
  using L = Layout<TP, HD, kPadded>;
  extern __shared__ float smem[];
  float* red = smem;            // kWarps floats (padded to 32)
  float* s_smem = smem + 32;    // page floats
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % L::kLanes;
  const int row = L::row(hd);

  float qf[L::kVec];
  load_q<T, TP, HD, kPadded>(q + ((size_t)b * heads + h) * row, lane, hd, qf);
  FoldState<L::kVec> st;
  init_state(st);

  const int len = lengths[b];
  // pages past the table's width are never visited, as on the TPU grid
  const int n_live = len > 0 ? min((len + page - 1) / page, table_width) : 0;
  for (int p = 0; p < n_live; ++p) {
    const int phys = table[(size_t)b * table_width + p];
    const size_t base = (((size_t)phys * heads + h) * page) * row;
    float ks, vs;
    page_scales<TP>(k_scales, v_scales, (size_t)phys * heads + h, ks, vs);
    fold_page<TP, HD, kPadded>(k_pool + base, v_pool + base, ks, vs,
                               min(page, len - p * page), hd, qf, sm_scale,
                               s_smem, red, st);
  }
  // s_smem is free once the walk is done: it holds the row groups' sums
  finish_row<T, TP, HD, kPadded>(st, hd, s_smem,
                                 out + ((size_t)b * heads + h) * row);
}

// Query rows K2 folds in one walk of the pages: their online-softmax states
// sit in registers and their q rows in shared memory; a wider window is
// walked in groups of kMaxRows rows.
constexpr int kMaxRows = 8;

// grid (h, b); one block per (slot, head).  Each group of up to kMaxRows
// query rows walks the pages of its widest row (limit len + its last row).
// On each page, row j folds only if its own window reaches the page, and
// then exactly the rows below len + j: the pages, row counts and fold K1
// would see at length len + j.
template <typename T, typename TP, int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads) paged_chunk_kernel(
    const T* __restrict__ q, const TP* __restrict__ k_pool,
    const TP* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int rows,
    int heads, int hd, int page, int table_width, float sm_scale) {
  using L = Layout<TP, HD, kPadded>;
  extern __shared__ float smem[];
  float* red = smem;                      // kWarps floats (padded to 32)
  float* q_smem = smem + 32;              // a group's q rows, widened
  float* s_smem = q_smem + kMaxRows * HD; // page floats, then the row sums
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % L::kLanes;
  const int row = L::row(hd);
  const int len = lengths[b];

  for (int j0 = 0; j0 < rows; j0 += kMaxRows) {
    const int n = min(kMaxRows, rows - j0);
    // stage the group's q rows in shared memory as float32: vector v of a
    // row covers columns [v * kVec, (v + 1) * kVec), the pool's layout.
    // The last group's folds and sums are done with both buffers: its
    // finish_row ended past its barriers, and the folds below start after
    // the barrier that follows.
    for (int v = threadIdx.x; v < n * L::kLanes; v += kThreads) {
      const int j = v / L::kLanes;
      float f[L::kVec];
      load_q<T, TP, HD, kPadded>(
          q + (((size_t)b * rows + j0 + j) * heads + h) * row, v % L::kLanes,
          hd, f);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i)
        q_smem[j * HD + (v % L::kLanes) * L::kVec + i] = f[i];
    }
    __syncthreads();

    FoldState<L::kVec> st[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) init_state(st[j]);

    const int widest = len + j0 + n - 1;
    const int n_live =
        widest > 0 ? min((widest + page - 1) / page, table_width) : 0;
    for (int p = 0; p < n_live; ++p) {
      const int phys = table[(size_t)b * table_width + p];
      const size_t base = (((size_t)phys * heads + h) * page) * row;
      float ks, vs;
      page_scales<TP>(k_scales, v_scales, (size_t)phys * heads + h, ks, vs);
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        const int limit = len + j0 + j;
        // block-uniform: every thread takes the same branch to the barriers
        if (j < n && p * page < limit) {
          float qf[L::kVec];
#pragma unroll
          for (int i = 0; i < L::kVec; ++i)
            qf[i] = q_smem[j * HD + lane * L::kVec + i];
          fold_page<TP, HD, kPadded>(k_pool + base, v_pool + base, ks, vs,
                                     min(page, limit - p * page), hd, qf,
                                     sm_scale, s_smem, red, st[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < n)
        finish_row<T, TP, HD, kPadded>(
            st[j], hd, s_smem,
            out + (((size_t)b * rows + j0 + j) * heads + h) * row);
  }
}

template <typename TP, int HD, bool kPadded>
size_t smem_floats(int page, int q_floats) {
  using L = Layout<TP, HD, kPadded>;
  return 32 + q_floats
         + (page > L::kRowGroups * HD ? page : L::kRowGroups * HD);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename TP, int HD, bool kPadded>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, void* out, int b, int h, int hd,
                   int page, int table_width, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<TP, HD, kPadded>(page, 0) * sizeof(float);
  auto kernel = paged_decode_kernel<T, TP, HD, kPadded>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, table, lengths,
      static_cast<T*>(out), h, hd, page, table_width, sm_scale);
  return cudaGetLastError();
}

template <typename T, typename TP, int HD, bool kPadded>
cudaError_t launch_chunk(const void* q, const void* kp, const void* vp,
                         const float* ks, const float* vs, const int* table,
                         const int* lengths, void* out, int b, int rows,
                         int h, int hd, int page, int table_width,
                         float sm_scale, cudaStream_t stream) {
  const size_t smem =
      smem_floats<TP, HD, kPadded>(page, kMaxRows * HD) * sizeof(float);
  auto kernel = paged_chunk_kernel<T, TP, HD, kPadded>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, table, lengths,
      static_cast<T*>(out), rows, h, hd, page, table_width, sm_scale);
  return cudaGetLastError();
}

template <int HD, bool kPadded>
struct Width {
  static constexpr int hd = HD;
  static constexpr bool padded = kPadded;
};

// Call f(Width<HD, padded>) for the instantiation that serves head width
// hd: exact at 64 and 128, padded to 32 or 128 otherwise.
template <typename F>
cudaError_t by_width(int hd, F&& f) {
  if (hd == 128) return f(Width<128, false>{});
  if (hd == 64) return f(Width<64, false>{});
  if (hd <= 32) return f(Width<32, true>{});
  return f(Width<128, true>{});
}

bool bad_geometry(int b, int h, int hd, int page) {
  return b <= 0 || h <= 0 || h > 65535 || b > 65535 || page <= 0 ||
         hd < 8 || hd > kMaxHeadDim || hd % 8 != 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, pools and out alike); hd a multiple of
// 8 up to 128.  Returns the launch's cudaError_t (0 on success); the kernel
// runs on `stream`.
int kg_paged_decode_attention(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* lengths, void* out, int b, int h,
                              int hd, int page, int table_width,
                              float sm_scale, void* stream) {
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(b, h, hd, page)) return (int)cudaErrorInvalidValue;
  return (int)by_width(hd, [&](auto w) {
    using W = decltype(w);
    if (dtype == 0)
      return launch<float, float, W::hd, W::padded>(
          q, k_pool, v_pool, nullptr, nullptr, tbl, len, out, b, h, hd, page,
          table_width, sm_scale, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16, W::hd, W::padded>(
          q, k_pool, v_pool, nullptr, nullptr, tbl, len, out, b, h, hd, page,
          table_width, sm_scale, s);
    return cudaErrorInvalidValue;
  });
}

// K1q: int8 pools with (P, h) float32 k/v scales; dtype is q's and out's.
int kg_paged_decode_attention_int8(int dtype, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* lengths,
                                   void* out, int b, int h, int hd, int page,
                                   int table_width, float sm_scale,
                                   void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(b, h, hd, page)) return (int)cudaErrorInvalidValue;
  return (int)by_width(hd, [&](auto w) {
    using W = decltype(w);
    if (dtype == 0)
      return launch<float, int8_t, W::hd, W::padded>(
          q, k_pool, v_pool, ks, vs, tbl, len, out, b, h, hd, page,
          table_width, sm_scale, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, int8_t, W::hd, W::padded>(
          q, k_pool, v_pool, ks, vs, tbl, len, out, b, h, hd, page,
          table_width, sm_scale, s);
    return cudaErrorInvalidValue;
  });
}

// K2: q and out (b, rows, h, hd), rows >= 1; otherwise as above.
int kg_paged_chunk_attention(int dtype, const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* lengths, void* out, int b, int rows,
                             int h, int hd, int page, int table_width,
                             float sm_scale, void* stream) {
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(b, h, hd, page) || rows < 1)
    return (int)cudaErrorInvalidValue;
  return (int)by_width(hd, [&](auto w) {
    using W = decltype(w);
    if (dtype == 0)
      return launch_chunk<float, float, W::hd, W::padded>(
          q, k_pool, v_pool, nullptr, nullptr, tbl, len, out, b, rows, h, hd,
          page, table_width, sm_scale, s);
    if (dtype == 1)
      return launch_chunk<__nv_bfloat16, __nv_bfloat16, W::hd, W::padded>(
          q, k_pool, v_pool, nullptr, nullptr, tbl, len, out, b, rows, h, hd,
          page, table_width, sm_scale, s);
    return cudaErrorInvalidValue;
  });
}

// K2q: K2 over int8 pools with (P, h) float32 k/v scales.
int kg_paged_chunk_attention_int8(int dtype, const void* q,
                                  const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* table, const void* lengths,
                                  void* out, int b, int rows, int h, int hd,
                                  int page, int table_width, float sm_scale,
                                  void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(b, h, hd, page) || rows < 1)
    return (int)cudaErrorInvalidValue;
  return (int)by_width(hd, [&](auto w) {
    using W = decltype(w);
    if (dtype == 0)
      return launch_chunk<float, int8_t, W::hd, W::padded>(
          q, k_pool, v_pool, ks, vs, tbl, len, out, b, rows, h, hd, page,
          table_width, sm_scale, s);
    if (dtype == 1)
      return launch_chunk<__nv_bfloat16, int8_t, W::hd, W::padded>(
          q, k_pool, v_pool, ks, vs, tbl, len, out, b, rows, h, hd, page,
          table_width, sm_scale, s);
    return cudaErrorInvalidValue;
  });
}

const char* kg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
