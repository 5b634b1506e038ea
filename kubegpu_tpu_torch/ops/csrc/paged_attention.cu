// Paged attention for Hopper (sm_90a) over a KV page pool shared by every
// slot: one query token per slot (K1, the decode step) and a window of L
// query tokens per slot (K2, the speculative verify).
//
// K1 replaces the TPU kernel kubegpu_tpu/ops/paged_attention.py::_paged_kernel
// (called through paged_decode_attention); K2 replaces
// ::_paged_chunk_kernel (called through paged_chunk_attention).  They
// compute what those kernels compute, not their grid: a Pallas kernel walks
// a (slot, page) grid in order on one core and carries the online-softmax
// state in VMEM scratch from one grid step to the next.  Here a slot's page
// table is cut into splits of a fixed number of pages (pages 0 .. S - 1,
// S .. 2S - 1, ...); one thread block folds one split of one (slot, head)
// pair in a loop, keeping the state in registers, and writes the split's
// state (m, l and the undivided accumulator) to a float32 workspace; a
// second kernel merges each row's splits in split order and divides.  K1
// is K2's walk at one row: one code path, so K2's row j is K1 at lengths
// + j bit for bit (below).
//
// Bound: both kernels are bandwidth-bound.  K1 must read each live K/V row
// once, about 2 * sum_b len_b * h * hd * itemsize bytes, over the card's
// 3.35 TB/s; the arithmetic is 4 flops per K/V element, far below the
// card's rate for those bytes.  K2 reads the rows of its widest query row
// (len_b + L - 1) and does 4 * L flops per element, still below the
// card's flops-to-bytes ratio for L <= 8.  The design spends bytes only on
// live pages: a block reads lengths[b], folds only the pages of its split
// below ceil(len / page) (K2: the widest row's len + L - 1), and a split
// past them exits before any load (the GPU form of the TPU kernels'
// dead-page DMA elision); within the last live page it reads only rows
// below the length.  The splits put a long slot's pages on several SMs at
// once, so the card is not left to the few blocks of the longest slots.
//
// The walk.  A block reads each page of its split once for all the rows
// of a walk (up to kMaxRows rows of the window; a wider window takes
// several walks, each a block of its own; K1 walks one row), as the Pallas
// body loads a page once and folds every row from it.  The pages stream
// through a ring of tiles in shared memory filled by cp.async: every
// thread issues all its copies of a tile at once, the ring's stages - 1
// tiles ahead of the fold, so a page costs a few tile waits, not a trip to
// memory per row group.  Copies are 16 bytes a thread with neighbouring
// threads on neighbouring addresses: a group of HD * sizeof(T) / 16
// threads copies one whole row, and the block kRowGroups consecutive rows.
// The launch plans (ops/paged_attention.py: split_plan gives the pages of
// a split and K1's ring; chunk_plan K2's rows per walk and ring) fit a
// walk's scores and the ring into shared memory.
//
// Bit equality.  Row j of a walk folds the pages of each split with the
// same operations, in the same order, as a one-row walk at length len + j
// (fold_page_rows), and its split's state is written in the same order;
// the merge reads row j's live splits from len + j, so K1 at len + j and
// K2's row j merge the same parts.  The split plan depends on the page
// geometry only, never on b, L, the table's width or the lengths, so a
// slot's output does not depend on its batch either.
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
// Pages.  A page's scores sit in shared memory, one f32 per page row and
// row of the walk, so the page max comes first, as in the Pallas body; any
// page whose scores (beside the smallest ring) fit the card's opt-in
// shared memory is taken.  A page is never cut between splits.
//
// Layouts (as in the JAX package): q and out (b, rows, h, hd) (K1: rows =
// 1, i.e. q (b, h, hd)); pools (P, h, page, hd); table (b, table_width)
// int32; lengths (b,) int32 (K2: rows attendable by query row 0, row j
// sees lengths + j); out in q's dtype.  The workspace is (b, rows, h,
// n_splits, hd + 2) float32: each split's accumulator, then m, then l.
// Scores, softmax state and the accumulator are float32.
//
// K1q and K2q replace the same two Pallas bodies' quant=True branch: the
// pools hold int8 and two (P, h) float32 arrays hold one scale per page per
// head.  They are the same kernels instantiated with an int8 pool type TP:
// each copy brings 16 (padded: 8) int8 values of a row, which are cast to
// f32 and multiplied by the page's per-head scale (loaded once per page)
// before the dot with q or the weighting by p -- the Pallas order; the
// scale is never folded into q or the score.  q (bf16 or f32) is read to
// the pool's layout, one to four 16-byte loads a lane.  The bound halves
// with the bytes: about 1 byte per live K/V element plus 8 bytes of scales
// per live page and head.  The full-width instantiations (TP == T) never
// read the scale pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

template <int VEC>
__device__ __forceinline__ void init_state(FoldState<VEC>& st) {
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) st.acc[i] = 0.f;
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

// Query rows one walk folds, at most: their online-softmax states sit in
// registers.  The launch plan's rows per walk (chunk_plan in
// ops/paged_attention.py) may be fewer where a page's scores for eight
// rows do not fit beside the ring.
constexpr int kMaxRows = 8;
// Rows of a walk an instantiation takes: kMaxRows, or half that where a lane
// holds 16 columns (a full-width int8 pool): eight rows' states of 16
// columns do not fit the registers and spill.
template <typename L>
constexpr int kWalkRows = L::kVec > 8 ? kMaxRows / 2 : kMaxRows;
// floats of block reductions at the head of shared memory: one per warp
// for each row of a walk
constexpr int kRedFloats = kMaxRows * kWarps;
// the most stages the ring of page tiles may have (the plan's stages lie
// in [2, kMaxStages])
constexpr int kMaxStages = 4;
// the shared memory a block may opt in to on an H100
constexpr size_t kOptinSmemBytes = 232448;
// K1's one-row walk asks ptxas for registers that let this many blocks
// share an SM (65,536 / (128 x 4) = 128 a thread)
constexpr int kDecodeBlocksPerSm = 4;

// Wait until at most n (< kMaxStages - 1) of this thread's copy groups
// are in flight: wait_group takes its count as an immediate.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n == 0)
    hopper::cp_async_wait<0>();
  else if (n == 1)
    hopper::cp_async_wait<1>();
  else
    hopper::cp_async_wait<2>();
}

// The ring through which a split's pages reach the fold: `stages` slots of
// tile_rows rows (HD pool elements apart) in shared memory.  A walk is one
// sequence of tiles: for each live page of the split, its K tiles up to the
// widest row's count, then its V tiles; the page max comes before any exp,
// so the next page's K tiles are in flight while this page's V is folded.
// issue() copies the next tile of the sequence into the next slot, every
// lane issuing all its copies at once (16 bytes a copy, 8 for a padded
// int8 row), and commits them as one group (an empty one past the split's
// end); next() waits for the oldest tile, issues the one stages - 1 tiles
// ahead into the slot the block has just finished with, and returns the
// oldest.  A thread copies exactly the vectors it later reads (row group
// g's rows, lane l's columns); the barrier in next() frees the slot for
// the next copy.  Rows past the widest row's count and pages past the
// split's last are never copied.
template <typename TP, int HD, bool kPadded>
struct PageRing {
  using L = Layout<TP, HD, kPadded>;
  const TP* k_pool;
  const TP* v_pool;
  const int* table;     // the slot's row of the page table
  size_t page_elems;    // elements of one physical page (all heads)
  size_t head_elems;    // offset of this head's block in a page
  TP* slots;
  int row, page, widest, tile_rows, stages;
  // the issue cursor: page, first row of the tile, K or V, the page's
  // physical index and the next page's, read one page early; end: one
  // past the split's last live page
  int p, off, phys, phys_next, end;
  bool v;
  int put, take;  // slot of the next issue, of the next tile to fold

  // Start the sequence at page `first` (< last) and stop before `last`.
  __device__ __forceinline__ void start(int first, int last) {
    p = first;
    end = last;
    off = put = take = 0;
    v = false;
    phys = table[first];
    phys_next = first + 1 < end ? table[first + 1] : 0;
    for (int s = 0; s + 1 < stages; ++s) issue();
  }

  __device__ __forceinline__ void issue() {
    if (p < end) {
      const int lane = threadIdx.x % L::kLanes;
      const int group = threadIdx.x / L::kLanes;
      const int count = min(page, widest - p * page);
      const int rows = min(tile_rows, count - off);
      const TP* src = (v ? v_pool : k_pool) + (size_t)phys * page_elems +
                      head_elems + (size_t)off * row + lane * L::kVec;
      TP* dst = slots + (size_t)put * tile_rows * HD + lane * L::kVec;
      if (L::active(lane, row)) {
        for (int r = group; r < rows; r += L::kRowGroups) {
          const uint32_t d = hopper::smem_u32(dst + r * HD);
          if constexpr (L::kVec * sizeof(TP) == 16)
            hopper::cp_async_16(d, src + (size_t)r * row);
          else
            hopper::cp_async_8(d, src + (size_t)r * row);
        }
      }
      off += tile_rows;
      if (off >= count) {
        off = 0;
        if (v) {
          ++p;
          phys = phys_next;
          if (p + 1 < end) phys_next = table[p + 1];
        }
        v = !v;
      }
    }
    hopper::cp_async_commit();
    put = put + 1 == stages ? 0 : put + 1;
  }

  __device__ __forceinline__ const TP* next() {
    cp_async_wait_upto(stages - 2);
    __syncthreads();
    issue();
    const TP* tile = slots + (size_t)take * tile_rows * HD;
    take = take + 1 == stages ? 0 : take + 1;
    return tile;
  }
};

// The xor trees of M rows at once.  v holds this lane's value of every
// row; lanes O, O / 2, ..., 1 apart combine them with op.  Where a one-row
// walk runs one shfl_xor tree (log2 of the lane count shuffles), lanes
// here trade halves of their rows: at each level a lane keeps half, sends
// the other half to its partner and combines what it gets, until it holds
// one row (then the levels left are a plain tree).  Every value a lane
// holds is the one the row's own tree holds there -- op(own, partner's),
// the two operands of the one-row tree in either order, and op commutes --
// so each row ends with its tree's bits.  Called with N == M; on return
// v[0 .. N') hold rows base .. base + N' - 1, N' the rows left (M / the
// lanes, at least 1); base starts at 0.
template <int N, int O, int M, typename Op>
__device__ __forceinline__ void butterfly(float (&v)[M], int lane, int& base,
                                          Op op) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      if (upper) base += N / 2;
      butterfly<N / 2, O / 2>(v, lane, base, op);
    } else {
      v[0] = op(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      butterfly<1, O / 2>(v, lane, base, op);
    }
  }
}

struct AddRn {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// Each of R rows' value of a block reduction: the warp's tree (as
// butterfly), red[j * kWarps + warp], a barrier, then red over warps 0..3
// in order -- the same order for every R, so a row's value does not depend
// on the rows beside it.  The caller puts a barrier between two uses of
// red.
template <int R, typename Op>
__device__ __forceinline__ void block_rows(float (&v)[R], float* red, Op op) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  butterfly<R, 16>(v, lane, base, op);
  // 32 / R lanes hold each row after the splits; the first writes
  if ((lane & (32 / R - 1)) == 0) red[base * kWarps + (threadIdx.x >> 5)] = v[0];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    v[j] = red[j * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v[j] = op(v[j], red[j * kWarps + w]);
  }
}

// Fold one live page into the states of the R rows of a walk (R a power of
// two, n <= R of them real), reading each K and V row of the page once for
// all of them, in the order of the Pallas kernel: page max, shift, p =
// exp(s - shift), correction, l, acc.  Row j reaches the page rows below
// rel0 + j (rel0: row 0's limit less the page's first column); a row with
// rel0 + j <= 0 does not reach the page and keeps its state.  n_max (>= 1)
// is the widest row's count in the page.  Row j's arithmetic is that of a
// one-row walk (R = 1, K1) at count min(page, rel0 + j): the same
// intrinsics in the same order on the same values (its q.k chain and
// shfl_xor tree, then block_rows' max and sum orders, one set of barriers
// shared by the rows, then its p.v multiply-adds in row order, each
// thread's rows group, group + kRowGroups, ... whatever the tile size), so
// K2's row j is K1 at lengths + j bit for bit.  The multiply-adds are
// spelled as explicit round-to-nearest intrinsics, which the compiler
// never contracts or reorders.  The rows' chains run side by side without
// branches around them: a score past a row's count, or of a row past the
// walk's n (which stands in with row n - 1's q and scores), is computed
// with the others and never read; an idle lane's q and K read in-bounds
// columns and multiply zeros.  The weighting by V covers the rows below
// every real row's count with no test, and tests each row only past row
// 0's count (the window's last few rows).  The page's K then V tiles come
// from the ring; q rows are read through L1 from q (row j at q_rows + j *
// q_stride).  s_smem holds n rows of page floats, row j at j * page; red
// holds kRedFloats.
template <typename T, typename TP, int HD, bool kPadded, int R>
__device__ __forceinline__ void fold_page_rows(
    PageRing<TP, HD, kPadded>& ring, float k_scale, float v_scale,
    int n_max, int rel0, int n, int hd, int page,
    const T* __restrict__ q_rows, size_t q_stride, float sm_scale,
    float* s_smem, float* red, FoldState<Layout<TP, HD, kPadded>::kVec> (&st)[R]) {
  using L = Layout<TP, HD, kPadded>;
  // rows a lane holds after the score butterfly, and lanes holding each
  constexpr int kHeld = R > L::kLanes ? R / L::kLanes : 1;
  constexpr int kSharers = L::kLanes > R ? L::kLanes / R : 1;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;
  const int tile_rows = ring.tile_rows;
  const bool active = L::active(lane, hd);
  const int col = active ? lane * L::kVec : 0;
  // each row's count in this page (0 past the walk's rows), and where its
  // scores sit (row n - 1's past the walk's rows)
  int count[R], at[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    count[j] = j < n ? max(0, min(page, rel0 + j)) : 0;
    at[j] = (j < n ? j : n - 1) * page;
  }

  // scores: each K row is loaded once and dotted with every row
  for (int off = 0; off < n_max; off += tile_rows) {
    const TP* tile = ring.next();
    const int end = min(tile_rows, n_max - off);
    for (int r0 = 0; r0 < end; r0 += L::kRowGroups) {
      const int r = r0 + group;
      const bool live = r < end && active;
      float kf[L::kVec];
      load_pool(tile + min(r, end - 1) * HD + col, k_scale, kf);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i) kf[i] = live ? kf[i] : 0.f;
      float part[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float qf[L::kVec];
        load_floats(q_rows + (j < n ? j : n - 1) * q_stride + col, qf);
        part[j] = 0.f;
#pragma unroll
        for (int i = 0; i < L::kVec; ++i)
          part[j] = __fmaf_rn(qf[i], kf[i], part[j]);
      }
      int base = 0;
      butterfly<R, L::kLanes / 2>(part, lane, base, AddRn{});
      // a row past n holds row n - 1's very score: writing it there is a
      // no-op
      if (lane % kSharers == 0 && r < end) {
#pragma unroll
        for (int k = 0; k < kHeld; ++k)
          s_smem[min(base + k, n - 1) * page + off + r] =
              __fmul_rn(part[k], sm_scale);
      }
    }
  }
  __syncthreads();
  // each row's page max
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = -INFINITY;
  for (int r = threadIdx.x; r < n_max; r += kThreads) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float s = s_smem[at[j] + r];
      v[j] = r < count[j] ? fmaxf(v[j], s) : v[j];
    }
  }
  block_rows(v, red, Max{});
  float shift[R], correction[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float m_new = fmaxf(st[j].m, v[j]);
    shift[j] = isfinite(m_new) ? m_new : 0.f;
    // the Pallas guard, with no branch around the exp
    const float e = expf(__fsub_rn(st[j].m, shift[j]));
    correction[j] = isfinite(st[j].m) ? e : 0.f;
    if (count[j] > 0) st[j].m = m_new;
  }
  __syncthreads();  // red is rewritten below
  // p = exp(s - shift) in place, and each row's sum (past a row's count,
  // adding +0 to a sum that is >= +0 changes nothing)
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = 0.f;
  for (int r = threadIdx.x; r < n_max; r += kThreads) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float p = expf(__fsub_rn(s_smem[at[j] + r], shift[j]));
      const bool in = r < count[j];
      if (in) s_smem[at[j] + r] = p;
      v[j] = __fadd_rn(v[j], in ? p : 0.f);
    }
  }
  // block_rows's barrier also publishes the p values written above
  block_rows(v, red, AddRn{});
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (count[j] > 0) {
      st[j].l = __fmaf_rn(correction[j], st[j].l, v[j]);
#pragma unroll
      for (int i = 0; i < L::kVec; ++i)
        st[j].acc[i] = __fmul_rn(st[j].acc[i], correction[j]);
    }
  }
  // weighting by V: each V row is loaded once and added into every row
  // that reaches it.  Rows below count[0] reach every real row; a row past
  // n adds into a state that is never written.
  const int all_rows = count[0];
  for (int off = 0; off < n_max; off += tile_rows) {
    const TP* tile = ring.next();
    const int end = min(tile_rows, n_max - off);
    if (active) {
      int r = group;
      for (; r < end && off + r < all_rows; r += L::kRowGroups) {
        float vf[L::kVec];
        load_pool(tile + r * HD + lane * L::kVec, v_scale, vf);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float p = s_smem[at[j] + off + r];
#pragma unroll
          for (int i = 0; i < L::kVec; ++i)
            st[j].acc[i] = __fmaf_rn(p, vf[i], st[j].acc[i]);
        }
      }
      for (; r < end; r += L::kRowGroups) {
        float vf[L::kVec];
        load_pool(tile + r * HD + lane * L::kVec, v_scale, vf);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (off + r < count[j]) {
            const float p = s_smem[at[j] + off + r];
#pragma unroll
            for (int i = 0; i < L::kVec; ++i)
              st[j].acc[i] = __fmaf_rn(p, vf[i], st[j].acc[i]);
          }
        }
      }
    }
  }
  // the next page's first tile (or write_part) passes a barrier before
  // s_smem and red are rewritten
}

// The floats of a walk's scores: rows_per_walk pages, at least
// write_part's row sums, rounded up to 16 bytes (the ring follows them).
template <typename TP, int HD, bool kPadded>
__host__ __device__ __forceinline__ size_t score_floats(int page,
                                                        int rows_per_walk) {
  using L = Layout<TP, HD, kPadded>;
  size_t n = (size_t)rows_per_walk * page;
  if (n < (size_t)L::kRowGroups * HD) n = L::kRowGroups * HD;
  return n + (4 - n % 4) % 4;
}

// Write one row's split state to its workspace record `part` (hd + 2
// floats): the row groups' partial accumulators added up in group order,
// undivided, then m, then l.  accs holds kRowGroups * HD floats of shared
// memory; the leading barrier lets a walk write several rows through one
// buffer.
template <typename TP, int HD, bool kPadded>
__device__ __forceinline__ void write_part(
    const FoldState<Layout<TP, HD, kPadded>::kVec>& st, int hd, float* accs,
    float* __restrict__ part) {
  using L = Layout<TP, HD, kPadded>;
  const int lane = threadIdx.x % L::kLanes;
  const int group = threadIdx.x / L::kLanes;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kVec; ++i)
    accs[group * HD + lane * L::kVec + i] = st.acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < L::kRowGroups; ++g) a = __fadd_rn(a, accs[g * HD + d]);
    part[d] = a;
  }
  if (threadIdx.x == 0) {
    part[hd] = st.m;
    part[hd + 1] = st.l;
  }
}

// One walk of one split: the n rows j0 .. j0 + n - 1 (n <= R) stream the
// split's pages [first, last) -- those below their widest row's limit,
// len + j0 + n - 1 -- once through the ring, fold them all
// (fold_page_rows) and write their split states.  Row j sees the pages,
// row counts and fold K1 would see at length len + j.
template <typename T, typename TP, int HD, bool kPadded, int R>
__device__ __forceinline__ void walk_rows(
    PageRing<TP, HD, kPadded>& ring, const T* __restrict__ q,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    float* __restrict__ parts, int b, int h, int j0, int n, int len,
    int rows, int heads, int hd, int page, int first, int last, int split,
    int n_splits, float sm_scale, float* s_smem, float* red) {
  using L = Layout<TP, HD, kPadded>;
  const int row = L::row(hd);
  FoldState<L::kVec> st[R];
#pragma unroll
  for (int j = 0; j < R; ++j) init_state(st[j]);
  const T* q_rows = q + (((size_t)b * rows + j0) * heads + h) * row;
  ring.start(first, last);
  for (int p = first; p < last; ++p) {
    float ks, vs;
    page_scales<TP>(k_scales, v_scales, (size_t)ring.table[p] * heads + h,
                    ks, vs);
    fold_page_rows<T, TP, HD, kPadded, R>(
        ring, ks, vs, min(page, ring.widest - p * page), len + j0 - p * page,
        n, hd, page, q_rows, (size_t)heads * row, sm_scale, s_smem, red, st);
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < n)
      write_part<TP, HD, kPadded>(
          st[j], hd, s_smem,
          parts + ((((size_t)b * rows + j0 + j) * heads + h) * n_splits +
                   split) * (hd + 2));
}

// The block of grid (h, b, walks x n_splits) at blockIdx: (slot, head,
// walk, split), z = walk * n_splits + split.  The window's rows are walked
// in groups of rows_per_walk, each group by blocks of its own (see
// walk_rows), one block per split of pages_per_split pages; a split with
// no live page of its walk exits before any load.  A walk of n rows runs
// the instantiation for the least power of two >= n (at most kRows), so
// the rows it folds and reduces side by side are n or fewer than twice n.
template <typename T, typename TP, int HD, bool kPadded, int kRows>
__device__ __forceinline__ void walk_block(
    const T* __restrict__ q, const TP* __restrict__ k_pool,
    const TP* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ parts, int rows,
    int heads, int hd, int page, int table_width, int rows_per_walk,
    int tile_rows, int stages, int pages_per_split, int n_splits,
    float sm_scale) {
  using L = Layout<TP, HD, kPadded>;
  extern __shared__ float smem[];
  float* red = smem;                   // kRedFloats
  float* s_smem = smem + kRedFloats;   // a walk's scores, then the row sums
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z % n_splits;
  const int j0 = blockIdx.z / n_splits * rows_per_walk;
  const int n = min(rows_per_walk, rows - j0);
  const int len = lengths[b];
  // pages past the table's width are never visited, as on the TPU grid
  const int widest = len + j0 + n - 1;
  const int n_live = widest > 0
      ? min((widest + page - 1) / page, table_width) : 0;
  const int first = split * pages_per_split;
  if (first >= n_live) return;
  const int last = min(first + pages_per_split, n_live);
  const int row = L::row(hd);

  PageRing<TP, HD, kPadded> ring;
  ring.k_pool = k_pool;
  ring.v_pool = v_pool;
  ring.table = table + (size_t)b * table_width;
  ring.page_elems = (size_t)heads * page * row;
  ring.head_elems = (size_t)h * page * row;
  ring.slots = reinterpret_cast<TP*>(
      s_smem + score_floats<TP, HD, kPadded>(page, rows_per_walk));
  ring.row = row;
  ring.page = page;
  ring.widest = widest;
  ring.tile_rows = tile_rows;
  ring.stages = stages;

#define KG_WALK(R)                                                          \
  walk_rows<T, TP, HD, kPadded, R>(ring, q, k_scales, v_scales, parts, b,   \
                                   h, j0, n, len, rows, heads, hd, page,    \
                                   first, last, split, n_splits, sm_scale,  \
                                   s_smem, red)
  if constexpr (kRows >= 8) {
    if (n > 4) { KG_WALK(8); return; }
  }
  if constexpr (kRows >= 4) {
    if (n > 2) { KG_WALK(4); return; }
  }
  if constexpr (kRows >= 2) {
    if (n > 1) { KG_WALK(2); return; }
  }
  KG_WALK(1);
#undef KG_WALK
}

// K2's walk: windows of any rows, up to kWalkRows a walk.  Launch bounds
// of one block an SM let ptxas give a thread up to 255 registers: under
// its default occupancy target the float32 instantiations were held to
// 168 and spilled.
template <typename T, typename TP, int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, 1) paged_chunk_walk_kernel(
    const T* __restrict__ q, const TP* __restrict__ k_pool,
    const TP* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ parts, int rows,
    int heads, int hd, int page, int table_width, int rows_per_walk,
    int tile_rows, int stages, int pages_per_split, int n_splits,
    float sm_scale) {
  constexpr int kRows = kWalkRows<Layout<TP, HD, kPadded> >;
  walk_block<T, TP, HD, kPadded, kRows>(
      q, k_pool, v_pool, k_scales, v_scales, table, lengths, parts, rows,
      heads, hd, page, table_width, rows_per_walk, tile_rows, stages,
      pages_per_split, n_splits, sm_scale);
}

// K1's walk (and any walk of one row): only the one-row instantiation, so
// its few registers let kDecodeBlocksPerSm blocks share an SM.
template <typename T, typename TP, int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, kDecodeBlocksPerSm)
    paged_decode_walk_kernel(
        const T* __restrict__ q, const TP* __restrict__ k_pool,
        const TP* __restrict__ v_pool, const float* __restrict__ k_scales,
        const float* __restrict__ v_scales, const int* __restrict__ table,
        const int* __restrict__ lengths, float* __restrict__ parts, int rows,
        int heads, int hd, int page, int table_width, int rows_per_walk,
        int tile_rows, int stages, int pages_per_split, int n_splits,
        float sm_scale) {
  walk_block<T, TP, HD, kPadded, 1>(
      q, k_pool, v_pool, k_scales, v_scales, table, lengths, parts, rows,
      heads, hd, page, table_width, rows_per_walk, tile_rows, stages,
      pages_per_split, n_splits, sm_scale);
}

// The merge: one warp per (slot, row, head), item (b * rows + j) * heads +
// h, kWarps a block.  Row j's live splits are those holding its live pages
// (ceil(min(ceil((len + j) / page), table_width) / pages_per_split)), read
// from lengths here, so K1 at len + j and K2's row j merge the same parts.
// They merge in split order: m = max m_s, c_s = exp(m_s - m), l = sum c_s
// l_s, acc = sum c_s acc_s, out = acc / (l == 0 ? 1 : l) in q's type.  A
// split that folded nothing (l_s == 0, m_s = -inf) is skipped, never added
// as +0; a row with no live split writes zeros.  A row whose live pages lie
// in one split has c = exp(0) = 1: its output is that split's fold
// divided once, as an unsplit walk would give.  The warp's work is a few
// trips to memory, not one a split: lane t holds part s0 + t's m, l and
// c (for 32 parts at a time; the max is exact in any order), and columns
// t, t + 32, ... of the accumulators, whose loads go out kMergeBatch parts
// at a time -- the first batch before the max is known, since it needs
// only the count of parts -- and are added in split order.
constexpr int kMergeBatch = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ parts, const int* __restrict__ lengths,
    T* __restrict__ out, int b, int rows, int heads, int hd, int page,
    int table_width, int pages_per_split, int n_splits) {
  constexpr int kCols = kMaxHeadDim / 32;
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= b * rows * heads) return;
  const int lane = threadIdx.x & 31;
  const int limit = lengths[item / (rows * heads)] + item / heads % rows;
  const int n_live = limit > 0
      ? min((limit + page - 1) / page, table_width) : 0;
  const int n_parts = (n_live + pages_per_split - 1) / pages_per_split;
  const int stride = hd + 2;
  const float* part = parts + (size_t)item * n_splits * stride;
  float a[kMergeBatch][kCols];
  auto load_batch = [&](int s0) {
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        a[u][k] = s0 + u < n_parts && lane + 32 * k < hd
            ? part[(size_t)(s0 + u) * stride + lane + 32 * k] : 0.f;
  };
  load_batch(0);
  float m = -INFINITY;
  for (int s0 = 0; s0 < n_parts; s0 += 32) {
    const int s = s0 + lane;
    const float l_s = s < n_parts ? part[(size_t)s * stride + hd + 1] : 0.f;
    if (l_s != 0.f) m = fmaxf(m, part[(size_t)s * stride + hd]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  for (int s0 = 0; s0 < n_parts; s0 += 32) {
    const int s = s0 + lane;
    const float l_s = s < n_parts ? part[(size_t)s * stride + hd + 1] : 0.f;
    const float c_s =
        l_s != 0.f ? expf(__fsub_rn(part[(size_t)s * stride + hd], m)) : 0.f;
    for (int u0 = 0; u0 < 32 && s0 + u0 < n_parts; u0 += kMergeBatch) {
      if (s0 + u0 > 0) load_batch(s0 + u0);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float lu = __shfl_sync(0xffffffffu, l_s, u0 + u);
        const float cu = __shfl_sync(0xffffffffu, c_s, u0 + u);
        if (lu == 0.f) continue;  // past n_parts too: l_s is 0 there
        l = __fmaf_rn(cu, lu, l);
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = __fmaf_rn(cu, a[u][k], acc[k]);
      }
    }
  }
  const float denom = l == 0.f ? 1.f : l;
  T* o = out + (size_t)item * hd;
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (lane + 32 * k < hd) store(o + lane + 32 * k, __fdiv_rn(acc[k], denom));
}

// A walk's shared memory under a launch plan (ops/paged_attention.py::
// chunk_plan and split_plan compute the same): the reductions, a walk's
// scores and the ring's tiles.
template <typename TP, int HD, bool kPadded>
size_t walk_smem_bytes(int page, int rows_per_walk, int tile_rows,
                       int stages) {
  return (kRedFloats + score_floats<TP, HD, kPadded>(page, rows_per_walk)) *
             sizeof(float) +
         (size_t)stages * tile_rows * HD * sizeof(TP);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The walk, then the merge, on `stream`.  A window of one row (K1) or a
// plan of one row a walk runs the one-row kernel.
template <typename T, typename TP, int HD, bool kPadded>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, float* parts, void* out, int b,
                   int rows, int h, int hd, int page, int table_width,
                   int rows_per_walk, int tile_rows, int stages,
                   int pages_per_split, float sm_scale, cudaStream_t stream) {
  using L = Layout<TP, HD, kPadded>;
  // a plan this instantiation cannot run is refused, never adjusted
  if (rows_per_walk < 1 || rows_per_walk > kWalkRows<L> || tile_rows < 1 ||
      tile_rows % L::kRowGroups != 0 || stages < 2 || stages > kMaxStages ||
      pages_per_split < 1 || table_width < 0)
    return cudaErrorInvalidValue;
  const size_t smem = walk_smem_bytes<TP, HD, kPadded>(
      page, rows_per_walk, tile_rows, stages);
  if (smem > kOptinSmemBytes) return cudaErrorInvalidValue;
  const long walks = (rows + rows_per_walk - 1) / rows_per_walk;
  const long n_splits = table_width > 0
      ? (table_width + pages_per_split - 1) / pages_per_split : 1;
  if (walks * n_splits > 65535) return cudaErrorInvalidValue;
  auto kernel = rows == 1 || rows_per_walk == 1
      ? paged_decode_walk_kernel<T, TP, HD, kPadded>
      : paged_chunk_walk_kernel<T, TP, HD, kPadded>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(h, b, walks * n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, table, lengths, parts, rows, h, hd,
      page, table_width, rows_per_walk, tile_rows, stages, pages_per_split,
      (int)n_splits, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long blocks = ((long)b * rows * h + kWarps - 1) / kWarps;
  paged_merge_kernel<T><<<blocks, kThreads, 0, stream>>>(
      parts, lengths, static_cast<T*>(out), b, rows, h, hd, page,
      table_width, pages_per_split, (int)n_splits);
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

// One (q dtype T, pool TP) pair's walk and merge at head width hd.
template <typename T, typename TP>
cudaError_t launch_pair(const void* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* table,
                        const int* lengths, float* parts, void* out, int b,
                        int rows, int h, int hd, int page, int table_width,
                        int rows_per_walk, int tile_rows, int stages,
                        int pages_per_split, float sm_scale,
                        cudaStream_t stream) {
  return by_width(hd, [&](auto w) {
    using W = decltype(w);
    return launch<T, TP, W::hd, W::padded>(
        q, kp, vp, ks, vs, table, lengths, parts, out, b, rows, h, hd, page,
        table_width, rows_per_walk, tile_rows, stages, pages_per_split,
        sm_scale, stream);
  });
}

}  // namespace

// The library builds in four parts, one nvcc each, started together
// (ops/_build.py): part KG_PART = p instantiates the kernels of one (q
// dtype, pool) pair, p = dtype + 2 * quant, behind kg_paged_pair_<p>, and
// part 0 also holds the entry points.  Without KG_PART one translation
// unit holds all four.
#define KG_PAIR_PARAMS                                                       \
  const void *q, const void *kp, const void *vp, const float *ks,           \
      const float *vs, const int *table, const int *lengths, float *parts,   \
      void *out, int b, int rows, int h, int hd, int page, int table_width,  \
      int rows_per_walk, int tile_rows, int stages, int pages_per_split,     \
      float sm_scale, cudaStream_t stream
#define KG_PAIR(P, T, TP)                                                    \
  int kg_paged_pair_##P(KG_PAIR_PARAMS) {                                    \
    return (int)launch_pair<T, TP>(                                          \
        q, kp, vp, ks, vs, table, lengths, parts, out, b, rows, h, hd, page, \
        table_width, rows_per_walk, tile_rows, stages, pages_per_split,      \
        sm_scale, stream);                                                   \
  }

extern "C" {

int kg_paged_pair_0(KG_PAIR_PARAMS);
int kg_paged_pair_1(KG_PAIR_PARAMS);
int kg_paged_pair_2(KG_PAIR_PARAMS);
int kg_paged_pair_3(KG_PAIR_PARAMS);

#if !defined(KG_PART) || KG_PART == 0
KG_PAIR(0, float, float)
#endif
#if !defined(KG_PART) || KG_PART == 1
KG_PAIR(1, __nv_bfloat16, __nv_bfloat16)
#endif
#if !defined(KG_PART) || KG_PART == 2
KG_PAIR(2, float, int8_t)
#endif
#if !defined(KG_PART) || KG_PART == 3
KG_PAIR(3, __nv_bfloat16, int8_t)
#endif

#if !defined(KG_PART) || KG_PART == 0
static bool bad_geometry(int b, int rows, int h, int hd, int page) {
  return b <= 0 || h <= 0 || h > 65535 || b > 65535 || page <= 0 ||
         rows < 1 || hd < 8 || hd > kMaxHeadDim || hd % 8 != 0;
}

// K1, K1q, K2 and K2q: q and out (b, rows, h, hd), rows >= 1 (K1: 1);
// dtype is q's and out's (0 float32, 1 bfloat16); quant 0 reads pools of
// q's dtype (k_scale and v_scale unused), 1 int8 pools with (P, h) float32
// scales; hd a multiple of 8 up to 128.  parts is the (b, rows, h,
// ceil(table_width / pages_per_split), hd + 2) float32 workspace.
// rows_per_walk, tile_rows, stages and pages_per_split are the launch plan
// (ops/paged_attention.py::chunk_plan / split_plan), refused with
// cudaErrorInvalidValue if this instantiation cannot run it.  Returns the
// launches' cudaError_t (0 on success); both kernels run on `stream`.
int kg_paged_attention(int dtype, int quant, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* lengths, void* parts,
                       void* out, int b, int rows, int h, int hd, int page,
                       int table_width, int rows_per_walk, int tile_rows,
                       int stages, int pages_per_split, float sm_scale,
                       void* stream) {
  static int (*const pairs[4])(KG_PAIR_PARAMS) = {
      kg_paged_pair_0, kg_paged_pair_1, kg_paged_pair_2, kg_paged_pair_3};
  if (bad_geometry(b, rows, h, hd, page) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return pairs[dtype + 2 * (quant != 0)](
      q, k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(parts), out, b,
      rows, h, hd, page, table_width, rows_per_walk, tile_rows, stages,
      pages_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}

const char* kg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

}  // extern "C"
