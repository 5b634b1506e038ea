// Flash attention for Hopper (sm_90a): the forward (K3) and the two
// backward kernels (K4: dK and dV; K5: dQ) of a causal or non-causal
// attention over BSHD tensors.
//
// K3 replaces the TPU kernel kubegpu_tpu/ops/attention.py::_flash_kernel
// (called through _flash_forward), K4 ::_flash_bwd_dkdv_kernel and K5
// ::_flash_bwd_dq_kernel (both called through _flash_backward).  They
// compute what those kernels compute, not their grid: a Pallas kernel walks
// a (b*h, tile, tile) grid in order on one core and carries its running
// state or gradient sum in VMEM scratch from one grid step to the next;
// here one thread block owns one (b*h, tile) pair and loops over the other
// side's tiles, carrying the state in registers.
//
//   K3: a block per (b*h, q tile) folds every K/V tile its rows reach into
//       an f32 online softmax (running max m, denominator l, accumulator)
//       and writes out = acc / l (0 for a row with l == 0) and the row's
//       lse = m + log l (-inf for such a row).
//   K4: a block per (b*h, k tile) walks every q tile that reaches it,
//       recomputes p = exp(s - lse) and ds = p * (dO . v - delta) * scale
//       with delta = rowsum(dO * O) taken from the resident dO tile and the
//       stored out, and sums dV += p^T . dO and dK += ds^T . q.
//   K5: a block per (b*h, q tile) walks every K/V tile it reaches with the
//       same p and ds and sums dQ += ds . k.
//
// Each gradient is owned by one block and written once, so the backward
// needs no atomics and is deterministic.  Causal tiles wholly above the
// diagonal are skipped, as the Pallas kernels skip their blocks.
//
// Bound: at the training path's shapes (b 16, s 1024, h 32, d 128, causal)
// each kernel's work is its matrix products: K3 does 2 (q.k, p.v), K4 4
// and K5 3, halved by the causal mask — 137 to 275 GFLOP against 0.5 to
// 0.9 GB of operands.  In bf16 that puts them near the line where the
// card's tensor cores (989 TFLOP/s) and its memory (3.35 TB/s) bound
// alike.
//
// K3, K4 and K5 in float32 are the first design: they compute in f32 on
// the CUDA cores, as the Pallas bodies compute in f32.
// Their limit is the f32 FMA rate (67 TFLOP/s) and the shared-memory
// traffic of their inner products: tiles of 64 rows are staged in shared
// memory as f32 (rows padded to 129 floats, so sixteen threads reading
// one column of sixteen rows hit sixteen banks), and each of 256 threads
// holds a 4 x 4 block of a 64 x 64 score tile and a 4 x 8 block of a
// 64 x d accumulator, which reuses every shared-memory value it reads four
// or eight times.
//
// K3, K4 and K5 in bf16 (the training path's type) run their products on
// the tensor cores with wgmma (hopper.cuh), f32 accumulation.  A block has
// two warpgroups of 64 rows each.  One warp of the first also feeds a ring
// of three stages by TMA, with a full and an empty mbarrier per stage, two
// stages ahead of its own use, so loads overlap products and the two
// warpgroups run apart rather than in lock step:
//
//   K3: a block per (b*h, 128 q rows); q stays, K and V stream in tiles of
//       128 rows; S = q.K^T (64 x 128 a warpgroup) from shared memory,
//       then an online softmax in registers in base 2 (scores times
//       scale * log2 e, exp2 on the special-function unit, the Pallas
//       guards for -inf), l summed from the unrounded p, the accumulator
//       rescaled by the correction, and O += P.V with P rounded to bf16
//       as the register A operand and V read MN-major.  out = O / l and
//       lse = (m + log2 l) ln 2.  Causal blocks run a head's heaviest q
//       tiles first.
//   K4: a block per (b*h, 128 K/V rows); K and V stay in shared memory,
//       and q, dO, lse and delta stream through in tiles of 64 rows.  Per
//       tile a warpgroup takes S^T = K.q^T and dP^T = V.dO^T (both
//       operands from shared memory), forms P^T and dS^T in registers,
//       rounds them to bf16 and feeds them as the register A operand of
//       dV += P^T.dO and dK += dS^T.q (B from shared memory, read
//       MN-major).  Taking S^T, not S, puts P^T and dS^T in A's layout as
//       they come out of the first products.
//   K5: a block per (b*h, 128 q rows); q and dO stay, K and V stream in
//       tiles of 64 rows; S = q.K^T, dP = dO.V^T, then dQ += dS.K with dS
//       from registers.
//
// Rounding p (and, backward, ds) to bf16 before their products is the one
// departure from the f32 algebra; the reference on its TPU (an f32 dot at
// JAX's default precision is one bf16 pass) rounds them too.  delta =
// rowsum(dO * O) comes precomputed from flash_backward_delta_kernel, once
// per backward.  A row whose lse is -inf, and a padding row, gets the
// shift +inf, so exp2 gives its p = 0 with no separate test; only tiles
// that cross the diagonal or the last K/V row pay for the mask.
//
// Layouts: q, out, dout, dq (b, sq, h, d); k, v, dk, dv (b, sk, h, d), all
// contiguous, float32 or bfloat16 alike; lse and delta (b, h, sq) float32;
// d a multiple of 8 up to 128 (the bf16 kernels pad it to 64 or 128 with
// zeros in shared memory).  Causal attention has sq == sk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of a q tile and of a K/V tile
constexpr int kMaxD = 128;
constexpr int kSub = 16;                // threads along a tile's columns
constexpr int kPer = kTile / kSub;      // score rows / cols a thread owns
constexpr int kDPer = kMaxD / kSub;     // head columns a thread owns
constexpr int kStride = kMaxD + 1;      // floats per staged row (padded)
constexpr int kPStride = kTile + 1;     // floats per row of a p / ds tile
constexpr int kTileFloats = kTile * kStride;
constexpr int kScoreFloats = kTile * kPStride;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a JAX cast
}

// Thread t owns score rows ty + kSub * i and score columns tx + kSub * j.
__device__ __forceinline__ int tx() { return threadIdx.x % kSub; }
__device__ __forceinline__ int ty() { return threadIdx.x / kSub; }

// The sixteen threads of one score row are one half of a warp.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + kTile) of one head (d values each, row_stride
// elements apart) as f32; rows at or past n_rows read as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int row0,
                                          int n_rows, size_t row_stride, int d,
                                          float* __restrict__ tile) {
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int row = row0 + r;
    tile[r * kStride + c] =
        row < n_rows ? to_f32(base[(size_t)row * row_stride + c]) : 0.f;
  }
}

// s[i][j] = sum_c a[row i][c] * b[row j][c] over this thread's 4 x 4 block
// of a 64 x 64 tile of inner products (q.k^T or dO.v^T).
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int d,
                                         float (&s)[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
  const float* ar = a + ty() * kStride;
  const float* br = b + tx() * kStride;
  for (int c = 0; c < d; ++c) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = ar[i * kSub * kStride + c];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = br[j * kSub * kStride + c];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][jj] += sum_c a(row i, c) * b[c][col jj] over the 64 rows c of a
// staged tile b, for this thread's rows ty + kSub * i and head columns
// tx + kSub * jj.  a(r, c) = a[r * a_row + c * a_col], so one routine does
// p.v and ds.k (a_row = kPStride, a_col = 1) and p^T.dO and ds^T.q
// (a_row = 1, a_col = kPStride).
__device__ __forceinline__ void tile_accumulate(const float* __restrict__ a,
                                                int a_row, int a_col,
                                                const float* __restrict__ b,
                                                int d,
                                                float (&acc)[kPer][kDPer]) {
  const float* ar = a + ty() * a_row;
  for (int c = 0; c < kTile; ++c) {
    float av[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = ar[i * kSub * a_row + c * a_col];
    const float* brow = b + c * kStride + tx();
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      if (tx() + kSub * jj < d) {
        const float bv = brow[kSub * jj];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][jj] = fmaf(av[i], bv, acc[i][jj]);
      }
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) x[i][j] = 0.f;
}

// Write this thread's block of a (kTile x d) result (rows at or past
// n_rows are padding and are not written).
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[kPer][kDPer],
                                           T* __restrict__ base, int row0,
                                           int n_rows, size_t row_stride,
                                           int d) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = row0 + ty() + kSub * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int col = tx() + kSub * jj;
      if (col < d) store(base + (size_t)row * row_stride + col, acc[i][jj]);
    }
  }
}

// The per-tile backward algebra shared by K4 and K5 (the Pallas
// _bwd_block): scores from the staged q and k tiles, dp from dO and v,
// p = exp(s - lse) where the pair is valid and lse finite (else 0),
// ds = p * (dp - delta) * scale; p and ds land in shared memory as
// [q row][k col] tiles (p only when p_out is given).
__device__ __forceinline__ void backward_tile(
    const float* qs, const float* ks, const float* dos, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int seq_q,
    int seq_k, int d, float sm_scale, int causal, float* p_out,
    float* ds_out) {
  float s[kPer][kPer], dp[kPer][kPer];
  tile_dot(qs, ks, d, s);
  tile_dot(dos, vs, d, dp);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty() + kSub * i;
    const int row = q0 + r;
    const float lse_r = lse_s[r];
    const bool finite = isfinite(lse_r);
    const float shift = finite ? lse_r : 0.f;
    const float delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx() + kSub * j;
      const int col = k0 + c;
      const bool valid = row < seq_q && col < seq_k && finite &&
                         (!causal || col <= row);
      const float p = valid ? expf(s[i][j] * sm_scale - shift) : 0.f;
      const float ds = p * (dp[i][j] - delta) * sm_scale;
      if (p_out != nullptr) p_out[r * kPStride + c] = p;
      ds_out[r * kPStride + c] = ds;
    }
  }
}

// Stage a q tile's lse and delta = rowsum(dO * O): dO from its staged
// tile, O (the forward's stored output) read once from device memory, one
// warp per row.  Padding rows get lse -inf and delta 0.
template <typename T>
__device__ __forceinline__ void stage_row_stats(
    const float* __restrict__ lse_bh, const T* __restrict__ ob,
    const float* __restrict__ dos, int q0, int seq_q, size_t row_stride,
    int d, float* __restrict__ lse_s, float* __restrict__ delta_s) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float part = 0.f;
    if (row < seq_q)
      for (int c = lane; c < d; c += 32)
        part = fmaf(dos[r * kStride + c],
                    to_f32(ob[(size_t)row * row_stride + c]), part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < seq_q ? lse_bh[row] : -INFINITY;
    }
  }
}

// Offsets of head h of batch b in a BSHD tensor of seq rows.
__device__ __forceinline__ size_t head_base(int b, int h, int seq, int heads,
                                            int d) {
  return ((size_t)b * seq * heads + h) * d;
}

// Every kernel runs a 1-D grid of b*h x tiles blocks, one head's tiles
// consecutive (neighbouring blocks share that head's K/V in L2): b*h rides
// gridDim.x, which has no 65535 limit.  Returns this block's b*h index and
// sets its tile.
__device__ __forceinline__ int block_head(int tiles, int* tile) {
  const int bh = blockIdx.x / tiles;
  *tile = blockIdx.x - bh * tiles;
  return bh;
}

// grid (b*h x q tiles).  K3 in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_forward_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int heads, int seq_q,
    int seq_k, int d, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  int qt;
  const int bh = block_head((seq_q + kTile - 1) / kTile, &qt);
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = qt * kTile;
  const size_t row_stride = (size_t)heads * d;
  const size_t qoff = head_base(b, h, seq_q, heads, d);
  const size_t koff = head_base(b, h, seq_k, heads, d);

  load_tile(q + qoff, q0, seq_q, row_stride, d, qs);
  float m[kPer], l[kPer], acc[kPer][kDPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);

  int n_kt = (seq_k + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's k, v and p are read
    load_tile(k + koff, k0, seq_k, row_stride, d, ks);
    load_tile(v + koff, k0, seq_k, row_stride, d, vs);
    __syncthreads();
    float s[kPer][kPer];
    tile_dot(qs, ks, d, s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty() + kSub * i;
      const int row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = k0 + tx() + kSub * j;
        const bool valid = col < seq_k && (!causal || col <= row);
        s[i][j] = valid ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // m_new is -inf only on a row with nothing valid yet: a zero shift
      // keeps exp(-inf - shift) at 0 instead of nan
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float correction = isfinite(m[i]) ? expf(m[i] - shift) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - shift);
        ps[r * kPStride + tx() + kSub * j] = p;
        psum += p;
      }
      l[i] = correction * l[i] + row_sum(psum);
#pragma unroll
      for (int jj = 0; jj < kDPer; ++jj) acc[i][jj] *= correction;
      m[i] = m_new;
    }
    __syncthreads();  // p is complete
    tile_accumulate(ps, kPStride, 1, vs, d, acc);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    // a row that attended nothing (l == 0) writes out 0 and lse -inf
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) acc[i][jj] = acc[i][jj] / denom;
    const int row = q0 + ty() + kSub * i;
    if (tx() == 0 && row < seq_q)
      lse[(size_t)bh * seq_q + row] =
          l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) + logf(denom) : -INFINITY;
  }
  store_rows(acc, out + qoff, q0, seq_q, row_stride, d);
}

// grid (b*h x k tiles).  K4 in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_backward_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv,
    int heads, int seq_q, int seq_k, int d, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;
  float* dss = ps + kScoreFloats;
  float* lse_s = dss + kScoreFloats;
  float* delta_s = lse_s + kTile;
  int kt;
  const int bh = block_head((seq_k + kTile - 1) / kTile, &kt);
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kt * kTile;
  const size_t row_stride = (size_t)heads * d;
  const size_t qoff = head_base(b, h, seq_q, heads, d);
  const size_t koff = head_base(b, h, seq_k, heads, d);

  load_tile(k + koff, k0, seq_k, row_stride, d, ks);
  load_tile(v + koff, k0, seq_k, row_stride, d, vs);
  float dk_acc[kPer][kDPer], dv_acc[kPer][kDPer];
  zero(dk_acc);
  zero(dv_acc);

  const int nq = (seq_q + kTile - 1) / kTile;
  // causal: a q tile reaches these columns once its last row does
  for (int qt = causal ? k0 / kTile : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's q, dO, p and ds are read
    load_tile(q + qoff, q0, seq_q, row_stride, d, qs);
    load_tile(dout + qoff, q0, seq_q, row_stride, d, dos);
    __syncthreads();
    stage_row_stats(lse + (size_t)bh * seq_q, out + qoff, dos, q0, seq_q,
                    row_stride, d, lse_s, delta_s);
    __syncthreads();
    backward_tile(qs, ks, dos, vs, lse_s, delta_s, q0, k0, seq_q, seq_k, d,
                  sm_scale, causal, ps, dss);
    __syncthreads();
    tile_accumulate(ps, 1, kPStride, dos, d, dv_acc);   // p^T . dO
    tile_accumulate(dss, 1, kPStride, qs, d, dk_acc);   // ds^T . q
  }
  store_rows(dk_acc, dk + koff, k0, seq_k, row_stride, d);
  store_rows(dv_acc, dv + koff, k0, seq_k, row_stride, d);
}

// grid (b*h x q tiles).  K5 in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_backward_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, T* __restrict__ dq, int heads, int seq_q,
    int seq_k, int d, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  float* lse_s = dss + kScoreFloats;
  float* delta_s = lse_s + kTile;
  int qt;
  const int bh = block_head((seq_q + kTile - 1) / kTile, &qt);
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = qt * kTile;
  const size_t row_stride = (size_t)heads * d;
  const size_t qoff = head_base(b, h, seq_q, heads, d);
  const size_t koff = head_base(b, h, seq_k, heads, d);

  load_tile(q + qoff, q0, seq_q, row_stride, d, qs);
  load_tile(dout + qoff, q0, seq_q, row_stride, d, dos);
  __syncthreads();
  stage_row_stats(lse + (size_t)bh * seq_q, out + qoff, dos, q0, seq_q,
                  row_stride, d, lse_s, delta_s);
  float dq_acc[kPer][kDPer];
  zero(dq_acc);

  int n_kt = (seq_k + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's k, v and ds are read; stats staged
    load_tile(k + koff, k0, seq_k, row_stride, d, ks);
    load_tile(v + koff, k0, seq_k, row_stride, d, vs);
    __syncthreads();
    backward_tile(qs, ks, dos, vs, lse_s, delta_s, q0, k0, seq_q, seq_k, d,
                  sm_scale, causal, nullptr, dss);
    __syncthreads();
    tile_accumulate(dss, kPStride, 1, ks, d, dq_acc);   // ds . k
  }
  store_rows(dq_acc, dq + qoff, q0, seq_q, row_stride, d);
}

// ---- delta = rowsum(dO * O), once per bf16 backward ----

// One (b, row, h) vector of d bf16 values per warp, 16 bytes per lane
// per load; delta lands as (b, h, seq).  grid (ceil(vectors / 8)).
__global__ void __launch_bounds__(kThreads) flash_backward_delta_kernel(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
    int heads, int seq, int d, int vectors) {
  const int vec = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (vec >= vectors) return;
  const int lane = threadIdx.x % 32;
  constexpr int kPer = 8;
  const __nv_bfloat16* o = out + (size_t)vec * d;
  const __nv_bfloat16* g = dout + (size_t)vec * d;
  float part = 0.f;
  for (int c = lane * kPer; c < d; c += 32 * kPer) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      part = fmaf(to_f32(ge[j]), to_f32(oe[j]), part);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, s);
  if (lane == 0) {
    const int bs = vec / heads;  // b * seq + row
    const int h = vec - bs * heads;
    const int b = bs / seq;
    delta[((size_t)b * heads + h) * seq + (bs - b * seq)] = part;
  }
}

// ---- K4 and K5 in bf16 on the tensor cores ----
//
// Two warpgroups per block, each owning 64 rows.  The first warp also
// keeps a ring of kStages stages filled by TMA, kStages - 1 fills ahead
// of its own use.  Each stage has a "full" mbarrier (its copies landed)
// and an "empty" one (all 256 threads are done with it), so loads overlap
// the products and the two warpgroups run apart, not in lock step.

constexpr int kWgThreads = 2 * 128;      // two warpgroups
constexpr int kWgRows = 64;              // rows a warpgroup owns (wgmma's m)
constexpr int kBlockRows = 2 * kWgRows;  // K4's K/V tile, K5's q tile
constexpr int kStreamRows = 64;          // K4's q tile, K5's K/V tile
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of K4 (byte offsets from a 1024-aligned base): the
// resident K and V tiles; kStages stages of q, dO, lse and delta; the
// barriers (K/V landed, then full and empty per stage).
template <int kD>
struct DkdvSmem {
  static constexpr int kKv = kBlockRows * kD * 2;
  static constexpr int kQ = kStreamRows * kD * 2;
  static constexpr int k = 0, v = kKv, q = 2 * kKv, dout = q + kStages * kQ,
                       lse = dout + kStages * kQ,
                       delta = lse + kStages * kStreamRows * 4,
                       bar = delta + kStages * kStreamRows * 4,
                       bytes = bar + (1 + 2 * kStages) * 8 + 1024;
};

// Shared memory of K5: the resident q and dO tiles, kStages stages of K
// and V, the barriers.
template <int kD>
struct DqSmem {
  static constexpr int kQ = kBlockRows * kD * 2;
  static constexpr int kKv = kStreamRows * kD * 2;
  static constexpr int q = 0, dout = kQ, k = 2 * kQ, v = k + kStages * kKv,
                       bar = v + kStages * kKv,
                       bytes = bar + (1 + 2 * kStages) * 8 + 1024;
};

// K3's K/V tile: a warpgroup's score tile is 64 x 128, half the softmax
// reductions and ring waits per product of 64 x 64 tiles
// (kubegpu_tpu_torch/k3_variants.py times both).
constexpr int kFwdKvRows = 128;

// Shared memory of the bf16 K3: the resident q tile, kStages stages of K
// and V, the barriers.
template <int kD>
struct FwdSmem {
  static constexpr int kQ = kBlockRows * kD * 2;
  static constexpr int kKv = kFwdKvRows * kD * 2;
  static constexpr int q = 0, k = kQ, v = k + kStages * kKv,
                       bar = v + kStages * kKv,
                       bytes = bar + (1 + 2 * kStages) * 8 + 1024;
};

// The 1024-aligned base of a kernel's dynamic shared memory (the wgmma
// swizzle repeats every 1024 bytes), as a shared address and a pointer.
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw,
                                                 unsigned char** ptr) {
  const uint32_t at = hopper::smem_u32(raw);
  const uint32_t base = (at + 1023u) & ~1023u;
  *ptr = raw + (base - at);
  return base;
}

// The ring's barriers at `bar`: [0] the resident tiles landed, [1 + s]
// stage s full, [1 + kStages + s] stage s empty.  Thread 0 sets them up;
// `full_arrivals` counts the filling warp's arrivals per fill.
__device__ __forceinline__ void init_ring(uint32_t bar, int full_arrivals) {
  using namespace hopper;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (1 + s), full_arrivals);
      mbar_init(bar + 8 * (1 + kStages + s), kWgThreads);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The i-th fill of the ring uses stage i % kStages for the (i /
// kStages)-th time; a fill's barriers complete the phase of that parity.
__device__ __forceinline__ uint32_t full_bar(uint32_t bar, int i) {
  return bar + 8 * (1 + i % kStages);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bar, int i) {
  return bar + 8 * (1 + kStages + i % kStages);
}
__device__ __forceinline__ uint32_t use_parity(int i) {
  return (i / kStages) & 1;
}

// A tile of `rows` rows of one (b, h) from a BSHD map into the swizzled
// slabs at dst, kD / 64 boxes of 64 columns.
template <int kD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int rows, int h,
                                         int row0, int b) {
#pragma unroll
  for (int j = 0; j < kD / 64; ++j)
    hopper::tma_load_4d(dst + j * rows * 128, &map, bar, 64 * j, h, row0, b);
}

// The shift of a row's exp2: its lse in base 2, or +inf (p = 0) where the
// lse is -inf or the row is padding.
__device__ __forceinline__ float exp2_shift(float lse, bool row_valid) {
  return row_valid && isfinite(lse) ? lse * kLog2e : INFINITY;
}

// Write a warpgroup's 64 x kD f32 accumulator as bf16 rows; row0 is this
// thread's first accumulator row (the second is row0 + 8).  Rows at or
// past n_rows and columns at or past d are padding.
template <int kD>
__device__ __forceinline__ void store_acc(const float (&acc)[kD / 2],
                                          __nv_bfloat16* __restrict__ base,
                                          int row0, int n_rows,
                                          size_t row_stride, int d) {
  const int n0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = row0 + 8 * a;
      const int col = 8 * i + n0;
      if (row < n_rows && col < d)
        *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row * row_stride +
                                           col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * a], acc[4 * i + 2 * a + 1]);
    }
}

// Accumulator element e of a 64 x 64 tile sits in row half (e / 2) % 2
// and column 8 (e / 4) + e % 2 of this thread's (plus 2 (lane % 4)).
__device__ __forceinline__ constexpr int half_of(int e) { return (e / 2) % 2; }
__device__ __forceinline__ constexpr int col_of(int e) {
  return 8 * (e / 4) + e % 2;
}

// sc (scores before the scale) becomes p = exp2(sc * scale * log2 e -
// shift), 0 where masked.  The caller's functors give a row's shift and
// whether a (row half, column) pair is valid.
template <typename Shift, typename Valid>
__device__ __forceinline__ void probs(float (&sc)[32], float sm_scale,
                                      bool masked, Shift shift, Valid valid) {
  const float scale_log2 = sm_scale * kLog2e;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    float p = hopper::exp2_ftz(
        fmaf(sc[e], scale_log2, -shift(half_of(e), col_of(e))));
    if (masked && !valid(half_of(e), col_of(e))) p = 0.f;
    sc[e] = p;
  }
}

// dp becomes ds = p * (dp - delta) * scale.
template <typename Delta>
__device__ __forceinline__ void grads(const float (&p)[32], float (&dp)[32],
                                      float sm_scale, Delta delta) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    dp[e] = p[e] * (dp[e] - delta(half_of(e), col_of(e))) * sm_scale;
}

// grid (b*h x ceil(seq_k / 128)).  K4, bf16.
template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_backward_dkdv_wgmma_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap dout_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int heads, int seq_q, int seq_k, int d, float sm_scale, int causal) {
  using namespace hopper;
  using L = DkdvSmem<kD>;
  extern __shared__ unsigned char dkdv_smem[];
  unsigned char* sm;
  const uint32_t base = aligned_base(dkdv_smem, &sm);
  const uint32_t bar = base + L::bar;
  int kt;
  const int bh = block_head((seq_k + kBlockRows - 1) / kBlockRows, &kt);
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kt * kBlockRows;
  // causal: a q tile reaches this block's rows once its last row does
  const int qt0 = causal ? k0 / kStreamRows : 0;
  const int fills = (seq_q + kStreamRows - 1) / kStreamRows - qt0;
  const int lane = threadIdx.x % 32;
  // q and dO by TMA (one arrival with their bytes); lse and delta by
  // cp.async from the 32 lanes of the filling warp (32 arrivals)
  init_ring(bar, 1 + 32);

  // K and V, once; then fill i of the ring: q tile qt0 + i
  auto load_resident = [&]() {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, 2 * L::kKv);
      tma_tile<kD>(base + L::k, k_map, bar, kBlockRows, h, k0, b);
      tma_tile<kD>(base + L::v, v_map, bar, kBlockRows, h, k0, b);
    }
  };
  auto fill = [&](int i) {
    const int s = i % kStages;
    const int q0 = (qt0 + i) * kStreamRows;
    mbar_wait(empty_bar(bar, i), use_parity(i) ^ 1);
    const uint32_t full = full_bar(bar, i);
    if (lane == 0) {
      mbar_arrive_expect_tx(full, 2 * L::kQ);
      tma_tile<kD>(base + L::q + s * L::kQ, q_map, full, kStreamRows, h, q0,
                   b);
      tma_tile<kD>(base + L::dout + s * L::kQ, dout_map, full, kStreamRows,
                   h, q0, b);
    }
#pragma unroll
    for (int j = 0; j < kStreamRows / 32; ++j) {
      const int r = lane + 32 * j;
      const bool valid = q0 + r < seq_q;
      const size_t row = (size_t)bh * seq_q + (valid ? q0 + r : 0);
      const uint32_t at = (s * kStreamRows + r) * 4;
      cp_async_4(base + L::lse + at, lse + row, valid);
      cp_async_4(base + L::delta + at, delta + row, valid);
    }
    cp_async_mbar_arrive(full);
  };

  const bool filler = threadIdx.x < 32;
  if (filler) {
    load_resident();
    for (int i = 0; i < min(kStages - 1, fills); ++i) fill(i);
  }
  // this warpgroup owns K/V rows kv0 .. kv0 + 63
  const int wg = threadIdx.x / 128;
  const int m0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int n0 = 2 * (lane % 4);
  const int kv0 = k0 + wg * kWgRows;
  const int kr = kv0 + m0;  // this thread's rows: kr, kr + 8
  const uint32_t kb = base + L::k + wg * kWgRows * 128;
  const uint32_t vb = base + L::v + wg * kWgRows * 128;
  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(bar, 0);

  for (int i = 0; i < fills; ++i) {
    if (filler && i + kStages - 1 < fills) fill(i + kStages - 1);
    const int s = i % kStages;
    const int q0 = (qt0 + i) * kStreamRows;
    mbar_wait(full_bar(bar, i), use_parity(i));
    // causal: a tile wholly above this warpgroup's rows adds nothing
    if (!causal || q0 + kStreamRows - 1 >= kv0) {
      const uint32_t qb = base + L::q + s * L::kQ;
      const uint32_t ob = base + L::dout + s * L::kQ;
      // S^T = K.q^T, then dP^T = V.dO^T, over the head dim
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(
            st,
            desc_k_major(kb + (kk / 4) * (kBlockRows * 128) + (kk % 4) * 32),
            desc_k_major(qb + (kk / 4) * (kStreamRows * 128) + (kk % 4) * 32),
            kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(
            dpt,
            desc_k_major(vb + (kk / 4) * (kBlockRows * 128) + (kk % 4) * 32),
            desc_k_major(ob + (kk / 4) * (kStreamRows * 128) + (kk % 4) * 32),
            kk);
      wgmma_commit();
      // rows are K/V rows kr + 8a, columns q rows qc + c
      const float* lse_s =
          reinterpret_cast<const float*>(sm + L::lse) + s * kStreamRows + n0;
      const float* delta_s = reinterpret_cast<const float*>(sm + L::delta) +
                             s * kStreamRows + n0;
      const int qc = q0 + n0;
      wgmma_wait<1>();  // S^T is done; P^T while dP^T runs
      fence_operands(st);
      probs(st, sm_scale,
            (causal && q0 < kv0 + kWgRows - 1) || kv0 + kWgRows > seq_k,
            [&](int, int c) { return exp2_shift(lse_s[c], qc + c < seq_q); },
            [&](int a, int c) {
              return kr + 8 * a < seq_k && (!causal || kr + 8 * a <= qc + c);
            });
      wgmma_wait<0>();
      fence_operands(dpt);
      grads(st, dpt, sm_scale, [&](int, int c) { return delta_s[c]; });
      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pf[j] = pack_bf16(st[2 * j], st[2 * j + 1]);
        dsf[j] = pack_bf16(dpt[2 * j], dpt[2 * j + 1]);
      }
      // dV += P^T.dO and dK += dS^T.q over the tile's q rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStreamRows / 16; ++kk) {
        wgmma_rs<kD>(dv_acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                     pf[4 * kk + 3],
                     desc_mn_major(ob + kk * 2048, kStreamRows * 128));
        wgmma_rs<kD>(dk_acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2],
                     dsf[4 * kk + 3],
                     desc_mn_major(qb + kk * 2048, kStreamRows * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
    }
    mbar_arrive(empty_bar(bar, i));
  }
  const size_t koff = head_base(b, h, seq_k, heads, d);
  store_acc<kD>(dk_acc, dk + koff, kr, seq_k, (size_t)heads * d, d);
  store_acc<kD>(dv_acc, dv + koff, kr, seq_k, (size_t)heads * d, d);
}

// grid (b*h x ceil(seq_q / 128)).  K5, bf16.
template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_backward_dq_wgmma_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap dout_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int heads, int seq_q, int seq_k,
        int d, float sm_scale, int causal) {
  using namespace hopper;
  using L = DqSmem<kD>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* sm;  // unused: K5 reads shared memory only through wgmma
  const uint32_t base = aligned_base(dq_smem, &sm);
  const uint32_t bar = base + L::bar;
  int qt;
  const int bh = block_head((seq_q + kBlockRows - 1) / kBlockRows, &qt);
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = qt * kBlockRows;
  int fills = (seq_k + kStreamRows - 1) / kStreamRows;
  if (causal) fills = min(fills, (q0 + kBlockRows - 1) / kStreamRows + 1);
  init_ring(bar, 1);

  // q and dO, once; then fill i of the ring: K/V tile i (one thread)
  auto load_resident = [&]() {
    mbar_arrive_expect_tx(bar, 2 * L::kQ);
    tma_tile<kD>(base + L::q, q_map, bar, kBlockRows, h, q0, b);
    tma_tile<kD>(base + L::dout, dout_map, bar, kBlockRows, h, q0, b);
  };
  auto fill = [&](int i) {
    const int s = i % kStages;
    mbar_wait(empty_bar(bar, i), use_parity(i) ^ 1);
    const uint32_t full = full_bar(bar, i);
    mbar_arrive_expect_tx(full, 2 * L::kKv);
    tma_tile<kD>(base + L::k + s * L::kKv, k_map, full, kStreamRows, h,
                 i * kStreamRows, b);
    tma_tile<kD>(base + L::v + s * L::kKv, v_map, full, kStreamRows, h,
                 i * kStreamRows, b);
  };

  const bool filler = threadIdx.x == 0;
  if (filler) {
    load_resident();
    for (int i = 0; i < min(kStages - 1, fills); ++i) fill(i);
  }
  // this warpgroup owns q rows qw0 .. qw0 + 63
  const int wg = threadIdx.x / 128;
  const int m0 = 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int n0 = 2 * (threadIdx.x % 4);
  const int qw0 = q0 + wg * kWgRows;
  const int qr = qw0 + m0;  // this thread's rows: qr, qr + 8
  float shift[2], dl[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = qr + 8 * a;
    const bool valid = row < seq_q;
    shift[a] =
        exp2_shift(valid ? lse[(size_t)bh * seq_q + row] : 0.f, valid);
    dl[a] = valid ? delta[(size_t)bh * seq_q + row] : 0.f;
  }
  const uint32_t qb = base + L::q + wg * kWgRows * 128;
  const uint32_t ob = base + L::dout + wg * kWgRows * 128;
  float dq_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(bar, 0);

  for (int i = 0; i < fills; ++i) {
    if (filler && i + kStages - 1 < fills) fill(i + kStages - 1);
    const int s = i % kStages;
    const int k0 = i * kStreamRows;
    mbar_wait(full_bar(bar, i), use_parity(i));
    // causal: a tile wholly right of this warpgroup's rows adds nothing
    if (!causal || k0 <= qw0 + kWgRows - 1) {
      const uint32_t kb = base + L::k + s * L::kKv;
      const uint32_t vb = base + L::v + s * L::kKv;
      // S = q.K^T, then dP = dO.V^T, over the head dim
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(
            sc,
            desc_k_major(qb + (kk / 4) * (kBlockRows * 128) + (kk % 4) * 32),
            desc_k_major(kb + (kk / 4) * (kStreamRows * 128) + (kk % 4) * 32),
            kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(
            dp,
            desc_k_major(ob + (kk / 4) * (kBlockRows * 128) + (kk % 4) * 32),
            desc_k_major(vb + (kk / 4) * (kStreamRows * 128) + (kk % 4) * 32),
            kk);
      wgmma_commit();
      // rows are q rows qr + 8a, columns K/V rows kc + c
      const int kc = k0 + n0;
      wgmma_wait<1>();  // S is done; P while dP runs
      fence_operands(sc);
      probs(sc, sm_scale,
            (causal && k0 + kStreamRows - 1 > qw0) ||
                k0 + kStreamRows > seq_k,
            [&](int a, int) { return shift[a]; },
            [&](int a, int c) {
              return kc + c < seq_k && (!causal || kc + c <= qr + 8 * a);
            });
      wgmma_wait<0>();
      fence_operands(dp);
      grads(sc, dp, sm_scale, [&](int a, int) { return dl[a]; });
      uint32_t dsf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dsf[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
      // dQ += dS.K over the tile's K/V rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStreamRows / 16; ++kk)
        wgmma_rs<kD>(dq_acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2],
                     dsf[4 * kk + 3],
                     desc_mn_major(kb + kk * 2048, kStreamRows * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
    }
    mbar_arrive(empty_bar(bar, i));
  }
  store_acc<kD>(dq_acc, dq + head_base(b, h, seq_q, heads, d), qr, seq_q,
                (size_t)heads * d, d);
}

// grid (b*h x ceil(seq_q / 128)).  K3, bf16: q stays, K and V stream in
// tiles of kFwdKvRows rows; S = q.K^T from shared memory, an online
// softmax in registers (base 2), then O += P.V with P rounded to bf16 as
// the register A operand and V read MN-major.
template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_forward_wgmma_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads,
        int seq_q, int seq_k, int d, float sm_scale, int causal) {
  using namespace hopper;
  using L = FwdSmem<kD>;
  constexpr int kN = kFwdKvRows;  // a tile's K/V rows: S is 64 x kN
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* sm;  // unused: K3 reads shared memory only through wgmma
  const uint32_t base = aligned_base(fwd_smem, &sm);
  const uint32_t bar = base + L::bar;
  const int n_qt = (seq_q + kBlockRows - 1) / kBlockRows;
  int qt;
  const int bh = block_head(n_qt, &qt);
  // causal: a head's last q tiles reach the most K/V tiles; launching
  // them first leaves light blocks for the grid's tail
  if (causal) qt = n_qt - 1 - qt;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = qt * kBlockRows;
  int fills = (seq_k + kN - 1) / kN;
  if (causal) fills = min(fills, (q0 + kBlockRows - 1) / kN + 1);
  init_ring(bar, 1);

  // q, once; then fill i of the ring: K/V tile i (one thread)
  auto fill = [&](int i) {
    const int s = i % kStages;
    mbar_wait(empty_bar(bar, i), use_parity(i) ^ 1);
    const uint32_t full = full_bar(bar, i);
    mbar_arrive_expect_tx(full, 2 * L::kKv);
    tma_tile<kD>(base + L::k + s * L::kKv, k_map, full, kN, h, i * kN, b);
    tma_tile<kD>(base + L::v + s * L::kKv, v_map, full, kN, h, i * kN, b);
  };
  const bool filler = threadIdx.x == 0;
  if (filler) {
    mbar_arrive_expect_tx(bar, L::kQ);
    tma_tile<kD>(base + L::q, q_map, bar, kBlockRows, h, q0, b);
    for (int i = 0; i < min(kStages - 1, fills); ++i) fill(i);
  }
  // this warpgroup owns q rows qw0 .. qw0 + 63
  const int wg = threadIdx.x / 128;
  const int m0 = 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int n0 = 2 * (threadIdx.x % 4);
  const int qw0 = q0 + wg * kWgRows;
  const int qr = qw0 + m0;  // this thread's rows: qr, qr + 8
  const uint32_t qb = base + L::q + wg * kWgRows * 128;
  const float scale_log2 = sm_scale * kLog2e;
  // the running max (base 2, of the scaled scores) and denominator of
  // rows qr and qr + 8, and their accumulator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  // causal: the tiles right of this warpgroup's rows add nothing; it
  // passes them through the ring unread
  const int n_wg = causal ? min(fills, (qw0 + kWgRows - 1) / kN + 1) : fills;

  // issue S = q.K^T of tile i (one commit group)
  auto scores = [&](int i, float (&sc)[kN / 2]) {
    const uint32_t kb = base + L::k + (i % kStages) * L::kKv;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n128k16_ss(
          sc, desc_k_major(qb + (kk / 4) * (kBlockRows * 128) + (kk % 4) * 32),
          desc_k_major(kb + (kk / 4) * (kN * 128) + (kk % 4) * 32), kk);
    wgmma_commit();
  };
  // issue O += P.V of tile i (one commit group)
  auto weigh = [&](int i, const uint32_t (&pf)[kN / 4]) {
    const uint32_t vb = base + L::v + (i % kStages) * L::kKv;
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<kD>(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                   pf[4 * kk + 3], desc_mn_major(vb + kk * 2048, kN * 128));
    wgmma_commit();
  };
  // tile i's scores (sc, before the scale) become P, rounded to bf16 pairs
  // in the A operand's layout; m and l move on, and corr is the factor
  // the accumulator takes before this tile's P.V
  auto softmax = [&](int i, float (&sc)[kN / 2], uint32_t (&pf)[kN / 4],
                     float (&corr)[2]) {
    const int k0 = i * kN;
    // only tiles that cross the diagonal or the last K row pay for the
    // mask (-inf: p = 0)
    const bool masked = (causal && k0 + kN - 1 > qw0) || k0 + kN > seq_k;
    const int kc = k0 + n0;  // columns are K/V rows kc + c
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const int a = half_of(e), c = col_of(e);
      if (masked && !(kc + c < seq_k && (!causal || kc + c <= qr + 8 * a)))
        sc[e] = -INFINITY;
      mx[a] = fmaxf(mx[a], sc[e]);
    }
    // a row's kN columns lie in the four lanes of a quad; its max is
    // taken before the scale (> 0), and m is in base 2 of the scaled
    // scores
    float shift[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 1));
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 2));
      const float m_new = fmaxf(m[a], mx[a] * scale_log2);
      // the Pallas guards: m_new is -inf only on a row with nothing valid
      // yet, where a zero shift keeps exp2(-inf - shift) at 0, and a -inf
      // running max contributes nothing
      shift[a] = m_new == -INFINITY ? 0.f : m_new;
      corr[a] = m[a] == -INFINITY ? 0.f : exp2_ftz(m[a] - shift[a]);
      m[a] = m_new;
    }
    // p = 2^(s * scale * log2 e - shift) in one multiply-add, and l summed
    // from the unrounded p
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const float p = exp2_ftz(fmaf(sc[e], scale_log2, -shift[half_of(e)]));
      sc[e] = p;
      rs[half_of(e)] += p;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], 1);
      rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], 2);
      l[a] = fmaf(corr[a], l[a], rs[a]);
    }
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  };

  mbar_wait(bar, 0);
  for (int i = 0; i < fills; ++i) {
    if (filler && i + kStages - 1 < fills) fill(i + kStages - 1);
    mbar_wait(full_bar(bar, i), use_parity(i));
    if (i < n_wg) {
      float sc[kN / 2], corr[2];
      uint32_t pf[kN / 4];
      scores(i, sc);
      wgmma_wait<0>();
      fence_operands(sc);
      softmax(i, sc, pf, corr);
#pragma unroll
      for (int e = 0; e < kD / 2; ++e) o[e] *= corr[half_of(e)];
      weigh(i, pf);
      wgmma_wait<0>();
      fence_operands(o);
    }
    mbar_arrive(empty_bar(bar, i));
  }
  // out = O / l (0 where l == 0); lse = (m + log2 l) ln 2 (-inf there),
  // written by the quad's first lane
  float denom[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    denom[a] = l[a] == 0.f ? 1.f : l[a];
    const int row = qr + 8 * a;
    if (n0 == 0 && row < seq_q)
      lse[(size_t)bh * seq_q + row] =
          l[a] > 0.f ? ((m[a] == -INFINITY ? 0.f : m[a]) + log2f(denom[a])) *
                           kLn2
                     : -INFINITY;
  }
#pragma unroll
  for (int e = 0; e < kD / 2; ++e) o[e] = o[e] / denom[half_of(e)];
  store_acc<kD>(o, out + head_base(b, h, seq_q, heads, d), qr, seq_q,
                (size_t)heads * d, d);
}

constexpr size_t kForwardSmem = (3 * kTileFloats + kScoreFloats) * sizeof(float);
constexpr size_t kDkdvSmem =
    (4 * kTileFloats + 2 * kScoreFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem =
    (4 * kTileFloats + kScoreFloats + 2 * kTile) * sizeof(float);

// Opt a kernel in to more than 48 KB of dynamic shared memory.  Each
// launcher does it once (a function-local static), on its first call, so
// a launch captured into a CUDA graph makes no such call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The grids' b*h x tiles blocks (tiles of kTile rows, the finest any
// kernel takes) must fit gridDim.x.
bool bad_shape(int b, int h, int seq_q, int seq_k, int d) {
  const long long tiles =
      ((long long)(seq_q > seq_k ? seq_q : seq_k) + kTile - 1) / kTile;
  return b <= 0 || h <= 0 || seq_q <= 0 || seq_k <= 0 || d <= 0 ||
         d > kMaxD || d % 8 != 0 || (long long)b * h * tiles > INT_MAX;
}

// The float32 K3: the first design.
template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v, void* out,
                    float* lse, int b, int h, int seq_q, int seq_k, int d,
                    float sm_scale, int causal, cudaStream_t stream) {
  auto kernel = flash_forward_kernel<T>;
  static const cudaError_t smem_ok = allow_smem(kernel, kForwardSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<b * h * ((seq_q + kTile - 1) / kTile), kThreads, kForwardSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(out), lse, h,
                     seq_q, seq_k, d, sm_scale, causal);
  return cudaGetLastError();
}

// The float32 K4 and K5: the first design (delta taken from out per tile).
template <typename T>
cudaError_t backward_dkdv(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const float* lse,
                          void* dk, void* dv, int b, int h, int seq_q,
                          int seq_k, int d, float sm_scale, int causal,
                          cudaStream_t stream) {
  auto kernel = flash_backward_dkdv_kernel<T>;
  static const cudaError_t smem_ok = allow_smem(kernel, kDkdvSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<b * h * ((seq_k + kTile - 1) / kTile), kThreads, kDkdvSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(out),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dk),
                     static_cast<T*>(dv), h, seq_q, seq_k, d, sm_scale,
                     causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_dq(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        void* dq, int b, int h, int seq_q, int seq_k, int d,
                        float sm_scale, int causal, cudaStream_t stream) {
  auto kernel = flash_backward_dq_kernel<T>;
  static const cudaError_t smem_ok = allow_smem(kernel, kDqSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<b * h * ((seq_q + kTile - 1) / kTile), kThreads, kDqSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(out),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                     h, seq_q, seq_k, d, sm_scale, causal);
  return cudaGetLastError();
}

// The bf16 K3, K4 and K5 on the tensor cores, the head dim padded to kD.
// TMA maps of q and dout (rows_q-row boxes) and of k and v (rows_kv).
struct BshdMaps {
  CUtensorMap q, dout, k, v;
};

cudaError_t make_maps(BshdMaps* m, const void* q, const void* dout,
                      const void* k, const void* v, int b, int h, int seq_q,
                      int seq_k, int d, int rows_q, int rows_kv) {
  if (hopper::encode_tiled() == nullptr) return cudaErrorNotSupported;
  const bool ok = hopper::bshd_map(&m->q, q, b, seq_q, h, d, rows_q) &&
                  (dout == nullptr ||  // the forward has none
                   hopper::bshd_map(&m->dout, dout, b, seq_q, h, d, rows_q)) &&
                  hopper::bshd_map(&m->k, k, b, seq_k, h, d, rows_kv) &&
                  hopper::bshd_map(&m->v, v, b, seq_k, h, d, rows_kv);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kD>
cudaError_t forward_wgmma(const void* q, const void* k, const void* v,
                          void* out, float* lse, int b, int h, int seq_q,
                          int seq_k, int d, float sm_scale, int causal,
                          cudaStream_t stream) {
  auto kernel = flash_forward_wgmma_kernel<kD>;
  constexpr size_t smem = FwdSmem<kD>::bytes;
  static const cudaError_t smem_ok = allow_smem(kernel, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  BshdMaps m;
  const cudaError_t maps_ok = make_maps(&m, q, nullptr, k, v, b, h, seq_q,
                                        seq_k, d, kBlockRows, kFwdKvRows);
  if (maps_ok != cudaSuccess) return maps_ok;
  kernel<<<b * h * ((seq_q + kBlockRows - 1) / kBlockRows), kWgThreads,
           smem, stream>>>(m.q, m.k, m.v, static_cast<__nv_bfloat16*>(out),
                           lse, h, seq_q, seq_k, d, sm_scale, causal);
  return cudaGetLastError();
}

template <int kD>
cudaError_t backward_dkdv_wgmma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int b,
                                int h, int seq_q, int seq_k, int d,
                                float sm_scale, int causal,
                                cudaStream_t stream) {
  auto kernel = flash_backward_dkdv_wgmma_kernel<kD>;
  constexpr size_t smem = DkdvSmem<kD>::bytes;
  static const cudaError_t smem_ok = allow_smem(kernel, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  BshdMaps m;
  const cudaError_t maps_ok = make_maps(&m, q, dout, k, v, b, h, seq_q, seq_k,
                                        d, kStreamRows, kBlockRows);
  if (maps_ok != cudaSuccess) return maps_ok;
  kernel<<<b * h * ((seq_k + kBlockRows - 1) / kBlockRows), kWgThreads,
           smem, stream>>>(m.q, m.dout, m.k, m.v, lse, delta,
                           static_cast<__nv_bfloat16*>(dk),
                           static_cast<__nv_bfloat16*>(dv), h, seq_q, seq_k,
                           d, sm_scale, causal);
  return cudaGetLastError();
}

template <int kD>
cudaError_t backward_dq_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int b, int h,
                              int seq_q, int seq_k, int d, float sm_scale,
                              int causal, cudaStream_t stream) {
  auto kernel = flash_backward_dq_wgmma_kernel<kD>;
  constexpr size_t smem = DqSmem<kD>::bytes;
  static const cudaError_t smem_ok = allow_smem(kernel, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  BshdMaps m;
  const cudaError_t maps_ok = make_maps(&m, q, dout, k, v, b, h, seq_q, seq_k,
                                        d, kBlockRows, kStreamRows);
  if (maps_ok != cudaSuccess) return maps_ok;
  kernel<<<b * h * ((seq_q + kBlockRows - 1) / kBlockRows), kWgThreads,
           smem, stream>>>(m.q, m.dout, m.k, m.v, lse, delta,
                           static_cast<__nv_bfloat16*>(dq), h, seq_q, seq_k,
                           d, sm_scale, causal);
  return cudaGetLastError();
}

cudaError_t backward_delta(const void* out, const void* dout, float* delta,
                           int b, int h, int seq, int d, cudaStream_t stream) {
  const int vectors = b * seq * h;
  constexpr int kPerBlock = kThreads / 32;
  flash_backward_delta_kernel<<<(vectors + kPerBlock - 1) / kPerBlock,
                                kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), delta, h, seq, d, vectors);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (every tensor but lse and delta, which are
// float32).  Each entry returns the launch's cudaError_t (0 on success);
// the kernel runs on `stream`.  causal requires seq_q == seq_k.

// K3: out (b, seq_q, h, d) and lse (b, h, seq_q); bfloat16 wants q, k
// and v 16-byte aligned.
int kg_flash_forward(int dtype, const void* q, const void* k, const void* v,
                     void* out, void* lse, int b, int h, int seq_q, int seq_k,
                     int d, float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bad_shape(b, h, seq_q, seq_k, d) || (causal && seq_q != seq_k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)forward<float>(q, k, v, out, l, b, h, seq_q, seq_k, d,
                               sm_scale, causal, s);
  if (dtype == 1)
    return (int)(d <= 64 ? forward_wgmma<64> : forward_wgmma<128>)(
        q, k, v, out, l, b, h, seq_q, seq_k, d, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// delta (b, h, seq) = rowsum(dout * out) in f32, from bfloat16 out and
// dout (b, seq, h, d), each 16-byte aligned.
int kg_flash_backward_delta(const void* out, const void* dout, void* delta,
                            int b, int h, int seq, int d, void* stream) {
  if (bad_shape(b, h, seq, seq, d) ||
      (long long)b * seq * h > INT_MAX - kThreads)
    return (int)cudaErrorInvalidValue;
  return (int)backward_delta(out, dout, static_cast<float*>(delta), b, h, seq,
                             d, static_cast<cudaStream_t>(stream));
}

// K4: dk, dv (b, seq_k, h, d) from q, k, v, the forward's out and lse, and
// dout.  bfloat16 reads delta (from kg_flash_backward_delta) and not out,
// and wants every operand 16-byte aligned; float32 takes delta from out
// and wants a null delta pointer.
int kg_flash_backward_dkdv(int dtype, const void* q, const void* k,
                           const void* v, const void* out, const void* dout,
                           const void* lse, const void* delta, void* dk,
                           void* dv, int b, int h, int seq_q, int seq_k, int d,
                           float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bad_shape(b, h, seq_q, seq_k, d) || (causal && seq_q != seq_k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && dl == nullptr)
    return (int)backward_dkdv<float>(q, k, v, out, dout, l, dk, dv, b, h,
                                     seq_q, seq_k, d, sm_scale, causal, s);
  if (dtype == 1 && dl != nullptr)
    return (int)(d <= 64 ? backward_dkdv_wgmma<64>
                         : backward_dkdv_wgmma<128>)(
        q, k, v, dout, l, dl, dk, dv, b, h, seq_q, seq_k, d, sm_scale, causal,
        s);
  return (int)cudaErrorInvalidValue;
}

// K5: dq (b, seq_q, h, d); otherwise as K4.
int kg_flash_backward_dq(int dtype, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const void* lse, const void* delta, void* dq, int b,
                         int h, int seq_q, int seq_k, int d, float sm_scale,
                         int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bad_shape(b, h, seq_q, seq_k, d) || (causal && seq_q != seq_k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && dl == nullptr)
    return (int)backward_dq<float>(q, k, v, out, dout, l, dq, b, h, seq_q,
                                   seq_k, d, sm_scale, causal, s);
  if (dtype == 1 && dl != nullptr)
    return (int)(d <= 64 ? backward_dq_wgmma<64> : backward_dq_wgmma<128>)(
        q, k, v, dout, l, dl, dq, b, h, seq_q, seq_k, d, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* kg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
