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
// alike.  This first design does not reach for either: it computes in
// f32 on the CUDA cores, as the Pallas bodies compute in f32, because a
// bf16 p or ds fed to the tensor cores rounds values the reference keeps
// in f32.  Its limit is the f32 FMA rate (67 TFLOP/s) and the shared-
// memory traffic of its inner products: tiles of 64 rows are staged in
// shared memory as f32 (rows padded to 129 floats, so sixteen threads
// reading one column of sixteen rows hit sixteen banks), and each of 256
// threads holds a 4 x 4 block of a 64 x 64 score tile and a 4 x 8 block of
// a 64 x d accumulator, which reuses every shared-memory value it reads
// four or eight times.  wgmma, TMA and a bf16 p.v are the redesign.
//
// Layouts: q, out, dout, dq (b, sq, h, d); k, v, dk, dv (b, sk, h, d), all
// contiguous, float32 or bfloat16 alike; lse (b, h, sq) float32; d a
// multiple of 8 up to 128.  Causal attention has sq == sk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// grid (q tiles, b*h).  K3.
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
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kTile;
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

// grid (k tiles, b*h).  K4.
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
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kTile;
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

// grid (q tiles, b*h).  K5.
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
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kTile;
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

bool bad_shape(int b, int h, int seq_q, int seq_k, int d) {
  return b <= 0 || h <= 0 || seq_q <= 0 || seq_k <= 0 || d <= 0 ||
         d > kMaxD || d % 8 != 0 || (long long)b * h > 65535 ||
         (seq_q + kTile - 1) / kTile > 65535 ||
         (seq_k + kTile - 1) / kTile > 65535;
}

template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v, void* out,
                    float* lse, int b, int h, int seq_q, int seq_k, int d,
                    float sm_scale, int causal, cudaStream_t stream) {
  auto kernel = flash_forward_kernel<T>;
  static const cudaError_t smem_ok = allow_smem(kernel, kForwardSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((seq_q + kTile - 1) / kTile, b * h), kThreads, kForwardSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(out), lse, h,
                     seq_q, seq_k, d, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_dkdv(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const float* lse,
                          void* dk, void* dv, int b, int h, int seq_q,
                          int seq_k, int d, float sm_scale, int causal,
                          cudaStream_t stream) {
  auto kernel = flash_backward_dkdv_kernel<T>;
  static const cudaError_t smem_ok = allow_smem(kernel, kDkdvSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((seq_k + kTile - 1) / kTile, b * h), kThreads, kDkdvSmem,
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
  kernel<<<dim3((seq_q + kTile - 1) / kTile, b * h), kThreads, kDqSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(out),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                     h, seq_q, seq_k, d, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (every tensor but lse, which is float32).
// Each entry returns the launch's cudaError_t (0 on success); the kernel
// runs on `stream`.  causal requires seq_q == seq_k.

// K3: out (b, seq_q, h, d) and lse (b, h, seq_q).
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
    return (int)forward<__nv_bfloat16>(q, k, v, out, l, b, h, seq_q, seq_k, d,
                                       sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// K4: dk, dv (b, seq_k, h, d) from q, k, v, the forward's out and lse, and
// dout.
int kg_flash_backward_dkdv(int dtype, const void* q, const void* k,
                           const void* v, const void* out, const void* dout,
                           const void* lse, void* dk, void* dv, int b, int h,
                           int seq_q, int seq_k, int d, float sm_scale,
                           int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (bad_shape(b, h, seq_q, seq_k, d) || (causal && seq_q != seq_k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)backward_dkdv<float>(q, k, v, out, dout, l, dk, dv, b, h,
                                     seq_q, seq_k, d, sm_scale, causal, s);
  if (dtype == 1)
    return (int)backward_dkdv<__nv_bfloat16>(q, k, v, out, dout, l, dk, dv, b,
                                             h, seq_q, seq_k, d, sm_scale,
                                             causal, s);
  return (int)cudaErrorInvalidValue;
}

// K5: dq (b, seq_q, h, d); otherwise as K4.
int kg_flash_backward_dq(int dtype, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const void* lse, void* dq, int b, int h, int seq_q,
                         int seq_k, int d, float sm_scale, int causal,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (bad_shape(b, h, seq_q, seq_k, d) || (causal && seq_q != seq_k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)backward_dq<float>(q, k, v, out, dout, l, dq, b, h, seq_q,
                                   seq_k, d, sm_scale, causal, s);
  if (dtype == 1)
    return (int)backward_dq<__nv_bfloat16>(q, k, v, out, dout, l, dq, b, h,
                                           seq_q, seq_k, d, sm_scale, causal,
                                           s);
  return (int)cudaErrorInvalidValue;
}

const char* kg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
