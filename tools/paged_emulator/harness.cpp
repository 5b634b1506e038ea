// Runs the paged kernels of ops/csrc/paged_attention.cu on the CPU, each
// block as 128 std::threads with real barriers and warp shuffles (see
// mock/), and checks that K2's row j equals K1 at lengths + j bit for bit
// and that K2 is within tolerance of a float64 reference, over launch plans
// that take one and several walks, tiles of one row group up to a page,
// rings of 2 to 4 stages, every q/pool type pair and exact and padded
// widths.  Built and run by run.sh; small shapes, about a minute.
#include <barrier>
#include <thread>
#include <vector>
#include <random>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <cmath>
#include <algorithm>

#include "cuda_bf16.h"

thread_local uint3_ threadIdx;
uint3_ blockIdx;
namespace { alignas(128) float smem[232448 / 4 + 64]; }
char* g_smem_base = reinterpret_cast<char*>(smem);

static std::barrier<>* g_block;
static std::barrier<>* g_warp[4];
static float g_x[4][32];

float __shfl_xor_sync(unsigned, float v, int o) {
  int t = threadIdx.x, w = t >> 5, l = t & 31;
  g_x[w][l] = v;
  g_warp[w]->arrive_and_wait();
  float r = g_x[w][l ^ o];
  g_warp[w]->arrive_and_wait();
  return r;
}
float __shfl_sync(unsigned, float v, int src) {
  int t = threadIdx.x, w = t >> 5, l = t & 31;
  g_x[w][l] = v;
  g_warp[w]->arrive_and_wait();
  float r = g_x[w][src & 31];
  g_warp[w]->arrive_and_wait();
  return r;
}
void __syncthreads() { g_block->arrive_and_wait(); }

#include "paged_attention.cpp"

static void run_block(int bx, int by, int bz, std::function<void()> body) {
  blockIdx.x = bx; blockIdx.y = by; blockIdx.z = bz;
  std::barrier<> blk(128);
  std::barrier<> w0(32), w1(32), w2(32), w3(32);
  g_block = &blk; g_warp[0] = &w0; g_warp[1] = &w1; g_warp[2] = &w2; g_warp[3] = &w3;
  // poison shared memory: a read of a score or tile never written shows
  for (auto& f : smem) f = std::nanf("");
  std::vector<std::thread> ts;
  for (int t = 0; t < 128; ++t)
    ts.emplace_back([t, &body] { threadIdx.x = t; body(); });
  for (auto& t : ts) t.join();
}

template <typename T> float to_f(T v);
template <> float to_f(float v) { return v; }
template <> float to_f(__nv_bfloat16 v) { return bf2f(v); }
template <> float to_f(int8_t v) { return v; }
template <typename T> T from_f(float v);
template <> float from_f(float v) { return v; }
template <> __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
template <> int8_t from_f(float v) { return (int8_t)std::lround(std::max(-127.f, std::min(127.f, v * 40))); }

// The launcher's two kernels, block by block: the walk over grid (h, b,
// walks x n_splits) -- the one-row kernel for a one-row window or plan --
// then the merge over the (slot, row, head) items, four a block.  The
// workspace and the output start poisoned, so a merge that reads a part
// no walk wrote, or a row it leaves unwritten, shows.
template <typename T, typename TP, int HD, bool kPadded>
void launch_emulated(const T* q, const TP* kp, const TP* vp, const float* ks,
                     const float* vs, const int* table, const int* lengths,
                     T* out, int b, int rows, int h, int hd, int page,
                     int table_width, int rows_per_walk, int tile_rows,
                     int stages, int pages_per_split, float sm) {
  if (tile_rows % Layout<TP, HD, kPadded>::kRowGroups) {
    std::fprintf(stderr, "tile rows %d: not whole row groups\n", tile_rows);
    std::abort();
  }
  const int walks = (rows + rows_per_walk - 1) / rows_per_walk;
  const int n_splits = (table_width + pages_per_split - 1) / pages_per_split;
  std::vector<float> parts((size_t)b * rows * h * n_splits * (hd + 2),
                           std::nanf(""));
  const int row = kPadded ? hd : HD;
  std::fill(out, out + (size_t)b * rows * h * row, from_f<T>(std::nanf("")));
  auto kernel = rows == 1 || rows_per_walk == 1
      ? paged_decode_walk_kernel<T, TP, HD, kPadded>
      : paged_chunk_walk_kernel<T, TP, HD, kPadded>;
  for (int bz = 0; bz < walks * n_splits; ++bz)
    for (int by = 0; by < b; ++by)
      for (int bx = 0; bx < h; ++bx)
        run_block(bx, by, bz, [&] {
          kernel(q, kp, vp, ks, vs, table, lengths, parts.data(), rows, h, hd,
                 page, table_width, rows_per_walk, tile_rows, stages,
                 pages_per_split, n_splits, sm);
        });
  for (int bx = 0; bx < (b * rows * h + 3) / 4; ++bx)
    run_block(bx, 0, 0, [&] {
      paged_merge_kernel<T>(parts.data(), lengths, out, b, rows, h, hd, page,
                            table_width, pages_per_split, n_splits);
    });
}

static int failures = 0;

// One launch plan over random pools, shuffled tables and ragged lengths
// (0, 1, either side of a page edge and of a split edge, and a window
// reaching the full table): K2 of L rows, R rows a walk, ring tiles of TR
// rows in ST stages, splits of S pages; K1 at lengths + j with a ring of its
// own (TR1 rows, ST1 stages) and the same S.

template <typename T, typename TP, int HD, bool kPadded>
void check(const char* name, int hd, int page, int L, int R, int TR, int seed,
           int ST, int S, int TR1, int ST1, int n_pages = 5) {
  const int h = 2, pool = n_pages + 9;
  const int edge = S * page;
  std::vector<int> lengths = {0, 1, page - 1, page + 1, edge - 1, edge,
                              edge + 1, std::max(0, n_pages * page - (L - 1))};
  for (auto& x : lengths) x = std::min(x, n_pages * page);
  const int b = (int)lengths.size();
  std::mt19937 rng(seed);
  std::normal_distribution<float> nd(0.f, 1.f);
  const int row = kPadded ? hd : HD;
  std::vector<T> q((size_t)b * L * h * row);
  for (auto& x : q) x = from_f<T>(nd(rng));
  std::vector<TP> kp((size_t)pool * h * page * row), vp(kp.size());
  for (auto& x : kp) x = from_f<TP>(nd(rng) * 0.3f);
  for (auto& x : vp) x = from_f<TP>(nd(rng) * 0.3f);
  std::vector<float> ks(pool * h), vs(pool * h);
  for (auto& x : ks) x = 0.01f + std::abs(nd(rng)) * 0.01f;
  for (auto& x : vs) x = 0.01f + std::abs(nd(rng)) * 0.01f;
  std::vector<int> table(b * n_pages);
  for (int s = 0; s < b; ++s) {
    std::vector<int> perm(pool);
    for (int i = 0; i < pool; ++i) perm[i] = i;
    std::shuffle(perm.begin(), perm.end(), rng);
    for (int p = 0; p < n_pages; ++p) table[s * n_pages + p] = perm[p];
  }
  const bool quant = std::is_same<TP, int8_t>::value;
  const float* kss = quant ? ks.data() : nullptr;
  const float* vss = quant ? vs.data() : nullptr;
  const float sm = 1.f / std::sqrt((float)hd);
  std::vector<T> out(q.size());
  launch_emulated<T, TP, HD, kPadded>(
      q.data(), kp.data(), vp.data(), kss, vss, table.data(), lengths.data(),
      out.data(), b, L, h, hd, page, n_pages, R, TR, ST, S, sm);
  int bad = 0;
  double worst = 0;
  for (int j = 0; j < L; ++j) {
    std::vector<T> qj((size_t)b * h * row), o1(qj.size());
    for (int s = 0; s < b; ++s)
      for (int hh = 0; hh < h; ++hh)
        for (int d = 0; d < row; ++d)
          qj[((size_t)s * h + hh) * row + d] = q[(((size_t)s * L + j) * h + hh) * row + d];
    std::vector<int> lj(lengths);
    for (auto& x : lj) x += j;
    launch_emulated<T, TP, HD, kPadded>(
        qj.data(), kp.data(), vp.data(), kss, vss, table.data(), lj.data(),
        o1.data(), b, 1, h, hd, page, n_pages, 1, TR1, ST1, S, sm);
    for (int s = 0; s < b; ++s)
      for (int hh = 0; hh < h; ++hh) {
        // double reference
        const int lim = std::min(lengths[s] + j, n_pages * page);
        std::vector<double> sc(lim);
        double mx = -1e300;
        for (int c = 0; c < lim; ++c) {
          const int phys = table[s * n_pages + c / page];
          const size_t at = (((size_t)phys * h + hh) * page + c % page) * row;
          const double scale = quant ? ks[phys * h + hh] : 1.0;
          double acc = 0;
          for (int d = 0; d < hd; ++d)
            acc += (double)to_f(q[(((size_t)s * L + j) * h + hh) * row + d]) * to_f(kp[at + d]) * scale;
          sc[c] = acc * sm;
          mx = std::max(mx, sc[c]);
        }
        double l = 0;
        for (int c = 0; c < lim; ++c) { sc[c] = std::exp(sc[c] - mx); l += sc[c]; }
        for (int d = 0; d < hd; ++d) {
          double a = 0;
          for (int c = 0; c < lim; ++c) {
            const int phys = table[s * n_pages + c / page];
            const size_t at = (((size_t)phys * h + hh) * page + c % page) * row;
            a += sc[c] * to_f(vp[at + d]) * (quant ? vs[phys * h + hh] : 1.0);
          }
          const double want = lim > 0 ? a / l : 0.0;
          const size_t o = (((size_t)s * L + j) * h + hh) * row + d;
          const float got = to_f(out[o]);
          const float k1 = to_f(o1[((size_t)s * h + hh) * row + d]);
          uint32_t g, k;
          std::memcpy(&g, &got, 4); std::memcpy(&k, &k1, 4);
          if (g != k) ++bad;
          // NaN fails too: a part read before it was written
          const double err = std::abs(got - want) / (1e-5 + std::abs(want));
          worst = std::isnan(err) ? INFINITY : std::max(worst, err);
        }
      }
  }
  const double tol = std::is_same<T, float>::value ? 1e-3 : 1e-2;
  const bool ok = bad == 0 && worst < tol;
  if (!ok) ++failures;
  std::printf("%-28s hd %3d page %3d x %2d L %2d R %d TR %3d ST %d S %d K1 TR %3d ST %d: "
              "%s (K1 mismatches %d, worst rel err %.2e)\n",
              name, hd, page, n_pages, L, R, TR, ST, S, TR1, ST1,
              ok ? "ok" : "FAIL", bad, worst);
}

int main() {
  // (hd, page, L, rows per walk, tile rows, seed, stages, pages per split,
  // K1's tile rows and stages[, table width]): all rows in one walk, one
  // row per walk, uneven walks; tiles of one row group, several per page,
  // and one covering the page; splits of one page, of two and three
  // (edges inside the table) and of the whole table (one split)
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 5, 8, 4, 1, 2, 2, 8, 2);
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 9, 8, 8, 2, 2, 1, 4, 4);
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 5, 2, 16, 3, 2, 3, 16, 2);
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 3, 1, 4, 4, 2, 5, 4, 3);
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 5, 8, 4, 14, 3, 2, 8, 4);
  check<float, float, 128, false>("f32/f32 hd128", 128, 16, 9, 4, 8, 15, 4, 1, 16, 2);
  check<__nv_bfloat16, __nv_bfloat16, 64, false>("bf16/bf16 hd64", 64, 32, 9, 8, 16, 5, 2, 2, 32, 2);
  check<__nv_bfloat16, __nv_bfloat16, 64, false>("bf16/bf16 hd64", 64, 32, 17, 3, 32, 6, 3, 3, 16, 4);
  check<__nv_bfloat16, __nv_bfloat16, 64, false>("bf16/bf16 hd64", 64, 8, 1, 8, 16, 16, 2, 2, 16, 4);
  check<__nv_bfloat16, __nv_bfloat16, 128, false>("bf16/bf16 hd128", 128, 24, 5, 8, 8, 7, 2, 2, 16, 3);
  check<float, float, 128, true>("f32/f32 hd40 (padded 128)", 40, 20, 5, 8, 4, 8, 2, 2, 8, 2);
  check<__nv_bfloat16, __nv_bfloat16, 32, true>("bf16/bf16 hd8 (padded 32)", 8, 8, 4, 8, 32, 9, 2, 3, 32, 4);
  check<float, int8_t, 128, false>("f32/int8 hd128", 128, 16, 5, 4, 16, 10, 2, 2, 16, 2);
  check<__nv_bfloat16, int8_t, 64, false>("bf16/int8 hd64", 64, 32, 9, 4, 32, 11, 4, 2, 32, 4);
  check<__nv_bfloat16, int8_t, 128, true>("bf16/int8 hd40 (padded 128)", 40, 16, 5, 8, 8, 12, 2, 1, 16, 2);
  check<float, int8_t, 32, true>("f32/int8 hd24 (padded 32)", 24, 8, 3, 8, 32, 13, 2, 3, 32, 3);
  // 40 one-page splits: the merge's second batch and second group of 32
  check<__nv_bfloat16, __nv_bfloat16, 64, false>("bf16/bf16 hd64", 64, 4, 3, 8, 16, 17, 2, 1, 16, 2, 40);
  std::printf("%s\n", failures ? "FAILED" : "ALL OK");
  return failures ? 1 : 0;
}
