// Bit-packed Pareto-dominance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel evox_tpu/kernels/dominance.py::
// packed_dominance (pallas_call at :222; body _dominance_pack_kernel :60).
// For fitness (n, m), float32, row-major, it writes
//   packed (ceil(n/32), n) int32: bit k of packed[w][j] is set iff row
//     32w + k Pareto-dominates row j (minimisation: x <= y in every
//     objective and x < y in at least one);
//   count (n,) int32: the number of rows dominating row j, the popcount of
//     column j.
// The words are int32 bit patterns of the JAX package's uint32 words.
//
// Design: each ordered pair is compared once, for "all <=" only. With
// L[i][j] = (x_i <= x_j in every objective), row i dominates row j iff
// L[i][j] and not L[j][i]: L[i][j] rules out a NaN and any larger
// objective, and given it, L[j][i] holds iff the rows are equal (so -0.0
// and +0.0 count as equal, and a row of +inf dominates nothing). A warp
// takes two 32 x 32 tiles at once, the rows of word w against the columns
// of word v and the rows of v against the columns of w:
//   lane l builds a = bits k of L[32w + k][32v + l] and
//                 b = bits k of L[32v + k][32w + l],
// one broadcast shared-memory load a row and m chained compares a bit,
// transposes both tiles across the warp (five rounds of __shfl_xor_sync),
// and stores
//   packed[w][32v + l] = a & ~transpose(b),
//   packed[v][32w + l] = b & ~transpose(a)   (once when w == v).
// The lane that builds a word stores it: 32 consecutive columns a store.
// Each lane adds the words' __popc into per-column counters in shared
// memory, and a block ends with one atomicAdd per column into count, which
// the entry point zeroes on the stream first; integer sums are exact in
// any order, so count is the same every run.
//
// Grid (square and batched forms): a block a super-tile of TILE x TILE
// words, the rows of words from W0 = by * TILE against the columns of words
// from V0 = bx * TILE; only the super-tiles by <= bx work (the others are
// their transposes), a diagonal one on its w <= v pairs. Both row ranges
// are staged once in shared memory, rows past n as NaN, which compare
// false and set no bit. TILE is 8, 4 or 2 words (4 or 2 for the generic
// instance): the wrapper (kernels/dominance.py::launch_plan) takes the
// largest whose working blocks fill the card, so a small member count or a
// small n gets smaller super-tiles and more of them, and n 20000 keeps the
// square form's redesigned plan. At 8 words the grid is that plan's, (g,
// g, members) with g = ceil(n_words / 8), the blocks by > bx exiting at
// once. At 4 and 2 words the grid is linear over every member's working
// super-tiles, so no block exits unused: block i is member z = i / P, P =
// g (g + 1) / 2, and the t = i - z P-th super-tile of that member in row
// order (row by holds g - by of them). The entry point checks the plan.
//
// Instances: the exact m = 1, 2, 3, 4 (no runtime test of m, a row in one
// 4-, 8- or 16-byte load; m = 3 pads to 16 bytes) and a generic one for
// m <= 32 that reads a row objective by objective.
//
// What bounds it on an H100: the compares of each of the n^2 (row, column)
// pairs and the logic that packs them, about n^2 * 3m operations counted
// the plain way (3.6e9 at n = 20000, m = 3), against n^2 / 8 bytes of words
// written (50 MB). The operations bound it. Here a pair costs m
// predicate-chained compares, ~1.5 instructions of packing (a select, and
// an add of three selects) and a share of the transposes (~0.8): ~5.3 at
// m = 3, where testing both ways (<= everywhere and < somewhere) a pair
// took 7.5. Compares and selects issue at half rate, so they, not the
// loads or the stores, set the pace.
//
// Batched: a batch of b independent fitness matrices (b, n, m) takes one
// launch; a block's member offsets its fitness, words and counts, so each
// member's output is what a launch of that member alone writes, bit for
// bit. The single launch is the batch of one. At the MO islands' (4, 2000,
// 3) the 8-word plan left 112 of its 256 blocks idle and one block of 4
// warps an SM; the 2-word super-tiles give 2112 working blocks, 16 an SM.
// A block stages both its row ranges with every load in flight at once.
// The batched form's bound is the function's m compares an ordered pair
// (kernels/dominance.py::dominance_compares) at 64 a clock an SM; the
// packing, transposes, stores and counts come on top of them.
//
// Rows form (the mesh-sharded sort's slab, one launch a shard): a slab of
// R dominator rows (rows, +inf-padded by the caller) against the full
// fitness (n columns). Block (bx, by) takes the rows of words [by * TILE,
// ...) of the slab against the columns of words [bx * TILE, ...) of the
// fitness; every block works (the two sides are different rows, so no
// tile is another's transpose). Here only one direction is wanted, so a
// pair is tested one way, strictly, in one pass over the objectives:
//   bit k of lane l's word = le_all(slab 32w + k, column 32v + l)
//                            && lt_any(slab 32w + k, column 32v + l)
// (every x <= y, some x < y). That is the square form's a & ~transpose(b)
// bit for bit: given L[i][j] (no NaN, no larger objective), the reverse
// L[j][i] holds exactly when the rows are equal (-0.0 == +0.0), which is
// exactly when no objective is strictly less; a NaN fails <= and sets no
// bit; a row of +inf has no < against an equal row. No b word and no
// transpose32. A lane takes C column words (C = 4 for the exact instances,
// 2 for the generic one: a warp task is one slab word against C column
// words, TILE * TILE / C tasks a block), holding its C column rows in
// registers, so one broadcast shared-memory load of a slab row feeds C
// pairs. A pair costs m compares into "all <=", m into "some <", a
// predicated OR into its word and 1/C of a load: about 2m + 1.25
// instructions, 7.25 at m = 3, against ~10.6 for the two words and their
// transposes (2 x 5.3). The slab's words are (ceil(R/32), n) and its counts
// (n,) the popcounts of their columns: the concatenated slabs of a padded
// fitness are the full matrix's words (then zero words), and the slabs'
// counts sum to the full counts.
//
// Numerics. Plain IEEE compares, as in the JAX package: a NaN objective
// makes L false both ways, so a NaN row dominates nothing and is dominated
// by nothing.
//
// C interface (loaded with ctypes): evox_packed_dominance,
// evox_packed_dominance_batched and evox_packed_dominance_rows return
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;         // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 32;             // objectives the kernel takes

// words a side of an instance's super-tile: 8 for the exact instances (8
// KB of rows), 4 for the generic one (its rows of up to 32 objectives take
// 32 KB)
template <int M> struct TileWords { static constexpr int value = M > 0 ? 8 : 4; };

// column words a lane of the rows form takes: 4 for the exact instances
// (four column rows in registers), 2 for the generic one
template <int M> struct RowsColumns { static constexpr int value = M > 0 ? 4 : 2; };

// a row of M objectives as one load: M = 1 float, 2 float2, 3 and 4 float4
template <int M> struct RowOf { using T = float4; static constexpr int kStride = 4; };
template <> struct RowOf<1> { using T = float; static constexpr int kStride = 1; };
template <> struct RowOf<2> { using T = float2; static constexpr int kStride = 2; };

__device__ __forceinline__ float get(const float& r, int) { return r; }
__device__ __forceinline__ float get(const float2& r, int k) { return k == 0 ? r.x : r.y; }
__device__ __forceinline__ float get(const float4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// every x_k <= y_k (bitwise &, no short circuit, so the compares chain
// through predicates)
template <int M, class Row>
__device__ __forceinline__ bool le_all(const Row& x, const Row& y) {
  bool le = true;
#pragma unroll
  for (int k = 0; k < M; ++k) le = le & (get(x, k) <= get(y, k));
  return le;
}

// x Pareto-dominates y: every x_k <= y_k and some x_k < y_k, in one pass
template <int M, class Row>
__device__ __forceinline__ bool dominates(const Row& x, const Row& y) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    le = le & (get(x, k) <= get(y, k));
    lt = lt | (get(x, k) < get(y, k));
  }
  return le & lt;
}

__device__ __forceinline__ bool dominates_generic(const float* x, const float* y, int m) {
  bool le = true, lt = false;
#pragma unroll 4
  for (int k = 0; k < m; ++k) {
    le = le & (x[k] <= y[k]);
    lt = lt | (x[k] < y[k]);
  }
  return le & lt;
}

__device__ __forceinline__ bool le_all_generic(const float* x, const float* y, int m) {
  bool le = true;
#pragma unroll 4
  for (int k = 0; k < m; ++k) le = le & (x[k] <= y[k]);
  return le;
}

// The transpose of a 32 x 32 bit tile held one 32-bit word a lane: bit k
// of lane l's result is bit l of lane k's word. Round s swaps the
// off-diagonal s x s blocks of each 2s x 2s block between lanes l and
// l ^ s.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const unsigned low = s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu
                       : s == 4 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u : 0x55555555u;
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~low) | ((y & ~low) >> s)) : ((x & low) | ((y & low) << s));
  }
  return x;
}

// stage the rows of words [w0, w0 + words) into xs, `stride` floats a row,
// objective k of row r at xs[(r - 32 w0) * stride + k]; rows past n are
// NaN (they compare false), pad slots 0
__device__ __forceinline__ void stage_rows(const float* __restrict__ fit, int n, int m,
                                           int stride, int w0, int words, float* xs) {
  const int r0 = 32 * w0;
  const int total = 32 * words * stride;
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const int rr = t / stride, k = t - rr * stride;
    const int r = r0 + rr;
    float v = 0.0f;
    if (k < m) v = r < n ? __ldg(fit + (long long)r * m + k) : __int_as_float(0x7fc00000);
    xs[t] = v;
  }
}

// The exact instances' staging of a super-tile's two row ranges (words
// [w0, w0 + wn) into xs_w, [v0, v0 + vn) into xs_v, as stage_rows lays
// them out): every load of both ranges issued before the first store, so a
// block waits for one round trip to memory, not one a range and a loop
// step
template <int M, int TILE>
__device__ __forceinline__ void stage_pair(const float* __restrict__ fit, int n, int w0, int wn,
                                           int v0, int vn, float* xs_w, float* xs_v) {
  constexpr int S = RowOf<M>::kStride;
  constexpr int kRange = 32 * TILE * S;  // floats a range
  constexpr int kSteps = (2 * kRange + kThreads - 1) / kThreads;
  float v[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = threadIdx.x + i * kThreads;
    const bool second = t >= kRange;
    const int tt = second ? t - kRange : t;
    const int rr = tt / S, k = tt % S;
    const int r = 32 * (second ? v0 : w0) + rr;
    v[i] = 0.0f;
    if (t < 2 * kRange && k < M && rr < 32 * (second ? vn : wn)) {
      v[i] = r < n ? __ldg(fit + static_cast<long long>(r) * M + k) : __int_as_float(0x7fc00000);
    }
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = threadIdx.x + i * kThreads;
    if (t < 2 * kRange) (t >= kRange ? xs_v + (t - kRange) : xs_w + t)[0] = v[i];
  }
}

// The first super-tile of row by of a member's g x g super-tiles, in row
// order (row r holds the g - r super-tiles r <= bx < g)
__device__ __forceinline__ long long row_start(long long by, long long g) {
  return by * (2 * g - by + 1) / 2;
}

// Where a block works: its member and the first words of its super-tile's
// rows (W0) and columns (V0). On the linear grid (super-tiles of 4 and 2
// words) thread 0 finds them and every thread reads them back from shared
// memory where it needs them (volatile), so that no register of the tile
// loop holds them (the m = 3 and 4 instances use all 80); on the 2-D grid
// (8 words) they are the block's indices, which cost no register either.
template <int TILE>
struct Place {
  static constexpr bool kLinear = TILE < 8;
  const volatile int* tile;
  __device__ __forceinline__ int member() const { return kLinear ? tile[0] : blockIdx.z; }
  __device__ __forceinline__ int w0() const { return kLinear ? tile[1] : blockIdx.y * TILE; }
  __device__ __forceinline__ int v0() const { return kLinear ? tile[2] : blockIdx.x * TILE; }
};

// M in 1..4: exact; M == 0: generic, m <= kMaxM read one objective at a
// time. The exact instances keep to 80 registers (6 blocks an SM; at 64
// the m = 3 and 4 instances spill), the generic one to 64 (8).
template <int M, int TILE>
__global__ void __launch_bounds__(kThreads, M > 0 ? 6 : 8)
dominance_kernel(const float* __restrict__ fit, int n, int m, int n_words, int g,
                 int per_member, int* __restrict__ packed, int* __restrict__ count) {
  __shared__ int tile_of[3];  // member, W0, V0 on the linear grid
  const Place<TILE> place{tile_of};
  if constexpr (Place<TILE>::kLinear) {
    // block -> (member z, the t-th working super-tile of that member in row
    // order): row by from the root of by (2g - by + 1) / 2 = t, corrected
    // to the last row whose first super-tile is at or before t
    if (threadIdx.x == 0) {
      const int z = blockIdx.x / per_member;
      const long long t = blockIdx.x - static_cast<long long>(z) * per_member;
      const float h = 2.0f * g + 1.0f;
      int by = static_cast<int>((h - sqrtf(fmaxf(h * h - 8.0f * t, 0.0f))) * 0.5f);
      by = max(0, min(by, g - 1));
      while (by > 0 && row_start(by, g) > t) --by;
      while (by + 1 < g && row_start(by + 1, g) <= t) ++by;
      tile_of[0] = z;
      tile_of[1] = by * TILE;
      tile_of[2] = static_cast<int>(by + t - row_start(by, g)) * TILE;
    }
    __syncthreads();
  } else {
    if (blockIdx.y > blockIdx.x) return;  // the transposes of super-tiles another block takes
  }
  extern __shared__ __align__(16) float smem[];
  const int stride = M > 0 ? RowOf<(M > 0 ? M : 4)>::kStride : m;
  float* xs_w = smem;
  float* xs_v = smem + 32 * TILE * stride;
  int* cnt_w = reinterpret_cast<int*>(xs_v + 32 * TILE * stride);
  int* cnt_v = cnt_w + 32 * TILE;
  {
    const int W0 = place.w0(), V0 = place.v0();
    const float* f = fit + static_cast<long long>(place.member()) * n * m;
    if constexpr (M > 0) {
      stage_pair<M, TILE>(f, n, W0, min(TILE, n_words - W0), V0,
                          min(TILE, n_words - V0), xs_w, xs_v);
    } else {
      stage_rows(f, n, m, stride, W0, min(TILE, n_words - W0), xs_w);
      stage_rows(f, n, m, stride, V0, min(TILE, n_words - V0), xs_v);
    }
  }
  for (int i = threadIdx.x; i < 64 * TILE; i += kThreads) cnt_w[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < TILE * TILE; task += kWarps) {
    const int wi = task / TILE, vi = task % TILE;
    {
      const int W0 = place.w0(), V0 = place.v0();
      // past the edge, or a diagonal super-tile's lower triangle
      if (wi >= n_words - W0 || vi >= n_words - V0 || W0 + wi > V0 + vi) continue;
    }
    unsigned a = 0, b = 0;  // bit k: L[32w + k][32v + lane], L[32v + k][32w + lane]
    if constexpr (M > 0) {
      using Row = typename RowOf<M>::T;
      const Row* rw = reinterpret_cast<const Row*>(xs_w) + 32 * wi;
      const Row* rv = reinterpret_cast<const Row*>(xs_v) + 32 * vi;
      const Row yv = rv[lane], yw = rw[lane];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (le_all<M>(rw[k], yv)) a |= 1u << k;
        if (le_all<M>(rv[k], yw)) b |= 1u << k;
      }
    } else {
      const float* rw = xs_w + 32 * wi * m;
      const float* rv = xs_v + 32 * vi * m;
      const float* yv = rv + lane * m;
      const float* yw = rw + lane * m;
#pragma unroll 2
      for (int k = 0; k < 32; ++k) {
        a |= static_cast<unsigned>(le_all_generic(rw + k * m, yv, m)) << k;
        b |= static_cast<unsigned>(le_all_generic(rv + k * m, yw, m)) << k;
      }
    }
    const unsigned at = transpose32(a, lane), bt = transpose32(b, lane);
    const int w = place.w0() + wi, v = place.v0() + vi;
    int* words = packed + static_cast<long long>(place.member()) * n_words * n;
    const unsigned d_wv = a & ~bt;  // packed[w][32v + lane]
    const int jv = 32 * v + lane;
    if (jv < n) words[(long long)w * n + jv] = static_cast<int>(d_wv);
    atomicAdd(cnt_v + 32 * vi + lane, __popc(d_wv));
    if (w != v) {
      const unsigned d_vw = b & ~at;  // packed[v][32w + lane]
      const int jw = 32 * w + lane;
      if (jw < n) words[(long long)v * n + jw] = static_cast<int>(d_vw);
      atomicAdd(cnt_w + 32 * wi + lane, __popc(d_vw));
    }
  }
  __syncthreads();
  int* counts = count + static_cast<long long>(place.member()) * n;
  const int W0 = place.w0(), V0 = place.v0();
  for (int i = threadIdx.x; i < 32 * TILE; i += kThreads) {
    const int jw = 32 * W0 + i, jv = 32 * V0 + i;
    if (jw < n && cnt_w[i]) atomicAdd(counts + jw, cnt_w[i]);
    if (jv < n && cnt_v[i]) atomicAdd(counts + jv, cnt_v[i]);
  }
}

// The rows form: slab rows [0, r) of `rows` (word rows by * TILE ..)
// against fitness columns (word columns bx * TILE ..); rows past r and
// columns past n are NaN.
template <int M>
__global__ void __launch_bounds__(kThreads, M > 0 ? 6 : 8)
dominance_rows_kernel(const float* __restrict__ rows, int r, const float* __restrict__ fit,
                      int n, int m, int* __restrict__ packed, int* __restrict__ count) {
  constexpr int TILE = TileWords<M>::value;
  constexpr int C = RowsColumns<M>::value;
  constexpr int kGroups = TILE / C;
  const int W0 = blockIdx.y * TILE, V0 = blockIdx.x * TILE;
  extern __shared__ __align__(16) float smem[];
  const int stride = M > 0 ? RowOf<(M > 0 ? M : 4)>::kStride : m;
  const int r_words = (r + 31) / 32, n_words = (n + 31) / 32;
  const int wn = min(TILE, r_words - W0), vn = min(TILE, n_words - V0);
  float* xs_w = smem;
  float* xs_v = smem + 32 * TILE * stride;
  int* cnt_v = reinterpret_cast<int*>(xs_v + 32 * TILE * stride);
  stage_rows(rows, r, m, stride, W0, wn, xs_w);
  stage_rows(fit, n, m, stride, V0, vn, xs_v);
  for (int t = threadIdx.x; t < 32 * TILE; t += kThreads) cnt_v[t] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < TILE * kGroups; t += kWarps) {
    const int wi = t / kGroups, v0 = (t - wi * kGroups) * C;  // slab word, first column word
    if (wi >= wn || v0 >= vn) continue;
    const int w = W0 + wi;
    unsigned d[C];  // bit k of d[c]: slab 32w + k dominates column 32(V0 + v0 + c) + lane
#pragma unroll
    for (int c = 0; c < C; ++c) d[c] = 0;
    if constexpr (M > 0) {
      using Row = typename RowOf<M>::T;
      const Row* rw = reinterpret_cast<const Row*>(xs_w) + 32 * wi;
      const Row* rv = reinterpret_cast<const Row*>(xs_v) + 32 * v0;
      Row y[C];  // past vn: never stored
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = rv[32 * c + lane];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const Row x = rw[k];  // one broadcast load, C pairs
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (dominates<M>(x, y[c])) d[c] |= 1u << k;
      }
    } else {
      const float* rw = xs_w + 32 * wi * m;
      const float* rv = xs_v + (32 * v0 + lane) * m;
#pragma unroll 2
      for (int k = 0; k < 32; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          d[c] |= static_cast<unsigned>(dominates_generic(rw + k * m, rv + 32 * c * m, m)) << k;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (v0 + c >= vn) break;
      const int jv = 32 * (V0 + v0 + c) + lane;
      if (jv < n) packed[(long long)w * n + jv] = static_cast<int>(d[c]);
      atomicAdd(cnt_v + 32 * (v0 + c) + lane, __popc(d[c]));
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * TILE; t += kThreads) {
    const int jv = 32 * V0 + t;
    if (jv < n && cnt_v[t]) atomicAdd(count + jv, cnt_v[t]);
  }
}

// the shared-memory floats a row takes in an instance
int row_stride(int instance, int m) {
  return instance == 0 ? m : instance == 1 ? 1 : instance == 2 ? 2 : 4;
}

// the rows form's super-tile: 8 words a side for the exact instances, 4 for
// the generic one
int tile_words(int instance) { return instance > 0 ? TileWords<1>::value : TileWords<0>::value; }

// the square form's super-tiles: 8, 4 or 2 words a side (4 or 2 generic)
bool square_tile(int instance, int tile) {
  return tile == 2 || tile == 4 || (tile == 8 && instance > 0);
}

// a super-tile's two row ranges and two column counters
size_t smem_bytes(int instance, int tile, int m) {
  return sizeof(float) * 2 * 32 * tile * row_stride(instance, m) + sizeof(int) * 2 * 32 * tile;
}

template <int M, int TILE>
const void* square_kernel() {
  return reinterpret_cast<const void*>(dominance_kernel<M, TILE>);
}

template <int TILE>
const void* square_kernel_of(int instance) {
  return instance == 1 ? square_kernel<1, TILE>()
       : instance == 2 ? square_kernel<2, TILE>()
       : instance == 3 ? square_kernel<3, TILE>()
       : instance == 4 ? square_kernel<4, TILE>()
       : square_kernel<0, (TILE > 4 ? 4 : TILE)>();
}

const void* kernel_of(int instance, int tile) {
  return tile == 8 ? square_kernel_of<8>(instance)
       : tile == 4 ? square_kernel_of<4>(instance) : square_kernel_of<2>(instance);
}

}  // namespace

// instance: 1..4 for the exact m (it must equal m), 0 for the generic one;
// tile: the super-tile's words a side; blocks: the grid's blocks, batch * g
// * g for tile 8 (a (g, g, batch) grid), batch * g (g + 1) / 2 for tiles 4
// and 2 (a linear grid), with g = ceil(ceil(n / 32) / tile)
// (kernels/dominance.py::launch_plan); fitness is (batch, n, m), packed
// (batch, ceil(n/32), n), count (batch, n). The counts are zeroed on the
// stream first (every block adds into them).
extern "C" int evox_packed_dominance_batched(const void* fitness, int batch, int n, int m,
                                             void* packed, void* count, void* stream,
                                             int instance, int tile, int blocks) {
  if (batch <= 0 || n <= 0 || m <= 0 || m > kMaxM || !(instance == 0 || instance == m) ||
      instance > 4 || !square_tile(instance, tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_words = (n + 31) / 32;
  const long long g = (n_words + tile - 1) / tile;
  const long long per = g * (g + 1) / 2;
  const bool linear = tile < 8;
  if (per > 0x7FFFFFFFLL || static_cast<long long>(blocks) != batch * (linear ? per : g * g) ||
      (!linear && (g > 65535 || batch > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fit = static_cast<const float*>(fitness);
  int* words = static_cast<int*>(packed);
  int* counts = static_cast<int*>(count);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int) * static_cast<size_t>(n) * static_cast<size_t>(batch), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gi = static_cast<int>(g), pi = static_cast<int>(per);
  void* args[] = {&fit, &n, &m, const_cast<int*>(&n_words), &gi, &pi, &words, &counts};
  const dim3 grid = linear ? dim3(blocks) : dim3(gi, gi, batch);
  err = cudaLaunchKernel(kernel_of(instance, tile), grid, dim3(kThreads), args,
                         smem_bytes(instance, tile, m), st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The rows form: rows (r, m) against fitness (n, m); packed (ceil(r/32),
// n), count (n,). grid_x = ceil(ceil(n / 32) / tile_words), grid_y =
// ceil(ceil(r / 32) / tile_words) for the instance's super-tile, and
// columns the column words a lane takes (4 exact, 2 generic)
// (kernels/dominance.py::rows_launch_plan).
extern "C" int evox_packed_dominance_rows(const void* rows, int r, const void* fitness, int n,
                                          int m, void* packed, void* count, void* stream,
                                          int instance, int grid_x, int grid_y, int columns) {
  const int n_words = (n + 31) / 32, r_words = (r + 31) / 32;
  if (r <= 0 || n <= 0 || m <= 0 || m > kMaxM || !(instance == 0 || instance == m) ||
      instance > 4 ||
      columns != (instance > 0 ? RowsColumns<1>::value : RowsColumns<0>::value) ||
      grid_x != (n_words + tile_words(instance) - 1) / tile_words(instance) ||
      grid_y != (r_words + tile_words(instance) - 1) / tile_words(instance) ||
      grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(count);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(n), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* rw = static_cast<const float*>(rows);
  const float* fit = static_cast<const float*>(fitness);
  int* words = static_cast<int*>(packed);
  const dim3 g(grid_x, grid_y);
  // the slab's rows, the fitness's rows and the column counters
  const size_t smem = sizeof(float) * 2 * 32 * tile_words(instance) * row_stride(instance, m) +
                      sizeof(int) * 32 * tile_words(instance);
  switch (instance) {
    case 1: dominance_rows_kernel<1><<<g, kThreads, smem, st>>>(rw, r, fit, n, m, words, counts); break;
    case 2: dominance_rows_kernel<2><<<g, kThreads, smem, st>>>(rw, r, fit, n, m, words, counts); break;
    case 3: dominance_rows_kernel<3><<<g, kThreads, smem, st>>>(rw, r, fit, n, m, words, counts); break;
    case 4: dominance_rows_kernel<4><<<g, kThreads, smem, st>>>(rw, r, fit, n, m, words, counts); break;
    default: dominance_rows_kernel<0><<<g, kThreads, smem, st>>>(rw, r, fit, n, m, words, counts); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// the runtime's blocks an SM and registers a thread of a square-form
// instance and super-tile, at the shared memory it takes for m objectives
extern "C" int evox_dominance_occupancy(int instance, int tile, int m, int* blocks_per_sm,
                                        int* registers) {
  if (!square_tile(instance, tile)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const void* fn = kernel_of(instance, tile);
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, smem_bytes(instance, tile, m)));
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
