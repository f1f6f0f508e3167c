// Batch-invariant float32 product for Hopper (sm_90a): kernel M1.
//
// Replaces no Pallas kernel. The JAX package leaves CMA-ES's products to
// XLA; in the port, cuBLAS picks its kernel (and with it the summation
// order) by the batch count, so a CMA-ES tenant of a 64-member fleet
// rounded apart from its solo run (one vmap over 64 members against a
// batch of one). This kernel computes
//   c[z] = op(a[z]) op(b[z]),  op(x) = x or x^T,
// for a batch of z independent (p, k) x (k, q) float32 products, and sums
// each output element over k in ONE fixed order:
//   acc = 0; for t = 0 .. k-1: acc = rn(acc + rn(a[i][t] * b[t][j]))
// with every multiply and add rounded on its own (__fmul_rn, __fadd_rn;
// the library is built with -fmad=false as well). Nothing in that order
// depends on z, the batch count, the grid, the tile or the group a product
// is launched in: a member computed in a batch of 64 equals the same member
// in a batch of 1, bit for bit, and the plain PyTorch version
// (kernels/smallmm.py::smallmm_plain, a loop over k of elementwise
// multiplies and adds) reproduces it step by step. No tensor cores and no
// split of k: either would change the order.
//
// Grouped launches: one grid runs a small table of independent products
// (at most kMaxProducts), each with its own shape, transposes, launch plan
// and an optional row scale of the stored a, applied as rn(a * w) before
// the product (the same rounding as a separate elementwise multiply).
// Block x of the grid belongs to the product whose tile range holds it;
// blockIdx.y is the batch member. A single product is a table of one.
//
// Design. A block takes a bm x bn tile of one product's output; its
// threads form a wm x wn grid, each thread TM x TN outputs (register
// blocking: TM * TN independent __fadd_rn chains interleave). The launch
// plan (kernels/smallmm.py::launch_plan) picks (TM, TN, wm, wn) by shape:
//   skinny (p <= 32): 2 x 1 a thread, wm = ceil(p / 2), bn = 8 -- one row
//     tile, so the wide operand is read from device memory once;
//   thin (q <= 32 < p): 1 x 2, bm = 8;
//   square: 4 x 4, 64 x 64 tiles of 256 threads;
//   vector (p = 1 or q = 1): 1 x 1, the rows (or columns) spread so that
//     about 128 blocks work.
// k goes in slices of 32 steps, or 128 for a sum of 256 steps or more, each
// staged in shared memory by cp.async in a ring of up to 8 slices in
// flight (4 for the square tile and for long slices; no more than k needs
// or 160 KB holds), sized to the tile so that small tiles keep many blocks
// an SM. Each operand is staged in the layout its storage gives: one whose
// stored rows run along k (a as (p, k), b as (q, k)) row by row, s[r][t],
// one whose stored rows run along the tile (a^T, b as (k, q)) slice-row by
// slice-row, s[t][r]; either way in 16-byte copies with shift-only indexing
// where the contiguous length is a multiple of 4 and the base is 16-byte
// aligned, 4-byte copies otherwise. A (1, k) or (k, 1) operand is the same
// memory in either storage and is read as a row along k.
//
// Where the time went, and what the design does about it (cycles of one
// slice on an H100 at 1980 MHz, tools/torch_m1_probe.py):
//   - 4-byte copies that transposed in flight, one a float, cost their
//     issuing thread 700-1400 cycles of dependent address arithmetic a
//     slice: the row-along-k layout and 16-byte copies;
//   - a slice's fixed costs (issuing, ~110-150 cycles of waiting) against
//     32 steps of sum: 128-step slices for long sums;
//   - at one to three warps an SM, nothing hides the copies' issue (a
//     cp.async costs its warp ~120 cycles): a block whose plan computes
//     with at most four warps, over more than one slice, gets four more
//     warps that only copy, so a slice's copies go out while the slice
//     before is summed;
//   - the sum itself: a dependent __fadd_rn takes 4.2 cycles, so the
//     shared-memory loads must stay off the chains: small tiles load each
//     chunk of 8 steps into registers while the chunk before is summed
//     (128-bit loads along a row-along-k operand, four steps a load).
//
// What bounds it on an H100: 2 p k q operations a member against
// 4 (p k + k q + p q) bytes. CMA-ES's shapes are small (d 16: 16 x 16
// tiles) or issue-bound (d 1000: (24 x 1000)(1000 x 1000), 48 MFLOP), and
// the products cannot use the tensor cores or FMA and keep the order
// above, so the float32 issue rate (67 TFLOP/s counting a multiply and an
// add as two) is the ceiling. A product with p = 1 or q = 1 is one chain
// of k dependent adds an output: a latency floor of about k x the FADD
// latency (4 cycles) at the card's clock, which no tiling shortens.
//
// C interface (loaded with ctypes): evox_smallmm_group returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;                 // k a slice of a short sum
constexpr int kLongK = 128;             // k a slice of a long sum (k >= kLongFrom)
constexpr int kLongFrom = 256;
constexpr int kMaxTile = 64;            // rows (columns) of a block tile at most
constexpr int kMaxThreads = 256;
constexpr int kMaxProducts = 4;
constexpr int kMaxSmem = 160 * 1024;    // dynamic shared memory a block may take
constexpr int kCopyThreads = 128;       // warps that only copy, beside a small tile's

enum Variant { kSkinny = 0, kThin = 1, kSquare = 2, kVector = 3 };
__host__ __device__ constexpr int tm_of(int v) { return v == kSkinny ? 2 : v == kSquare ? 4 : 1; }
__host__ __device__ constexpr int tn_of(int v) { return v == kThin ? 2 : v == kSquare ? 4 : 1; }
// slices in flight at most: the square tile's slice is 17 KB, the others' a
// few KB (short slices) or up to 70 KB (long ones)
__host__ __device__ constexpr int ring_of(int v, int kslice) {
  return kslice == kLongK || v == kSquare ? 4 : 8;
}

struct Product {
  const float* a;
  const float* b;
  float* c;
  const float* scale;  // rows of the stored a, or null
  int p, k, q;
  int trans_a, trans_b;
  int variant, wm, wn;
  int tiles_n;     // column tiles; the product has tiles_m * tiles_n
  int tile_start;  // its first block on the grid's x axis
  int vec_a, vec_b;
  int kc_a, kc_b;  // staged row along k (the stored rows run along k)
  int lda, ldb;    // floats a staged row of a and of b
  int a_floats;    // floats of a's part of a slice
  int kslice;      // k a slice: kBK, or kLongK for a long sum
  int ring;        // slices in flight
};

struct Group {
  Product prod[kMaxProducts];
  int count;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n (0..7) committed groups are pending
__device__ __forceinline__ void cp_wait_at_most(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// Stage rows [r0, r0 + nr) by k-slice [k0, k0 + kn) of an operand, copier
// cid of ncp issuing every ncp-th copy. kc
// (rows along k): stored (R, k), element (r, t) at src[r * k + t], staged
// at dst[(r - r0) * ld + t]; else stored (k, R), element at src[t * R + r],
// staged at dst[t * ld + r - r0]. vec: 16-byte copies along the contiguous
// direction. Rows past R and k past kn are not copied (their outputs are
// discarded, their terms never added).
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src, int R,
                                      int k, int r0, int nr, int k0, int kn, int kslice, bool kc,
                                      bool vec, int cid, int ncp) {
  const int shift = kslice == kLongK ? 7 : 5;  // log2(kslice)
  if (kc && vec) {  // k % 4 == 0, so kn % 4 == 0: kslice / 4 copies a row
    for (int idx = cid; idx < nr << (shift - 2); idx += ncp) {
      const int rr = idx >> (shift - 2), c = (idx & ((kslice >> 2) - 1)) * 4;
      const int r = r0 + rr;
      if (c < kn && r < R) cp_async16(dst + rr * ld + c, src + static_cast<long long>(r) * k + k0 + c);
    }
  } else if (kc) {
    for (int idx = cid; idx < nr << shift; idx += ncp) {
      const int rr = idx >> shift, t = idx & (kslice - 1);
      const int r = r0 + rr;
      if (t < kn && r < R) cp_async4(dst + rr * ld + t, src + static_cast<long long>(r) * k + k0 + t);
    }
  } else if (vec) {  // R % 4 == 0, r0 % 4 == 0
    const int chunks = nr >> 2;
    for (int idx = cid; idx < kn * chunks; idx += ncp) {
      const int t = idx / chunks, c = idx - t * chunks;
      const int r = r0 + 4 * c;
      if (r < R) cp_async16(dst + t * ld + 4 * c, src + static_cast<long long>(k0 + t) * R + r);
    }
  } else {
    for (int idx = cid; idx < kn * nr; idx += ncp) {
      const int t = idx / nr, rr = idx - t * nr;
      const int r = r0 + rr;
      if (r < R) cp_async4(dst + t * ld + rr, src + static_cast<long long>(k0 + t) * R + r);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* s) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = s[0];
  }
}

// N values of a staged operand at step t: its rows r0 .. r0 + N - 1 of a
// slice staged row by row along t (KC) or slice-row by slice-row (else)
template <int N, bool KC>
__device__ __forceinline__ void load_step(float (&v)[N], const float* s, int ld, int r0, int t) {
  if constexpr (KC) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = s[(r0 + i) * ld + t];
  } else {
    load_row<N>(v, s + t * ld + r0);
  }
}

// CH steps t .. t + CH - 1 of N rows: v[u][i] (t % 4 == 0, staged rows
// 16-byte aligned)
template <int CH, int N, bool KC>
__device__ __forceinline__ void load_steps(float (&v)[CH][N], const float* s, int ld, int r0,
                                           int t) {
  if constexpr (KC) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int u = 0; u < CH; u += 4) {
        const float4 x = *reinterpret_cast<const float4*>(s + (r0 + i) * ld + t + u);
        v[u][i] = x.x; v[u + 1][i] = x.y; v[u + 2][i] = x.z; v[u + 3][i] = x.w;
      }
  } else {
#pragma unroll
    for (int u = 0; u < CH; ++u) load_row<N>(v[u], s + (t + u) * ld + r0);
  }
}

// One step of the sum in M1's order: acc += a * b, each rounded.
template <int TM, int TN, bool AK, bool BK>
__device__ __forceinline__ void step(float (&acc)[TM][TN], const float* as, int lda, int ra,
                                     const float* bs, int ldb, int rb, int t) {
  float av[TM], bv[TN];
  load_step<TM, AK>(av, as, lda, ra, t);
  load_step<TN, BK>(bv, bs, ldb, rb, t);
#pragma unroll
  for (int ii = 0; ii < TM; ++ii)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj)
      acc[ii][jj] = __fadd_rn(acc[ii][jj], __fmul_rn(av[ii], bv[jj]));
}

// Sum steps [0, kn) of one staged slice into acc, in order. A small tile
// (one or two chains a thread) goes in chunks of 8 steps, each chunk's
// operands loaded into registers while the chunk before it is summed (two
// register buffers), so the shared-memory latency stays off the add
// chains; the square tile's 16 chains interleave on their own, 4 steps a
// load. Steps past the last whole chunk go one by one.
template <int TM, int TN, bool AK, bool BK>
__device__ __forceinline__ void sum_slice(float (&acc)[TM][TN], const float* as, int lda, int ra,
                                          const float* bs, int ldb, int rb, int kn) {
  constexpr int CH = TM * TN >= 8 ? 4 : 8;
  auto mac = [&](const float (&va)[CH][TM], const float (&vb)[CH][TN]) {
#pragma unroll
    for (int u = 0; u < CH; ++u)
#pragma unroll
      for (int ii = 0; ii < TM; ++ii)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[ii][jj] = __fadd_rn(acc[ii][jj], __fmul_rn(va[u][ii], vb[u][jj]));
  };
  const int chunks = kn / CH;
  int c = 0;
  if constexpr (TM * TN >= 8) {
    for (; c < chunks; ++c) {
      float va[CH][TM], vb[CH][TN];
      load_steps<CH, TM, AK>(va, as, lda, ra, c * CH);
      load_steps<CH, TN, BK>(vb, bs, ldb, rb, c * CH);
      mac(va, vb);
    }
  } else {
    float xa[CH][TM], xb[CH][TN], ya[CH][TM], yb[CH][TN];
    if (chunks > 0) {
      load_steps<CH, TM, AK>(xa, as, lda, ra, 0);
      load_steps<CH, TN, BK>(xb, bs, ldb, rb, 0);
    }
    for (; c + 2 <= chunks; c += 2) {
      load_steps<CH, TM, AK>(ya, as, lda, ra, (c + 1) * CH);
      load_steps<CH, TN, BK>(yb, bs, ldb, rb, (c + 1) * CH);
      mac(xa, xb);
      if (c + 2 < chunks) {
        load_steps<CH, TM, AK>(xa, as, lda, ra, (c + 2) * CH);
        load_steps<CH, TN, BK>(xb, bs, ldb, rb, (c + 2) * CH);
      }
      mac(ya, yb);
    }
    if (c < chunks) mac(xa, xb);
    c = chunks;
  }
  for (int t = c * CH; t < kn; ++t) step<TM, TN, AK, BK>(acc, as, lda, ra, bs, ldb, rb, t);
}

template <int TM, int TN, bool AK, bool BK>
__device__ __forceinline__ void tile_product(const Product& P, int tile, long long z,
                                             float* smem) {
  const int tiles_n = P.tiles_n;
  const int ti = tile / tiles_n, tj = tile - ti * tiles_n;
  const int bm = P.wm * TM, bn = P.wn * TN;
  const int i0 = ti * bm, j0 = tj * bn;
  const int p = P.p, k = P.k, q = P.q;
  const int lda = P.lda, ldb = P.ldb, ring = P.ring, kslice = P.kslice;
  const int slice_floats = P.a_floats + (BK ? bn * ldb : kslice * ldb);
  const float* a = P.a + z * p * k;
  const float* b = P.b + z * k * q;
  float* c = P.c + z * p * q;
  const float* scale = P.scale ? P.scale + z * (P.trans_a ? k : p) : nullptr;
  const int tid = threadIdx.x;
  const bool active = tid < P.wm * P.wn;
  const int ty = tid / P.wn, tx = tid - ty * P.wn;
  // the warps past the plan's own copy while those sum; a block with none
  // spare copies with every thread
  const int compute = (P.wm * P.wn + 31) / 32 * 32;
  const bool spare = static_cast<int>(blockDim.x) > compute;
  const bool copier = !spare || tid >= compute;
  const int cid = spare ? tid - compute : tid;
  const int ncp = spare ? static_cast<int>(blockDim.x) - compute : static_cast<int>(blockDim.x);
  float acc[TM][TN];
#pragma unroll
  for (int ii = 0; ii < TM; ++ii)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[ii][jj] = 0.0f;

  const int slices = (k + kslice - 1) / kslice;
  int fill = 0;  // the ring slot the next issued slice goes to
  auto issue = [&](int s) {
    float* as = smem + fill * slice_floats;
    fill = fill + 1 == ring ? 0 : fill + 1;
    if (!copier) return;
    const int k0 = s * kslice, kn = min(kslice, k - k0);
    stage(as, lda, a, p, k, i0, bm, k0, kn, kslice, AK, P.vec_a, cid, ncp);
    stage(as + P.a_floats, ldb, b, q, k, j0, bn, k0, kn, kslice, BK, P.vec_b, cid, ncp);
  };
  for (int s = 0; s + 1 < ring; ++s) {  // ring <= slices
    issue(s);
    cp_commit();
  }
  int slot = 0;  // the ring slot of slice s
  for (int s = 0; s < slices; ++s) {
    if (s + ring - 1 < slices) issue(s + ring - 1);
    cp_commit();  // empty past the last slice: the count stays one a slice
    cp_wait_at_most(ring - 1);
    __syncthreads();
    float* as = smem + slot * slice_floats;
    const float* bs = as + P.a_floats;
    slot = slot + 1 == ring ? 0 : slot + 1;
    const int k0 = s * kslice, kn = min(kslice, k - k0);
    if (scale) {  // rn(a * w) by the stored row of a: t (a^T) or i (a)
      for (int idx = tid; idx < kn * bm; idx += blockDim.x) {
        const int t = idx / bm, ii = idx - t * bm;
        if (i0 + ii < p) {
          float* x = AK ? as + ii * lda + t : as + t * lda + ii;
          *x = __fmul_rn(*x, __ldg(scale + (P.trans_a ? k0 + t : i0 + ii)));
        }
      }
      __syncthreads();
    }
    if (active) sum_slice<TM, TN, AK, BK>(acc, as, lda, ty * TM, bs, ldb, tx * TN, kn);
    __syncthreads();  // every thread is done with the slot before it is refilled
  }
  if (!active) return;
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    const int i = i0 + ty * TM + ii;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int j = j0 + tx * TN + jj;
      if (i < p && j < q) c[static_cast<long long>(i) * q + j] = acc[ii][jj];
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void tile_product_of(const Product& P, int tile, long long z,
                                                float* smem) {
  if (P.kc_a) {
    if (P.kc_b) tile_product<TM, TN, true, true>(P, tile, z, smem);
    else tile_product<TM, TN, true, false>(P, tile, z, smem);
  } else {
    if (P.kc_b) tile_product<TM, TN, false, true>(P, tile, z, smem);
    else tile_product<TM, TN, false, false>(P, tile, z, smem);
  }
}

__global__ void __launch_bounds__(kMaxThreads) smallmm_kernel(const Group g) {
  extern __shared__ __align__(16) float smem[];
  const int x = blockIdx.x;
  Product P = g.prod[0];
#pragma unroll
  for (int i = 1; i < kMaxProducts; ++i)
    if (i < g.count && x >= g.prod[i].tile_start) P = g.prod[i];
  const int tile = x - P.tile_start;
  const long long z = blockIdx.y;
  switch (P.variant) {  // uniform over the block
    case kSkinny: tile_product_of<2, 1>(P, tile, z, smem); break;
    case kThin: tile_product_of<1, 2>(P, tile, z, smem); break;
    case kSquare: tile_product_of<4, 4>(P, tile, z, smem); break;
    default: tile_product_of<1, 1>(P, tile, z, smem); break;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

int round4(int x) { return (x + 3) / 4 * 4; }

// Fill a product's derived fields; false when its plan does not fit the
// kernel (kernels/smallmm.py::launch_plan makes plans that do).
bool prepare(Product& P, int* tiles, int* threads, int* smem) {
  if (P.p <= 0 || P.k <= 0 || P.q <= 0 || P.variant < 0 || P.variant > kVector || P.wm <= 0 ||
      P.wn <= 0 || P.wm * P.wn > kMaxThreads || P.wm * tm_of(P.variant) > kMaxTile ||
      P.wn * tn_of(P.variant) > kMaxTile) {
    return false;
  }
  const int bm = P.wm * tm_of(P.variant), bn = P.wn * tn_of(P.variant);
  const long long tiles_m = (P.p + bm - 1) / bm, tiles_n = (P.q + bn - 1) / bn;
  if (tiles_m * tiles_n + *tiles > 0x7fffffffLL) return false;
  P.tiles_n = static_cast<int>(tiles_n);
  P.tile_start = *tiles;
  // a (1, k) or (k, 1) operand is the same memory in either storage: read
  // it as a row along k
  // (a row scale is by the stored row, so a scaled a keeps its storage)
  if (P.p == 1 && P.scale == nullptr) P.trans_a = 0;
  if (P.q == 1) P.trans_b = 1;
  P.kc_a = !P.trans_a;
  P.kc_b = P.trans_b;
  P.vec_a = (P.kc_a ? P.k % 4 == 0 : P.p % 4 == 0 && bm % 4 == 0) && aligned16(P.a);
  P.vec_b = (P.kc_b ? P.k % 4 == 0 : P.q % 4 == 0 && bn % 4 == 0) && aligned16(P.b);
  // a staged row: 16-byte aligned, 4 floats past its length to spread the
  // banks
  P.kslice = P.k >= kLongFrom && P.variant != kSquare ? kLongK : kBK;
  P.lda = P.kc_a ? P.kslice + 4 : round4(bm) + 4;
  P.ldb = P.kc_b ? P.kslice + 4 : round4(bn) + 4;
  P.a_floats = P.kc_a ? bm * P.lda : P.kslice * P.lda;
  const int b_floats = P.kc_b ? bn * P.ldb : P.kslice * P.ldb;
  const int slices = (P.k + P.kslice - 1) / P.kslice;
  const int fit = kMaxSmem / (static_cast<int>(sizeof(float)) * (P.a_floats + b_floats));
  P.ring = slices < ring_of(P.variant, P.kslice) ? slices : ring_of(P.variant, P.kslice);
  if (P.ring > fit) P.ring = fit;
  *tiles += static_cast<int>(tiles_m * tiles_n);
  // the plan's threads compute; a block of at most four such warps whose
  // sum takes more than one slice gets four more that only copy
  const int need = ((P.wm * P.wn + 31) / 32) * 32;
  const int block = need <= kCopyThreads && slices > 1 ? need + kCopyThreads
                  : need < 64 ? 64 : need;
  *threads = block > *threads ? block : *threads;
  const int bytes = static_cast<int>(sizeof(float)) * P.ring * (P.a_floats + b_floats);
  *smem = bytes > *smem ? bytes : *smem;
  return true;
}

int launch(Group& g, int batch, void* stream) {
  if (g.count <= 0 || g.count > kMaxProducts || batch <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tiles = 0, threads = 0, smem = 0;
  for (int i = 0; i < g.count; ++i) {
    if (!prepare(g.prod[i], &tiles, &threads, &smem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  static bool opted_in = false;  // above 48 KB of dynamic shared memory
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        smallmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  smallmm_kernel<<<dim3(tiles, batch), threads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A group of `count` independent products over one batch (a single
// product is a group of one), each described by kFields int64 in `table`:
// a, b, c, scale (0 for none; rows of the stored a, batch x rows), p, k,
// q, trans_a, trans_b, variant, wm, wn (the last three
// kernels/smallmm.py::launch_plan's). a is batch x (p, k), or batch x
// (k, p) with trans_a; b batch x (k, q), or batch x (q, k) with trans_b;
// c batch x (p, q); all contiguous float32.
extern "C" int evox_smallmm_group(const long long* table, int count, int batch, void* stream) {
  constexpr int kFields = 12;
  if (count <= 0 || count > kMaxProducts) return static_cast<int>(cudaErrorInvalidValue);
  Group g{};
  g.count = count;
  for (int i = 0; i < count; ++i) {
    const long long* f = table + i * kFields;
    g.prod[i] = Product{reinterpret_cast<const float*>(f[0]), reinterpret_cast<const float*>(f[1]),
                        reinterpret_cast<float*>(f[2]), reinterpret_cast<const float*>(f[3]),
                        static_cast<int>(f[4]), static_cast<int>(f[5]), static_cast<int>(f[6]),
                        static_cast<int>(f[7]), static_cast<int>(f[8]), static_cast<int>(f[9]),
                        static_cast<int>(f[10]), static_cast<int>(f[11]), 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  }
  return launch(g, batch, stream);
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
