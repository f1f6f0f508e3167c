// State digest for Hopper (sm_90a): D1.
//
// Replaces no Pallas kernel. The JAX package's device digest
// (evox_tpu/core/attest.py::state_digest) is plain jnp that XLA fuses into
// one pass over each leaf; the port's eager composition of the same words
// takes ~20 operators a leaf over int64 lanes, so the digest gets this
// kernel beside its plain version (evox_tpu_torch/kernels/digest.py).
//
// For every tensor leaf of a state, one launch computes the six words of
// core/attest.py:
//   [ wrapping-sum(mix(w ^ i*PHI ^ salt)), wrapping-sum(mix(w ^ i*PHI ^
//     salt ^ CH2)), min(w), max(w), nan_count, inf_count ]
// over the leaf's canonical uint32 word stream w (1-byte elements and bool
// zero-extended from uint8, 2-byte ones from uint16, 4-byte ones bit-cast,
// 8-byte ones split into their two little-endian uint32 halves), i the
// flat word index, mix the murmur3 finalizer; and the combination across
// leaves (words 0, 4, 5 by wrapping sum, word 1 by XOR, 2 by min, 3 by max),
// folded with six carry words the wrapper computed on the host (seed
// leaves and empty leaves) and, when given, with a device carry (the
// previous launch's combination, when a state has more leaves than a
// table holds). NaN and inf are counted per element on float16, float32
// and float64 leaves; bfloat16 leaves count none, as the host digest.
//
// A table entry is a leaf or a block of one: a leaf held resident on a
// mesh (core/distributed.py's ShardedTensor) enters as its blocks, each
// with the flat index of its first word (carried as p0 = i0 * PHI, so its
// word j mixes (i0 + j) PHI) and the slot of the leaf it belongs to.
// Entries of one slot fold into that slot's accumulators by the leaf's own
// reductions, so a resident leaf's words equal its gathered leaf's.
//
// Design: the table of leaves is a __grid_constant__ kernel parameter (no
// copy to the device). The leaves' words are cut into chunks of kChunk
// words (a leaf's last chunk may be short), numbered leaf after leaf, and
// a grid of whole waves (blocks an SM x SMs, fewer when there are fewer
// chunks) takes them: block b the contiguous chunks [b C / G, (b + 1) C /
// G) of the C chunks, so no block takes more than one chunk over another
// and no SM an extra block. A block walks the leaves its chunks cross; on
// each leaf's part its threads stride over 16-byte loads (where the leaf
// is 16-byte aligned and its words are 4 bytes wide; else word by word),
// kUnroll loads a thread at a time, the next kUnroll issued before the
// current ones are mixed, so the loads are in flight under the integer
// work. The index product is carried as an add (word 4q + j of a load
// takes (4q) PHI + j PHI), the second mix's first step is the first's
// XORed with a constant (mix(x ^ CH2) starts from h ^ (CH2 ^ CH2 >> 16)
// where h = x ^ x >> 16), min and max take two words a step, and a float32
// load is tested for NaN and inf by one compare of the sum of its four
// magnitudes (NaN or +inf when one is), the exact counts taken only where
// that sum is not finite. A block reduces its part of a leaf through
// warp shuffles and shared memory and folds it into that leaf's six
// accumulators with atomics (wrapping add, min, max). The last block to
// finish, found by a counter, reads each leaf's accumulators into its
// digest, combines the leaves and the carries, and leaves the scratch as
// it found it: atomicExch puts each accumulator back to its identity, and
// the counter, advanced by atomicInc with the grid's size, wraps to 0 with
// the last block. So the scratch (one a stream, zeroed once when the
// wrapper makes it) needs no zeroing before a launch, and launches on two
// streams, each with its own scratch, do not share it. Every reduction is
// an exact integer one, so the result does not depend on the order in
// which blocks finish.
//
// What bounds it on an H100: the bytes and the integer issue, about
// equally. A leaf's bytes are read once (33.6 MB for CSO's (4096, 1024)
// population and velocity: 10.0 us at 3.35 TB/s). The function needs
// about 20 integer operations a word (kernels/digest.py's
// DIGEST_OPERATIONS_PER_WORD: the index add, the salted word, the shared
// first step, two finishes of two multiplies, two shifts and two xors,
// the second's constant, the two sums, min and max), and the card issues
// them at 64 a clock an SM: 8.4M words x 20 / (132 x 64 x 1.98 GHz) = 10.0
// us. So the pass keeps loads in flight while it mixes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernels/digest.py's MAX_LEAVES, THREADS, BLOCKS_PER_SM and CHUNK_WORDS
constexpr int kMaxLeaves = 112;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 1024 threads an SM, 64 registers
constexpr int kWords = 6;
constexpr long long kChunk = 1024;  // words a chunk
constexpr int kUnroll = 4;          // 16-byte loads a thread, twice that in flight

constexpr unsigned kPhi = 0x9E3779B1u;
constexpr unsigned kMix1 = 0x85EBCA6Bu;
constexpr unsigned kMix2 = 0xC2B2AE35u;
constexpr unsigned kCh2 = 0x5BD1E995u;
// mix(x ^ CH2)'s first step, given h = x ^ (x >> 16): h ^ kH2
constexpr unsigned kH2 = kCh2 ^ (kCh2 >> 16);

// element width codes and float kinds, as kernels/digest.py writes them
enum Width : int { kW1 = 1, kW2 = 2, kW4 = 4, kW8 = 8 };
enum FloatKind : int { kNone = 0, kF16 = 1, kF32 = 2, kF64 = 3 };

struct Leaf {
  const void* ptr;
  long long n_words;
  unsigned salt;
  int chunk0;       // first chunk of this entry
  unsigned p0;      // the flat index of its first word, times PHI
  short slot;       // the leaf (accumulator row) it folds into
  signed char width;
  signed char fkind;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;  // entries
  int n_slots;   // leaves
  int n_chunks;
  unsigned carry[kWords];
};

// the murmur3 finalizer after its first step (h = x ^ x >> 16)
__device__ __forceinline__ unsigned finish(unsigned h) {
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  return h ^ (h >> 16);
}

struct Acc {
  unsigned s0, s1, mn, mx, nan, inf;
  __device__ void init() {
    s0 = 0u;
    s1 = 0u;
    mn = 0xFFFFFFFFu;
    mx = 0u;
    nan = 0u;
    inf = 0u;
  }
  // the two mixes of word w at flat index i, p = i * PHI (mod 2^32)
  __device__ __forceinline__ void word(unsigned w, unsigned p, unsigned salt) {
    const unsigned x = w ^ p ^ salt;
    const unsigned h = x ^ (x >> 16);
    s0 += finish(h);
    s1 += finish(h ^ kH2);
  }
  __device__ __forceinline__ void f16(unsigned w) {
    if ((w & 0x7C00u) == 0x7C00u) {
      if (w & 0x3FFu) ++nan; else ++inf;
    }
  }
  __device__ __forceinline__ void f32(unsigned w) {
    if ((w & 0x7F800000u) == 0x7F800000u) {
      if (w & 0x7FFFFFu) ++nan; else ++inf;
    }
  }
  __device__ __forceinline__ void f64(unsigned lo, unsigned hi) {
    if ((hi & 0x7FF00000u) == 0x7FF00000u) {
      if ((hi & 0xFFFFFu) | lo) ++nan; else ++inf;
    }
  }
};

// the four words of 16-byte load q, p = (4q) PHI; min and max as two
// three-way steps
template <int FKIND>
__device__ __forceinline__ void quad(Acc& a, const uint4& v, unsigned p, unsigned salt) {
  a.word(v.x, p, salt);
  a.word(v.y, p + kPhi, salt);
  a.word(v.z, p + 2u * kPhi, salt);
  a.word(v.w, p + 3u * kPhi, salt);
  a.mn = min(a.mn, min(v.x, v.y));
  a.mn = min(a.mn, min(v.z, v.w));
  a.mx = max(a.mx, max(v.x, v.y));
  a.mx = max(a.mx, max(v.z, v.w));
  if (FKIND == kF32) {
    // NaN or +-inf among the four: the sum of their magnitudes is NaN or
    // +inf (or overflows, a false alarm the exact counts below sort out)
    const float s = fabsf(__uint_as_float(v.x)) + fabsf(__uint_as_float(v.y)) +
                    fabsf(__uint_as_float(v.z)) + fabsf(__uint_as_float(v.w));
    if (!(s < __uint_as_float(0x7F800000u))) {
      a.f32(v.x);
      a.f32(v.y);
      a.f32(v.z);
      a.f32(v.w);
    }
  } else if (FKIND == kF64) {
    a.f64(v.x, v.y);
    a.f64(v.z, v.w);
  }
}

// the loads [q0, q1) of p4: thread t takes loads q0 + t + k kThreads, in
// groups of kUnroll with the next group in flight while the current one
// is mixed (no bound checks inside a whole group); the last, partial group
// is issued with the last whole one, so no load waits alone; p0 is the
// entry's first word index times PHI
template <int FKIND>
__device__ void vector_part(Acc& a, const uint4* __restrict__ p4, long long q0, long long q1,
                            unsigned salt, unsigned p0) {
  const long long first = q0 + threadIdx.x;
  if (first >= q1) return;
  const unsigned n = static_cast<unsigned>((q1 - first + kThreads - 1) / kThreads);
  const unsigned groups = n / kUnroll, rest = n % kUnroll;
  const uint4* p = p4 + first;
  unsigned pp = p0 + static_cast<unsigned>(first) * (4u * kPhi);  // (i0 + 4q) PHI of the next load
  constexpr unsigned kNext = 4u * kPhi * kThreads;          // from a load to the next
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 cur[kUnroll], tail[kUnroll - 1];
  if (groups) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = __ldg(p + u * kThreads);
    for (unsigned g = 1; g < groups; ++g) {
      uint4 nxt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) nxt[u] = __ldg(p + (kUnroll + u) * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) quad<FKIND>(a, cur[u], pp + u * kNext, salt);
      p += kUnroll * kThreads;
      pp += kUnroll * kNext;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
  }
  // the partial group's loads, then the last whole group and the partial one
  const uint4* pt = p + (groups ? kUnroll * kThreads : 0);
#pragma unroll
  for (int u = 0; u < kUnroll - 1; ++u) {
    tail[u] = u < static_cast<int>(rest) ? __ldg(pt + u * kThreads) : zero;
  }
  if (groups) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) quad<FKIND>(a, cur[u], pp + u * kNext, salt);
    pp += kUnroll * kNext;
  }
#pragma unroll
  for (int u = 0; u < kUnroll - 1; ++u) {
    if (u < static_cast<int>(rest)) quad<FKIND>(a, tail[u], pp + u * kNext, salt);
  }
}

__device__ __forceinline__ unsigned load_word(const Leaf& L, long long i) {
  switch (L.width) {
    case kW1: return static_cast<unsigned>(__ldg(static_cast<const uint8_t*>(L.ptr) + i));
    case kW2: return static_cast<unsigned>(__ldg(static_cast<const uint16_t*>(L.ptr) + i));
    default: return __ldg(static_cast<const unsigned*>(L.ptr) + i);
  }
}

// words [i0, i1) of a leaf, one a thread at a time (1- and 2-byte elements,
// leaves not 16-byte aligned, a leaf's last words); i0 is even, so an
// 8-byte element's two words fall to one range
__device__ void scalar_part(Acc& a, const Leaf& L, long long i0, long long i1) {
  for (long long i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const unsigned w = load_word(L, i);
    a.word(w, L.p0 + static_cast<unsigned>(i) * kPhi, L.salt);
    a.mn = min(a.mn, w);
    a.mx = max(a.mx, w);
    if (L.fkind == kF16) {
      a.f16(w);
    } else if (L.fkind == kF32) {
      a.f32(w);
    } else if (L.fkind == kF64 && (i & 1)) {
      a.f64(load_word(L, i - 1), w);
    }
  }
}

// the block's six words into thread 0's accumulator; word 1 by XOR when
// combining leaves, by wrapping sum within one
template <bool kXor>
__device__ void block_reduce(Acc& a) {
  __shared__ unsigned sh[kWords][kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a.s0 += __shfl_xor_sync(0xFFFFFFFFu, a.s0, off);
    const unsigned s1 = __shfl_xor_sync(0xFFFFFFFFu, a.s1, off);
    a.s1 = kXor ? a.s1 ^ s1 : a.s1 + s1;
    a.mn = min(a.mn, __shfl_xor_sync(0xFFFFFFFFu, a.mn, off));
    a.mx = max(a.mx, __shfl_xor_sync(0xFFFFFFFFu, a.mx, off));
    a.nan += __shfl_xor_sync(0xFFFFFFFFu, a.nan, off);
    a.inf += __shfl_xor_sync(0xFFFFFFFFu, a.inf, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = a.s0;
    sh[1][warp] = a.s1;
    sh[2][warp] = a.mn;
    sh[3][warp] = a.mx;
    sh[4][warp] = a.nan;
    sh[5][warp] = a.inf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      a.s0 += sh[0][w];
      a.s1 = kXor ? a.s1 ^ sh[1][w] : a.s1 + sh[1][w];
      a.mn = min(a.mn, sh[2][w]);
      a.mx = max(a.mx, sh[3][w]);
      a.nan += sh[4][w];
      a.inf += sh[5][w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
digest_kernel(const __grid_constant__ Table t, unsigned* __restrict__ scratch,
              long long* __restrict__ leaf_out, long long* __restrict__ out,
              const long long* __restrict__ carry_dev) {
  // this block's chunks [c_lo, c_hi) and the leaf holding c_lo (chunk0
  // ascends)
  const long long C = t.n_chunks, G = gridDim.x, b = blockIdx.x;
  const long long c_lo = b * C / G, c_hi = (b + 1) * C / G;
  int l = 0, hi = t.n_leaves - 1;
  while (l < hi) {
    const int mid = (l + hi + 1) / 2;
    if (t.leaf[mid].chunk0 <= c_lo) l = mid; else hi = mid - 1;
  }
  for (; l < t.n_leaves && t.leaf[l].chunk0 < c_hi; ++l) {
    const Leaf& L = t.leaf[l];
    const long long chunks = (L.n_words + kChunk - 1) / kChunk;
    const long long w0 = (max(c_lo, static_cast<long long>(L.chunk0)) - L.chunk0) * kChunk;
    const long long w1 = min(min(c_hi - L.chunk0, chunks) * kChunk, L.n_words);
    Acc a;
    a.init();
    long long from = w0;
    if (L.width >= kW4 && (reinterpret_cast<uintptr_t>(L.ptr) & 15u) == 0) {
      // four words a load; w0 is a multiple of four
      const uint4* p4 = static_cast<const uint4*>(L.ptr);
      const long long q0 = w0 / 4, q1 = w1 / 4;
      if (L.fkind == kF32) {
        vector_part<kF32>(a, p4, q0, q1, L.salt, L.p0);
      } else if (L.fkind == kF64) {
        vector_part<kF64>(a, p4, q0, q1, L.salt, L.p0);
      } else {
        vector_part<kNone>(a, p4, q0, q1, L.salt, L.p0);
      }
      from = q1 * 4;
    }
    scalar_part(a, L, from, w1);
    block_reduce<false>(a);
    if (threadIdx.x == 0) {
      unsigned* acc = scratch + static_cast<size_t>(L.slot) * kWords;
      atomicAdd(acc + 0, a.s0);
      atomicAdd(acc + 1, a.s1);
      atomicMin(acc + 2, a.mn);
      atomicMax(acc + 3, a.mx);
      if (a.nan) atomicAdd(acc + 4, a.nan);
      if (a.inf) atomicAdd(acc + 5, a.inf);
    }
  }

  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    // wraps to 0 with the grid's last block
    unsigned* counter = scratch + static_cast<size_t>(kMaxLeaves) * kWords;
    last = atomicInc(counter, static_cast<unsigned>(gridDim.x - 1)) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: thread l takes slot l's accumulators into its leaf's
  // digest and puts them back to their identity; the leaves combined
  Acc r;
  r.init();
  if (threadIdx.x < t.n_slots) {
    unsigned* acc = scratch + static_cast<size_t>(threadIdx.x) * kWords;
    r.s0 = atomicExch(acc + 0, 0u);
    r.s1 = atomicExch(acc + 1, 0u);
    r.mn = atomicExch(acc + 2, 0xFFFFFFFFu);
    r.mx = atomicExch(acc + 3, 0u);
    r.nan = atomicExch(acc + 4, 0u);
    r.inf = atomicExch(acc + 5, 0u);
    long long* d = leaf_out + static_cast<size_t>(threadIdx.x) * kWords;
    d[0] = r.s0;
    d[1] = r.s1;
    d[2] = r.mn;
    d[3] = r.mx;
    d[4] = r.nan;
    d[5] = r.inf;
  }
  block_reduce<true>(r);
  if (threadIdx.x == 0) {
    unsigned c0 = r.s0 + t.carry[0], c1 = r.s1 ^ t.carry[1], c2 = min(r.mn, t.carry[2]);
    unsigned c3 = max(r.mx, t.carry[3]), c4 = r.nan + t.carry[4], c5 = r.inf + t.carry[5];
    if (carry_dev != nullptr) {
      c0 += static_cast<unsigned>(carry_dev[0]);
      c1 ^= static_cast<unsigned>(carry_dev[1]);
      c2 = min(c2, static_cast<unsigned>(carry_dev[2]));
      c3 = max(c3, static_cast<unsigned>(carry_dev[3]));
      c4 += static_cast<unsigned>(carry_dev[4]);
      c5 += static_cast<unsigned>(carry_dev[5]);
    }
    out[0] = c0;
    out[1] = c1;
    out[2] = c2;
    out[3] = c3;
    out[4] = c4;
    out[5] = c5;
  }
}

}  // namespace

// rows: n_leaves x 8 int64 (ptr, n_words, salt, chunk0, width, fkind, p0,
// slot): the table's entries, their slots 0 .. n_slots - 1 in order;
// carry: 6 uint32 host words; n_chunks: the entries' chunks; blocks: the
// grid (1 <= blocks <= n_chunks; kernels/digest.py::digest_plan); scratch:
// the stream's kMaxLeaves x 6 + 1 uint32 accumulators and counter, at
// their identity (each launch leaves them so); leaf_out: n_slots x 6
// int64; out: 6 int64; carry_dev: 6 int64 or null.
extern "C" int evox_state_digest(const long long* rows, int n_leaves, int n_slots,
                                 const unsigned* carry, int n_chunks, int blocks, void* scratch,
                                 void* leaf_out, void* out, const void* carry_dev, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_slots <= 0 || n_slots > n_leaves ||
      n_chunks <= 0 || blocks <= 0 || blocks > n_chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  t.n_leaves = n_leaves;
  t.n_slots = n_slots;
  t.n_chunks = n_chunks;
  long long expect = 0;
  long long slot = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* r = rows + 8 * l;
    const int width = static_cast<int>(r[4]);
    if (r[1] <= 0 || r[3] != expect || !(width == 1 || width == 2 || width == 4 || width == 8) ||
        r[5] < 0 || r[5] > 3 || r[6] < 0 || r[6] > 0xFFFFFFFFll ||
        !(r[7] == slot || r[7] == slot + 1) || (l == 0 && r[7] != 0) || r[7] >= n_slots) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    slot = r[7];
    t.leaf[l].ptr = reinterpret_cast<const void*>(r[0]);
    t.leaf[l].n_words = r[1];
    t.leaf[l].salt = static_cast<unsigned>(r[2]);
    t.leaf[l].chunk0 = static_cast<int>(r[3]);
    t.leaf[l].p0 = static_cast<unsigned>(r[6]);
    t.leaf[l].slot = static_cast<short>(r[7]);
    t.leaf[l].width = static_cast<signed char>(width);
    t.leaf[l].fkind = static_cast<signed char>(r[5]);
    expect += (r[1] + kChunk - 1) / kChunk;
  }
  if (slot != n_slots - 1) return static_cast<int>(cudaErrorInvalidValue);
  if (expect != n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kWords; ++k) t.carry[k] = carry[k];
  digest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<unsigned*>(scratch), static_cast<long long*>(leaf_out),
      static_cast<long long*>(out), static_cast<const long long*>(carry_dev));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int evox_digest_chunk_words() { return static_cast<int>(kChunk); }

extern "C" int evox_digest_max_leaves() { return kMaxLeaves; }

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
