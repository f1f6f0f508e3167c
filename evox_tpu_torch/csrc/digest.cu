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
// Design: the table of leaves is a __grid_constant__ kernel parameter (no
// copy to the device). Block b takes kWordsPerBlock consecutive words of
// the leaf whose block range holds b, reads them once (16-byte loads where
// the leaf is 16-byte aligned and its words are 4 bytes wide), mixes in
// registers and reduces its six words through warp shuffles and shared
// memory into one row of the partial buffer. The last block to finish
// reduces each leaf's rows into that leaf's digest and combines the
// leaves; it is found by a counter that each launch owns (the word after
// the partial rows, zeroed on the launch's stream just before it), so
// launches on different streams, or after one that was cut short, do not
// share it. Every reduction is an exact integer one, so the result does
// not depend on the order in which blocks finish.
//
// What bounds it on an H100: the bytes. A leaf's bytes are read once
// (33.6 MB for CSO's (4096, 1024) population and velocity: ~10 us at 3.35
// TB/s); the two mixes cost ~14 integer operations a word, 1.2e8 for that
// state, a few microseconds at the card's integer rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 112;
constexpr int kThreads = 256;
constexpr int kWords = 6;
constexpr long long kWordsPerBlock = 16384;

constexpr unsigned kPhi = 0x9E3779B1u;
constexpr unsigned kMix1 = 0x85EBCA6Bu;
constexpr unsigned kMix2 = 0xC2B2AE35u;
constexpr unsigned kCh2 = 0x5BD1E995u;

// element width codes and float kinds, as kernels/digest.py writes them
enum Width : int { kW1 = 1, kW2 = 2, kW4 = 4, kW8 = 8 };
enum FloatKind : int { kNone = 0, kF16 = 1, kF32 = 2, kF64 = 3 };

struct Leaf {
  const void* ptr;
  long long n_words;
  unsigned salt;
  int block0;  // first block of this leaf
  int width;
  int fkind;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  unsigned carry[kWords];
};

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  return h;
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
  __device__ __forceinline__ void word(unsigned w, unsigned long long i, unsigned salt) {
    const unsigned base = w ^ (static_cast<unsigned>(i) * kPhi) ^ salt;
    s0 += mix32(base);
    s1 += mix32(base ^ kCh2);
    mn = min(mn, w);
    mx = max(mx, w);
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

__device__ __forceinline__ unsigned load_word(const Leaf& L, long long i) {
  switch (L.width) {
    case kW1: return static_cast<unsigned>(__ldg(static_cast<const uint8_t*>(L.ptr) + i));
    case kW2: return static_cast<unsigned>(__ldg(static_cast<const uint16_t*>(L.ptr) + i));
    default: return __ldg(static_cast<const unsigned*>(L.ptr) + i);
  }
}

// the block's six words into thread 0's accumulator
__device__ void block_reduce(Acc& a) {
  __shared__ unsigned sh[kWords][kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a.s0 += __shfl_xor_sync(0xFFFFFFFFu, a.s0, off);
    a.s1 += __shfl_xor_sync(0xFFFFFFFFu, a.s1, off);
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
      a.s1 += sh[1][w];
      a.mn = min(a.mn, sh[2][w]);
      a.mx = max(a.mx, sh[3][w]);
      a.nan += sh[4][w];
      a.inf += sh[5][w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
digest_kernel(const __grid_constant__ Table t, unsigned* __restrict__ partial,
              long long* __restrict__ leaf_out, long long* __restrict__ out,
              const long long* __restrict__ carry_dev) {
  // the leaf whose block range holds this block (block0 ascends)
  int lo = 0, hi = t.n_leaves - 1;
  const int b = static_cast<int>(blockIdx.x);
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long start = static_cast<long long>(b - L.block0) * kWordsPerBlock;
  const long long end = min(start + kWordsPerBlock, L.n_words);

  Acc a;
  a.init();
  long long scalar_from = start;
  if (L.width >= kW4 && (reinterpret_cast<uintptr_t>(L.ptr) & 15u) == 0) {
    // four words a load; start is a multiple of four
    const uint4* p4 = static_cast<const uint4*>(L.ptr);
    const long long q1 = end / 4;
    for (long long q = start / 4 + threadIdx.x; q < q1; q += kThreads) {
      const uint4 v = __ldg(p4 + q);
      const unsigned long long i = static_cast<unsigned long long>(q) * 4;
      a.word(v.x, i, L.salt);
      a.word(v.y, i + 1, L.salt);
      a.word(v.z, i + 2, L.salt);
      a.word(v.w, i + 3, L.salt);
      if (L.fkind == kF32) {
        a.f32(v.x);
        a.f32(v.y);
        a.f32(v.z);
        a.f32(v.w);
      } else if (L.fkind == kF64) {
        a.f64(v.x, v.y);
        a.f64(v.z, v.w);
      }
    }
    scalar_from = q1 * 4;
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    const unsigned w = load_word(L, i);
    a.word(w, static_cast<unsigned long long>(i), L.salt);
    if (L.fkind == kF16) {
      a.f16(w);
    } else if (L.fkind == kF32) {
      a.f32(w);
    } else if (L.fkind == kF64 && (i & 1)) {
      a.f64(load_word(L, i - 1), w);
    }
  }
  block_reduce(a);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned* row = partial + static_cast<size_t>(b) * kWords;
    row[0] = a.s0;
    row[1] = a.s1;
    row[2] = a.mn;
    row[3] = a.mx;
    row[4] = a.nan;
    row[5] = a.inf;
    __threadfence();
    unsigned* done = partial + static_cast<size_t>(gridDim.x) * kWords;
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: each leaf's rows into its digest, the leaves combined
  unsigned c0 = t.carry[0], c1 = t.carry[1], c2 = t.carry[2];
  unsigned c3 = t.carry[3], c4 = t.carry[4], c5 = t.carry[5];
  for (int l = 0; l < t.n_leaves; ++l) {
    const int r0 = t.leaf[l].block0;
    const int r1 = l + 1 < t.n_leaves ? t.leaf[l + 1].block0 : static_cast<int>(gridDim.x);
    Acc r;
    r.init();
    for (int row = r0 + threadIdx.x; row < r1; row += kThreads) {
      const unsigned* p = partial + static_cast<size_t>(row) * kWords;
      r.s0 += __ldcg(p + 0);
      r.s1 += __ldcg(p + 1);
      r.mn = min(r.mn, __ldcg(p + 2));
      r.mx = max(r.mx, __ldcg(p + 3));
      r.nan += __ldcg(p + 4);
      r.inf += __ldcg(p + 5);
    }
    block_reduce(r);
    if (threadIdx.x == 0) {
      long long* d = leaf_out + static_cast<size_t>(l) * kWords;
      d[0] = r.s0;
      d[1] = r.s1;
      d[2] = r.mn;
      d[3] = r.mx;
      d[4] = r.nan;
      d[5] = r.inf;
      c0 += r.s0;
      c1 ^= r.s1;
      c2 = min(c2, r.mn);
      c3 = max(c3, r.mx);
      c4 += r.nan;
      c5 += r.inf;
    }
  }
  if (threadIdx.x == 0) {
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

// rows: n_leaves x 6 int64 (ptr, n_words, salt, block0, width, fkind),
// carry: 6 uint32 host words; partial: n_blocks x 6 + 1 uint32 scratch
// (the last word is the launch's block counter);
// leaf_out: n_leaves x 6 int64; out: 6 int64; carry_dev: 6 int64 or null.
extern "C" int evox_state_digest(const long long* rows, int n_leaves, const unsigned* carry,
                                 int n_blocks, void* partial, void* leaf_out, void* out,
                                 const void* carry_dev, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  t.n_leaves = n_leaves;
  int expect = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* r = rows + 6 * l;
    const int width = static_cast<int>(r[4]);
    if (r[1] <= 0 || r[3] != expect || !(width == 1 || width == 2 || width == 4 || width == 8) ||
        r[5] < 0 || r[5] > 3) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.leaf[l].ptr = reinterpret_cast<const void*>(r[0]);
    t.leaf[l].n_words = r[1];
    t.leaf[l].salt = static_cast<unsigned>(r[2]);
    t.leaf[l].block0 = static_cast<int>(r[3]);
    t.leaf[l].width = width;
    t.leaf[l].fkind = static_cast<int>(r[5]);
    expect += static_cast<int>((r[1] + kWordsPerBlock - 1) / kWordsPerBlock);
  }
  if (expect != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kWords; ++k) t.carry[k] = carry[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* done = static_cast<unsigned*>(partial) + static_cast<size_t>(n_blocks) * kWords;
  const cudaError_t zeroed = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  digest_kernel<<<n_blocks, kThreads, 0, s>>>(
      t, static_cast<unsigned*>(partial), static_cast<long long*>(leaf_out),
      static_cast<long long*>(out), static_cast<const long long*>(carry_dev));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int evox_digest_words_per_block() { return static_cast<int>(kWordsPerBlock); }

extern "C" int evox_digest_max_leaves() { return kMaxLeaves; }

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
