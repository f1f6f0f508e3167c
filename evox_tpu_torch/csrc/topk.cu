// Exact partial top-k (the k smallest) of a float32 vector, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel evox_tpu/kernels/topk.py::partial_topk
// (pallas_call at :185; body _topk_block_kernel :90). For values (n,) and
// 1 <= k <= n it writes the k smallest values, ascending, and their int32
// indices, with the tie law of lax.top_k(-values, k): values ordered by
// IEEE totalOrder on their bits (-NaN < -inf < ... < -0.0 < +0.0 < ... <
// +inf < +NaN, NaNs by payload), equal bits by lowest index.
//
// Keys. Each value's bits become an order-preserving uint32 key u (sign
// set: all bits flipped; sign clear: the sign bit set), so unsigned order
// is totalOrder, and the index rides along as payload. A value is written
// back from its key's bits, so NaN payloads and signed zeros survive.
//
// Design: a radix select, a stable compaction and a stable radix sort of
// the kept keys below the threshold. O(n) work to select and O(k) to sort,
// in place of the TPU kernel's O(n^2) comparison counting.
//   1. Select. MSD digit passes of 11, 11 and 10 bits find a key prefix P
//      (the high bits of the threshold key): `less` keys lie below P and
//      `need = k - less` of the keys with prefix P (the bucket) are kept. A
//      pass histograms the digit below the current prefix of the keys that
//      carry it (plain shared-memory atomicAdd: on Hopper a warp's adds to
//      one address cost about what adds to many do, so a bucket that holds
//      most keys, the +inf rows of NSGA-II's cut key, needs no warp
//      aggregation) and takes the bucket where the running count crosses
//      `need`. The passes stop once the bucket is taken whole, or once the
//      keys a pass counted were all one key (their OR and the OR of their
//      complements agree), which completes the threshold: the cut key's
//      +inf bucket stops the select after two passes, an all-equal input
//      after one. With k == n nothing is selected.
//   2. Compact. The keys below P go to [0, less) and the first `need` of
//      the bucket to [less, k), each in index order: threads (or tiles)
//      own contiguous index ranges, and exclusive scans of their counts
//      place them. No slot is claimed by an atomic, so the order never
//      depends on timing.
//   3. Sort. When the threshold is complete, the kept bucket keys all
//      equal it and follow every other kept key, in index order already,
//      so only [0, less) is sorted (2569 of the main path's 10000);
//      otherwise all k. A stable LSD radix sort on the key alone: equal
//      digits keep their order in every pass, so equal keys keep index
//      order, the tie law. The one-block sort takes 4-bit digits, a 16-bit
//      counter a digit a thread (thread t owns a contiguous range), skips
//      the digits in which the OR and the AND of all keys agree, and runs
//      on 64, 256 or 1024 threads (a named barrier for the group) by the
//      number of keys, since a pass's fixed cost grows with the threads.
//      The grid sort takes 8-bit digits over tiles of 4096: tile counts
//      scanned digit-major and tile-minor, each tile ranked in shared
//      memory by digit (per-warp counters, eight ballots find a lane's
//      equal digits) and written out in runs.
//
// Routes (kernels/topk.py::launch_plan chooses; the plan is passed in):
//   small (0): one block, one launch, no scratch: 256 threads up to n =
//     kSmallN, else 1024. The keys (n words, while k < n) and two buffers
//     of kept keys and indices (2k words each) live in dynamic shared
//     memory: max(n + 2k [k < n], 4k) <= kSmallWords (192 KB). Over a
//     (rows, n) input it is one launch of a grid of `rows` such blocks,
//     block b on row b (evox_partial_topk_small_rows), as vmap of the JAX
//     kernel gives one kernel with a grid over the rows; each block's
//     shared memory and work are the 1-D route's.
//   large (1, 2): a memset of the control header, three grid-wide select
//     passes (each block histograms its share, the last block to finish
//     chooses the bucket; a finished select makes the later passes return
//     at once), a count and a scatter kernel for the stable compaction
//     (the last block of the count scans the tile totals), then the sort:
//     route 1 (4k <= kSmallWords) in one block of shared memory; route 2
//     four passes of count, scan and scatter (the compaction's digit
//     histograms of the keys to sort decide the skipped passes and where
//     each pass reads and writes; the last writes the output) and a kernel
//     that writes the kept bucket keys. Over a (rows, n) input the wrapper
//     queues this sequence once a row (a batched large route is left for
//     later: ROADMAP B4).
// Scratch (control header, tile totals, kept-key buffers, tile counts) is
// one int32 buffer that the wrapper allocates; the kernels allocate
// nothing. Element offsets are int; byte offsets are formed by pointer
// arithmetic, which widens them, so n up to 2^31 - 1 stays exact.
//
// What bounds it on an H100. Bytes: read n floats, write k values and k
// indices. The large route reads the input up to five times (three select
// passes, two compaction passes; L2 holds it below ~50 MB) and moves the
// sorted keys about 4 * 20 bytes each when they need every sort pass. At
// the sizes of the main path (n 20000) latency, not bytes, is the floor:
// one block on one SM runs some 40 barrier-separated phases, each a few
// hundred cycles at least (PERF.md §7 has the split).
//
// C interface (loaded with ctypes): evox_partial_topk returns
// cudaGetLastError() after the launches; 0 means launched.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoDigit = 0xffffffffu;  // lanes past the end, or not in the bucket

constexpr int kSelPasses = 3;
constexpr int kSelBins = 2048;
__host__ __device__ constexpr int sel_shift(int p) { return p == 0 ? 21 : p == 1 ? 10 : 0; }
__host__ __device__ constexpr int sel_bits(int p) { return p == 2 ? 10 : 11; }
constexpr int kSortPasses = 4;
constexpr int kSortBins = 256;

// One block does the small route and route 1's sort: 1024 threads, or 256
// for n <= kSmallN (fewer warps make each barrier-separated phase cheaper,
// and a small input has little to spread).
constexpr int kSmallWords = 49152;  // 192 KB of keys and survivor pairs
constexpr int kSmallN = 4096;
// The one-block sort: 4-bit digits, a 16-bit counter a digit a thread
// (every count and offset is below kSmallWords / 4).
constexpr int kBlockDigitBits = 4;
constexpr int kBlockDigits = 1 << kBlockDigitBits;
constexpr int kBlockPasses = 32 / kBlockDigitBits;
__host__ __device__ constexpr int counter_words(int T) { return kBlockDigits * T / 2; }
// the small route's counters: the sort's, or the select's bins
__host__ __device__ constexpr int small_counter_words(int T) {
  return counter_words(T) > kSelBins ? counter_words(T) : kSelBins;
}

constexpr int kSelThreads = 512;
constexpr int kSelUnroll = 8;
constexpr int kCompactThreads = 512;
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kCompactThreads * kCompactItems;  // 4096
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;  // 4096
constexpr int kScanThreads = 1024;

// The large route's control header, at the start of the scratch buffer
// (zeroed by the memset that opens the call), then the select histograms
// and the survivors' sort histograms.
struct Control {
  unsigned mask, bits;  // the boundary bucket: (u & mask) == bits
  int less, done;       // keys below the bucket; 1 once the select is over
  unsigned sel_ticket[kSelPasses];
  // OR of the keys each select pass counts, and OR of their complements
  unsigned sel_any[kSelPasses], sel_any_inv[kSelPasses];
  unsigned compact_ticket[2];
  int skip[kSortPasses], src[kSortPasses];
  int last, ran;  // the last sort pass that moves data; 1 if any does
  int pad[64 - 2 - 2 - 3 * kSelPasses - 2 - 2 * kSortPasses - 2];
};
static_assert(sizeof(Control) == 64 * 4, "control header is 64 words");
constexpr long long kCtlWords = 64 + kSelPasses * kSelBins + kSortPasses * kSortBins;

// The large route's sort range: with a complete threshold key the kept
// bucket keys equal it and follow every other kept key, in index order
// already, so only the `less` keys below it are sorted.
__device__ __forceinline__ int sort_range(const Control* ctl, int k) {
  return ctl->mask == kFull ? ctl->less : k;
}

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the float bits back from a key
__device__ __forceinline__ unsigned value_bits(unsigned u) {
  return (u & 0x80000000u) ? (u ^ 0x80000000u) : ~u;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose 8-bit digit d equals this lane's, among the
// live lanes (a lane that is not live gets garbage): one ballot a bit, in
// place of the far slower __match_any_sync.
__device__ __forceinline__ unsigned match8(unsigned d, bool live) {
  unsigned m = __ballot_sync(kFull, live);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// A barrier of the whole block, or (kGroup) of its first T threads only
// (named barrier 1), so a few warps can sort while the others wait.
template <int T, bool kGroup>
__device__ __forceinline__ void barrier() {
  if constexpr (kGroup) {
    asm volatile("bar.sync 1, %0;" ::"n"(T) : "memory");
  } else {
    __syncthreads();
  }
}

// Exclusive prefix sum over a block (or group) of T threads; *total gets
// the sum. sm holds 33 ints. Every thread of the block (group) calls it.
template <int T, bool kGroup = false>
__device__ int block_exclusive_scan(int v, int* total, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm[warp] = x;
  barrier<T, kGroup>();
  if (warp == 0) {
    const int w = lane < T / 32 ? sm[lane] : 0;
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sm[lane] = s - w;
    if (lane == 31) sm[32] = s;
  }
  barrier<T, kGroup>();
  const int excl = sm[warp] + x - v;
  *total = sm[32];
  barrier<T, kGroup>();
  return excl;
}

// The bucket of hist (nbins <= kSelBins) where the running count crosses
// need, by a block of T threads: returns the digit and the count below it
// in *below, to every thread.
template <int T>
__device__ int choose_bucket(const unsigned* hist, int nbins, int need, int* below, int* sm) {
  constexpr int kPer = kSelBins / T;
  __shared__ int found[2];
  unsigned h[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = threadIdx.x * kPer + j;
    h[j] = b < nbins ? hist[b] : 0u;
    sum += static_cast<int>(h[j]);
  }
  int total;
  int run = block_exclusive_scan<T>(sum, &total, sm);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (run < need && need <= run + static_cast<int>(h[j])) {
      found[0] = threadIdx.x * kPer + j;
      found[1] = run;
    }
    run += static_cast<int>(h[j]);
  }
  __syncthreads();
  *below = found[1];
  const int d = found[0];
  __syncthreads();
  return d;
}

// The select state after a pass that chose digit d with `below` keys of the
// bucket under it; done when the chosen bucket is taken whole or the key is
// complete. When every key the pass counted was the same (one_key: their
// OR and AND agree), that key is the threshold.
__device__ __forceinline__ void advance(unsigned& mask, unsigned& bits, int& less, int& done, int p,
                                        int d, int below, unsigned count_d, bool one_key,
                                        unsigned key, int k) {
  const unsigned dmask = (1u << sel_bits(p)) - 1u;
  const int need = k - less;
  mask |= dmask << sel_shift(p);
  bits |= static_cast<unsigned>(d) << sel_shift(p);
  less += below;
  if (one_key) {
    mask = kFull;
    bits = key;
  }
  done = (need - below == static_cast<int>(count_d)) || mask == kFull;
}

// One pass of block_sort over digit `shift`. Kept out of line and free of
// unrolled copies: a one-block call runs each pass's code once.
template <int T>
__device__ __noinline__ void block_sort_pass(const unsigned* __restrict__ src_key,
                                             const int* __restrict__ src_idx,
                                             unsigned* __restrict__ dst_key,
                                             int* __restrict__ dst_idx, int m, int shift,
                                             unsigned* __restrict__ counters, int* sm) {
  unsigned short* ctr = reinterpret_cast<unsigned short*>(counters);  // ctr[d * T + t]
  const int t = threadIdx.x;
  // an odd count of keys a thread: the threads of a warp read different banks
  const int it = ((m + T - 1) / T) | 1;
  const int j0 = min(t * it, m), j1 = min(j0 + it, m);
  for (int c = t; c < counter_words(T) / 4; c += T)
    reinterpret_cast<uint4*>(counters)[c] = make_uint4(0u, 0u, 0u, 0u);
  barrier<T, true>();
  for (int j = j0; j < j1; ++j) ++ctr[((src_key[j] >> shift) & (kBlockDigits - 1)) * T + t];
  barrier<T, true>();
  // thread t scans counters [16t, 16t + 16) of the digit-major order
  uint4* mine = reinterpret_cast<uint4*>(counters) + 2 * t;
  uint4 w[2] = {mine[0], mine[1]};
  unsigned* h = reinterpret_cast<unsigned*>(w);
  int sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) sum += static_cast<int>((h[e] & 0xffffu) + (h[e] >> 16));
  int total;
  int run = block_exclusive_scan<T, true>(sum, &total, sm);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned lo = static_cast<unsigned>(run);
    run += static_cast<int>(h[e] & 0xffffu);
    const unsigned hi = static_cast<unsigned>(run);
    run += static_cast<int>(h[e] >> 16);
    h[e] = lo | (hi << 16);
  }
  mine[0] = w[0];
  mine[1] = w[1];
  barrier<T, true>();
  // each key to its digit's offset for this thread, then one further
  for (int j = j0; j < j1; ++j) {
    const unsigned u = src_key[j];
    unsigned short* c = ctr + ((u >> shift) & (kBlockDigits - 1)) * T + t;
    const int pos = *c;
    *c = static_cast<unsigned short>(pos + 1);
    dst_key[pos] = u;
    dst_idx[pos] = src_idx[j];
  }
  barrier<T, true>();
}

// Stable LSD radix sort of the first m <= kSmallWords / 4 (key, index)
// pairs of buffer a, by the first T threads of the block (they alone call
// it), between a and b (distinct buffers of shared memory); returns true
// when the sorted pairs end in b.
// counters: counter_words(T) words of shared memory, 16-byte aligned.
// Thread t owns a contiguous range of keys and a 16-bit counter a digit; a
// pass counts its keys' digits, scans the counters digit-major and
// thread-minor, and sends each key, in index order, to its thread's next
// slot for its digit: equal digits keep index order. A digit that no two
// keys differ in (OR and AND of all m keys agree there) is no pass.
template <int T>
__device__ bool block_sort(unsigned* a_key, int* a_idx, unsigned* b_key, int* b_idx, int m,
                           unsigned* counters, int* sm) {
  __shared__ unsigned any_s, all_s;
  if (m <= 1) return false;
  if (threadIdx.x == 0) {
    any_s = 0u;
    all_s = kFull;
  }
  barrier<T, true>();
  unsigned any = 0u, all = kFull;
  for (int j = threadIdx.x; j < m; j += T) {
    any |= a_key[j];
    all &= a_key[j];
  }
  any = __reduce_or_sync(kFull, any);
  all = __reduce_and_sync(kFull, all);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&any_s, any);
    atomicAnd(&all_s, all);
  }
  barrier<T, true>();
  const unsigned vary = any_s ^ all_s;
  bool in_b = false;
  for (int p = 0; p < kBlockPasses; ++p) {
    const int shift = kBlockDigitBits * p;
    if (!((vary >> shift) & (kBlockDigits - 1))) continue;
    block_sort_pass<T>(in_b ? b_key : a_key, in_b ? b_idx : a_idx, in_b ? a_key : b_key,
                       in_b ? a_idx : b_idx, m, shift, counters, sm);
    in_b = !in_b;
  }
  return in_b;
}

// block_sort by as many threads as m keys keep busy: the fixed cost of a
// pass (clearing and scanning 16 counters a thread) grows with the threads,
// and a few keys a thread cost less than that. Every thread of the block
// (T threads) calls it; all get the result.
template <int T>
__device__ bool block_sort_sized(unsigned* a_key, int* a_idx, unsigned* b_key, int* b_idx, int m,
                                 unsigned* counters, int* sm) {
  __shared__ int in_b;
  if (m <= 256) {
    if (threadIdx.x < 64) {
      const bool r = block_sort<64>(a_key, a_idx, b_key, b_idx, m, counters, sm);
      if (threadIdx.x == 0) in_b = r;
    }
  } else if (T < 1024 || m <= 4096) {
    if (threadIdx.x < 256) {
      const bool r = block_sort<256>(a_key, a_idx, b_key, b_idx, m, counters, sm);
      if (threadIdx.x == 0) in_b = r;
    }
  } else if constexpr (T == 1024) {
    const bool r = block_sort<1024>(a_key, a_idx, b_key, b_idx, m, counters, sm);
    if (threadIdx.x == 0) in_b = r;
  }
  __syncthreads();
  return in_b;
}

// The result: the first m pairs from (s_key, s_idx), the rest of the k from
// (x_key, x_idx), as the values' bits and indices.
__device__ void write_out(const unsigned* s_key, const int* s_idx, const unsigned* x_key,
                          const int* x_idx, int m, int k, unsigned* out_v, int* out_i) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned u = j < m ? s_key[j] : x_key[j];
    const int i = j < m ? s_idx[j] : x_idx[j];
    out_v[j] = value_bits(u);
    out_i[j] = i;
  }
}

// ------------------------------------------------------------ small route

// The small route's layout in small_region(n, k) words of dynamic shared
// memory, then small_counter_words(T) of counters: the keys at [0, n)
// while k < n, the kept keys' first buffer x at [region - 2k, region) and
// the second at [0, 2k). A multiple of 4 words, so the counters after it
// are 16-byte aligned.
__host__ __device__ int small_region(int n, int k) {
  const int words = k < n && n + 2 * k > 4 * k ? n + 2 * k : 4 * k;
  return (words + 3) & ~3;
}

template <int T>
__global__ void __launch_bounds__(T, 1)
small_kernel(const float* __restrict__ values, int n, int k, unsigned* out_v, int* out_i) {
  // block b takes row b of a (rows, n) input and writes row b of the
  // (rows, k) outputs; the 1-D entry launches one block
  values += static_cast<size_t>(blockIdx.x) * n;
  out_v += static_cast<size_t>(blockIdx.x) * k;
  out_i += static_cast<size_t>(blockIdx.x) * k;
  extern __shared__ unsigned smem[];
  const int region = small_region(n, k);
  unsigned* counters = smem + region;
  unsigned* x_key = smem + region - 2 * k;
  int* x_idx = reinterpret_cast<int*>(x_key + k);
  unsigned* y_key = smem;
  int* y_idx = reinterpret_cast<int*>(smem + k);
  __shared__ int sm[33];

  if (k == n) {  // every key is kept, in index order
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += T) {
      x_key[i] = order_key(__ldg(values + i));
      x_idx[i] = i;
    }
    __syncthreads();
    const bool in_y = block_sort_sized<T>(x_key, x_idx, y_key, y_idx, k, counters, sm);
    write_out(in_y ? y_key : x_key, in_y ? y_idx : x_idx, x_key, x_idx, k, k, out_v, out_i);
    return;
  }

  unsigned* keys = smem;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += T) keys[i] = order_key(__ldg(values + i));
  // 1. select
  unsigned mask = 0u, bits = 0u;
  int less = 0, done = 0;
  __shared__ unsigned any_s, any_inv_s;
  for (int p = 0; p < kSelPasses && !done; ++p) {
    for (int c = threadIdx.x; c < kSelBins / 4; c += T)
      reinterpret_cast<uint4*>(counters)[c] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x == 0) any_s = any_inv_s = 0u;
    __syncthreads();
    const int shift = sel_shift(p);
    const unsigned dmask = (1u << sel_bits(p)) - 1u;
    unsigned any = 0u, any_inv = 0u;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += T) {
      const unsigned u = keys[i];
      if ((u & mask) == bits) {
        atomicAdd(counters + ((u >> shift) & dmask), 1u);
        any |= u;
        any_inv |= ~u;
      }
    }
    any = __reduce_or_sync(kFull, any);
    any_inv = __reduce_or_sync(kFull, any_inv);
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&any_s, any);
      atomicOr(&any_inv_s, any_inv);
    }
    __syncthreads();
    int below;
    const int d = choose_bucket<T>(counters, dmask + 1, k - less, &below, sm);
    advance(mask, bits, less, done, p, d, below, counters[d], any_s == ~any_inv_s, any_s, k);
    __syncthreads();
  }
  // 2. compact into the first buffer: the keys below the bucket to [0,
  // less) and the first `need` of the bucket to [less, k), each in index
  // order; thread t takes the keys [t * itn, (t + 1) * itn)
  const int need = k - less;
  const int itn = ((n + T - 1) / T) | 1;  // odd: a warp's threads read different banks
  const int j0 = threadIdx.x * itn, j1 = min(j0 + itn, n);
  int cl = 0, cb = 0;
  for (int j = j0; j < j1; ++j) {
    const unsigned h = keys[j] & mask;
    cl += h < bits;
    cb += h == bits;
  }
  int tl, tb;
  int el = block_exclusive_scan<T>(cl, &tl, sm);
  int eb = block_exclusive_scan<T>(cb, &tb, sm);
  for (int j = j0; j < j1; ++j) {
    const unsigned u = keys[j], h = u & mask;
    if (h < bits) {
      x_key[el] = u;
      x_idx[el] = j;
      ++el;
    } else if (h == bits) {
      if (eb < need) {
        x_key[less + eb] = u;
        x_idx[less + eb] = j;
      }
      ++eb;
    }
  }
  __syncthreads();  // the keys are no longer read: their space holds the second buffer
  // 3. sort: when the threshold key is complete, the kept bucket keys all
  // equal it and lie above every other kept key, in index order already;
  // only [0, less) needs sorting
  const int m = mask == kFull ? less : k;
  const bool in_y = block_sort_sized<T>(x_key, x_idx, y_key, y_idx, m, counters, sm);
  write_out(in_y ? y_key : x_key, in_y ? y_idx : x_idx, x_key, x_idx, m, k, out_v, out_i);
}

// ------------------------------------------------------------ large route

__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int P>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ values, int n, int k, Control* ctl, unsigned* ghist) {
  __shared__ unsigned hist[kSelBins];
  __shared__ unsigned any_s, any_inv_s;
  __shared__ int sm[33];
  const unsigned mask = ctl->mask, bits = ctl->bits;
  if (ctl->done) return;
  constexpr int shift = sel_shift(P);
  constexpr unsigned dmask = (1u << sel_bits(P)) - 1u;
  for (int c = threadIdx.x; c < kSelBins; c += kSelThreads) hist[c] = 0u;
  if (threadIdx.x == 0) any_s = any_inv_s = 0u;
  __syncthreads();
  // the counted keys' OR and their complements' OR: equal complements mean
  // one key
  unsigned any = 0u, any_inv = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kSelThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kSelThreads + threadIdx.x; base < n;
       base += stride * kSelUnroll) {
    unsigned u[kSelUnroll];
#pragma unroll
    for (int r = 0; r < kSelUnroll; ++r) {
      const long long i = base + r * stride;
      u[r] = i < n ? order_key(__ldg(values + i)) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kSelUnroll; ++r) {
      if (base + r * stride < n && (u[r] & mask) == bits) {
        atomicAdd(hist + ((u[r] >> shift) & dmask), 1u);
        any |= u[r];
        any_inv |= ~u[r];
      }
    }
  }
  any = __reduce_or_sync(kFull, any);
  any_inv = __reduce_or_sync(kFull, any_inv);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&any_s, any);
    atomicOr(&any_inv_s, any_inv);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kSelBins; c += kSelThreads)
    if (hist[c]) atomicAdd(ghist + c, hist[c]);
  if (threadIdx.x == 0) {
    atomicOr(&ctl->sel_any[P], any_s);
    atomicOr(&ctl->sel_any_inv[P], any_inv_s);
  }
  if (!last_block(&ctl->sel_ticket[P])) return;
  for (int c = threadIdx.x; c < kSelBins; c += kSelThreads) hist[c] = __ldcg(ghist + c);
  __syncthreads();
  int below;
  const int d = choose_bucket<kSelThreads>(hist, dmask + 1, k - ctl->less, &below, sm);
  if (threadIdx.x == 0) {
    unsigned m = mask, b = bits;
    int less = ctl->less, done = 0;
    const unsigned all_or = __ldcg(&ctl->sel_any[P]), inv_or = __ldcg(&ctl->sel_any_inv[P]);
    advance(m, b, less, done, P, d, below, hist[d], all_or == ~inv_or, all_or, k);
    ctl->mask = m;
    ctl->bits = b;
    ctl->less = less;
    ctl->done = done;
  }
}

// Per tile of kCompactTile keys: the kept-below and boundary counts; the
// last block turns them into exclusive offsets over the tiles.
__global__ void __launch_bounds__(kCompactThreads)
compact_count_kernel(const float* __restrict__ values, int n, Control* ctl, int* tile_l,
                     int* tile_b) {
  __shared__ int sm[33];
  __shared__ int carry[2];
  const unsigned mask = ctl->mask, bits = ctl->bits;
  const long long t0 = static_cast<long long>(blockIdx.x) * kCompactTile;
  int cl = 0, cb = 0;
#pragma unroll
  for (int r = 0; r < kCompactItems; ++r) {
    const long long i = t0 + r * kCompactThreads + threadIdx.x;
    if (i < n) {
      const unsigned u = order_key(__ldg(values + i)) & mask;
      cl += u < bits;
      cb += u == bits;
    }
  }
  int total_l, total_b;
  block_exclusive_scan<kCompactThreads>(cl, &total_l, sm);
  block_exclusive_scan<kCompactThreads>(cb, &total_b, sm);
  if (threadIdx.x == 0) {
    tile_l[blockIdx.x] = total_l;
    tile_b[blockIdx.x] = total_b;
  }
  if (!last_block(&ctl->compact_ticket[0])) return;
  const int tiles = gridDim.x;
  if (threadIdx.x == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int t0s = 0; t0s < tiles; t0s += kCompactThreads) {
    const int t = t0s + threadIdx.x;
    const int a = t < tiles ? __ldcg(tile_l + t) : 0, b = t < tiles ? __ldcg(tile_b + t) : 0;
    int ta, tb;
    const int ea = block_exclusive_scan<kCompactThreads>(a, &ta, sm);
    const int eb = block_exclusive_scan<kCompactThreads>(b, &tb, sm);
    if (t < tiles) {
      tile_l[t] = carry[0] + ea;
      tile_b[t] = carry[1] + eb;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      carry[0] += ta;
      carry[1] += tb;
    }
    __syncthreads();
  }
}

// The stable compaction: each key below the bucket goes to its rank among
// them, and each kept bucket key after all of those, by its rank in the
// bucket. With sort_hist, also the four digit histograms of the keys to
// sort; the last block then plans the sort passes.
__global__ void __launch_bounds__(kCompactThreads)
compact_scatter_kernel(const float* __restrict__ values, int n, int k, Control* ctl,
                       const int* __restrict__ tile_l, const int* __restrict__ tile_b,
                       unsigned* key0, int* idx0, unsigned* sort_hist) {
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ int wl[kWarps], wb[kWarps];
  __shared__ unsigned hist[kSortPasses * kSortBins];
  const unsigned mask = ctl->mask, bits = ctl->bits;
  const int less = ctl->less, need = k - less;
  const bool full = mask == kFull;  // only [0, less) is sorted
  const int m = full ? less : k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sort_hist)
    for (int c = threadIdx.x; c < kSortPasses * kSortBins; c += kCompactThreads) hist[c] = 0u;
  // a warp's contiguous range of 32 * kCompactItems keys
  const long long w0 =
      static_cast<long long>(blockIdx.x) * kCompactTile + warp * 32 * kCompactItems;
  unsigned u[kCompactItems];
  int cl = 0, cb = 0;
#pragma unroll
  for (int r = 0; r < kCompactItems; ++r) {
    const long long i = w0 + r * 32 + lane;
    u[r] = i < n ? order_key(__ldg(values + i)) : 0u;
    const unsigned h = u[r] & mask;
    cl += __popc(__ballot_sync(kFull, i < n && h < bits));
    cb += __popc(__ballot_sync(kFull, i < n && h == bits));
  }
  if (lane == 0) {
    wl[warp] = cl;
    wb[warp] = cb;
  }
  __syncthreads();
  if (warp == 0) {
    const int a = lane < kWarps ? wl[lane] : 0, b = lane < kWarps ? wb[lane] : 0;
    int sa = a, sb = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(kFull, sa, o), yb = __shfl_up_sync(kFull, sb, o);
      if (lane >= o) {
        sa += ya;
        sb += yb;
      }
    }
    if (lane < kWarps) {
      wl[lane] = tile_l[blockIdx.x] + sa - a;
      wb[lane] = tile_b[blockIdx.x] + sb - b;
    }
  }
  __syncthreads();
  int rl = wl[warp], rb = wb[warp];
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int r = 0; r < kCompactItems; ++r) {
    const long long i = w0 + r * 32 + lane;
    const unsigned h = u[r] & mask;
    const bool is_l = i < n && h < bits, is_b = i < n && h == bits;
    const unsigned ml = __ballot_sync(kFull, is_l), mb = __ballot_sync(kFull, is_b);
    const int bl = rl + __popc(ml & lt), bb = rb + __popc(mb & lt);
    const bool kept = is_l || (is_b && bb < need);
    if (kept) {  // below the bucket to [0, less), the bucket's to [less, k)
      const int pos = is_l ? bl : less + bb;
      key0[pos] = u[r];
      idx0[pos] = static_cast<int>(i);
    }
    if (sort_hist && (is_l || (!full && kept))) {
#pragma unroll
      for (int p = 0; p < kSortPasses; ++p)
        atomicAdd(hist + p * kSortBins + ((u[r] >> (8 * p)) & 0xffu), 1u);
    }
    rl += __popc(ml);
    rb += __popc(mb);
  }
  if (!sort_hist) return;
  __syncthreads();
  for (int c = threadIdx.x; c < kSortPasses * kSortBins; c += kCompactThreads)
    if (hist[c]) atomicAdd(sort_hist + c, hist[c]);
  if (!last_block(&ctl->compact_ticket[1])) return;
  if (warp < kSortPasses) {  // warp p: is pass p the identity?
    int all = 0;
    for (int d = lane; d < kSortBins; d += 32)
      all |= static_cast<int>(__ldcg(sort_hist + warp * kSortBins + d)) == m;
    all = __any_sync(kFull, all);
    if (lane == 0) ctl->skip[warp] = all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cur = 0, last = -1;
    for (int p = 0; p < kSortPasses; ++p) {
      ctl->src[p] = cur;
      if (!ctl->skip[p]) {
        cur ^= 1;
        last = p;
      }
    }
    ctl->last = last;
    ctl->ran = last >= 0;
  }
}

// Sort of the survivors in one block (route 1, k <= kSmallWords / 4): the
// sort range is copied into shared memory and sorted there.
__global__ void __launch_bounds__(1024, 1)
block_sort_kernel(const unsigned* key0, const int* idx0, int k, const Control* ctl, unsigned* out_v,
                  int* out_i) {
  extern __shared__ unsigned smem[];
  __shared__ int sm[33];
  const int m = sort_range(ctl, k);
  const int m4 = (m + 3) & ~3;
  unsigned* a_key = smem;
  int* a_idx = reinterpret_cast<int*>(smem + m4);
  unsigned* b_key = smem + 2 * m4;
  int* b_idx = reinterpret_cast<int*>(smem + 3 * m4);
  for (int j = threadIdx.x; j < m; j += 1024) {
    a_key[j] = key0[j];
    a_idx[j] = idx0[j];
  }
  __syncthreads();
  const bool in_b = block_sort_sized<1024>(a_key, a_idx, b_key, b_idx, m, smem + 4 * m4, sm);
  write_out(in_b ? b_key : a_key, in_b ? b_idx : a_idx, key0, idx0, m, k, out_v, out_i);
}

// Route 2, pass P: the digit counts of each tile of kSortTile survivors.
template <int P>
__global__ void __launch_bounds__(kSortThreads)
sort_count_kernel(const unsigned* key0, const unsigned* key1, int k, const Control* ctl,
                  int* counts) {
  __shared__ unsigned hist[kSortBins];
  if (ctl->skip[P]) return;
  const unsigned* src = ctl->src[P] ? key1 : key0;
  const int m = sort_range(ctl, k);
  hist[threadIdx.x] = 0u;
  __syncthreads();
  const long long t0 = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll 4
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = t0 + r * kSortThreads + threadIdx.x;
    if (i < m) atomicAdd(hist + ((src[i] >> (8 * P)) & 0xffu), 1u);
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x] =
      static_cast<int>(hist[threadIdx.x]);
}

// Route 2, pass P: block d turns digit d's tile counts into the tiles'
// exclusive offsets, after every smaller digit (digit-major, tile-minor).
template <int P>
__global__ void __launch_bounds__(kScanThreads)
sort_scan_kernel(int tiles, const Control* ctl, const unsigned* sort_hist, int* counts) {
  __shared__ int sm[33];
  __shared__ int carry;
  if (ctl->skip[P]) return;
  const int d = blockIdx.x;
  int before = 0;
  for (int e = threadIdx.x; e < d; e += kScanThreads)
    before += static_cast<int>(sort_hist[P * kSortBins + e]);
  int base;
  block_exclusive_scan<kScanThreads>(before, &base, sm);
  if (threadIdx.x == 0) carry = base;
  __syncthreads();
  int* row = counts + static_cast<long long>(d) * tiles;
  for (int t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int c = t < tiles ? row[t] : 0;
    int total;
    const int e = block_exclusive_scan<kScanThreads>(c, &total, sm);
    if (t < tiles) row[t] = carry + e;
    __syncthreads();
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
}

// Route 2, pass P: the stable scatter of each tile. The tile is first
// ranked into shared memory in digit order (digit-major, warp-minor, lane
// rank among equal digits), then written out in that order, so threads of
// a warp write runs of consecutive addresses. The last pass that moves
// data writes the values' bits and indices to the output.
template <int P>
__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(unsigned* key0, int* idx0, unsigned* key1, int* idx1, int k, const Control* ctl,
                    const int* counts, unsigned* out_v, int* out_i) {
  constexpr int kRow = kSortWarps + 1;  // padded: lanes of other digits hit other banks
  __shared__ unsigned wc[kSortBins * kRow];  // wc[d * kRow + warp]
  __shared__ int shift_d[kSortBins];  // global position minus tile position, by digit
  __shared__ unsigned s_key[kSortTile];
  __shared__ int s_idx[kSortTile];
  __shared__ int sm[33];
  if (ctl->skip[P]) return;
  const bool from1 = ctl->src[P], to_out = ctl->last == P;
  const unsigned* src_key = from1 ? key1 : key0;
  const int* src_idx = from1 ? idx1 : idx0;
  unsigned* dst_key = to_out ? out_v : from1 ? key0 : key1;
  int* dst_idx = to_out ? out_i : from1 ? idx0 : idx1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < kSortBins * kRow; c += kSortThreads) wc[c] = 0u;
  __syncthreads();
  const long long t0 = static_cast<long long>(blockIdx.x) * kSortTile;
  const int w0 = warp * 32 * kSortItems;  // the warp's range in the tile
  const int m = sort_range(ctl, k);
  const int count = static_cast<int>(m - t0 < kSortTile ? m - t0 : kSortTile);
  unsigned u[kSortItems];
  int ix[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int j = w0 + r * 32 + lane;
    u[r] = j < count ? src_key[t0 + j] : 0u;
    ix[r] = j < count ? src_idx[t0 + j] : 0;
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const unsigned d = w0 + r * 32 + lane < count ? (u[r] >> (8 * P)) & 0xffu : kNoDigit;
    if (d != kNoDigit) atomicAdd(wc + d * kRow + warp, 1u);
  }
  __syncthreads();
  {  // thread d: digit d's place in the tile, and its warps' within it
    const int d = threadIdx.x;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) total += static_cast<int>(wc[d * kRow + w]);
    int all;
    int run = block_exclusive_scan<kSortThreads>(total, &all, sm);
    shift_d[d] = counts[static_cast<long long>(d) * gridDim.x + blockIdx.x] - run;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = static_cast<int>(wc[d * kRow + w]);
      wc[d * kRow + w] = static_cast<unsigned>(run);
      run += c;
    }
  }
  __syncthreads();
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool live = w0 + r * 32 + lane < count;
    const unsigned d = (u[r] >> (8 * P)) & 0xffu;
    const unsigned peers = match8(d, live);
    unsigned base = 0;
    if (live) base = wc[d * kRow + warp];
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) wc[d * kRow + warp] = base + __popc(peers);
    __syncwarp();
    if (live) {
      const unsigned pos = base + __popc(peers & lt);
      s_key[pos] = u[r];
      s_idx[pos] = ix[r];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += kSortThreads) {
    const unsigned key = s_key[j];
    const long long pos = j + shift_d[(key >> (8 * P)) & 0xffu];
    dst_key[pos] = to_out ? value_bits(key) : key;
    dst_idx[pos] = s_idx[j];
  }
}

// Route 2's last kernel: the kept bucket keys after the sorted range, and
// the sorted range itself when every sort pass was skipped (its keys all
// equal).
__global__ void emit_kernel(const unsigned* key0, const int* idx0, int k, const Control* ctl,
                            unsigned* out_v, int* out_i) {
  const long long from = ctl->ran ? sort_range(ctl, k) : 0;
  for (long long i = from + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < k;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out_v[i] = value_bits(key0[i]);
    out_i[i] = idx0[i];
  }
}

__global__ void empty_kernel() {}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Words of scratch that route needs (0 for the small route).
long long scratch_words(int n, int k, int route) {
  if (route == 0) return 0;
  long long w = kCtlWords + 2 * ceil_div(n, kCompactTile) + 2LL * k;
  if (route == 2) w += 2LL * k + kSortBins * ceil_div(k, kSortTile);
  return w;
}

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P>
void sort_pass(unsigned* key0, int* idx0, unsigned* key1, int* idx1, int k, Control* ctl,
               const unsigned* sort_hist, int* counts, unsigned* ov, int* oi, cudaStream_t st) {
  const int tiles = static_cast<int>(ceil_div(k, kSortTile));
  sort_count_kernel<P><<<tiles, kSortThreads, 0, st>>>(key0, key1, k, ctl, counts);
  sort_scan_kernel<P><<<kSortBins, kScanThreads, 0, st>>>(tiles, ctl, sort_hist, counts);
  sort_scatter_kernel<P><<<tiles, kSortThreads, 0, st>>>(key0, idx0, key1, idx1, k, ctl, counts, ov,
                                                        oi);
}

// The small route over `rows` rows of n values each: a grid of one block a
// row, each block the 1-D small route on its row.
cudaError_t small_launch(const float* v, int rows, int n, int k, unsigned* ov, int* oi,
                         cudaStream_t st) {
  const int region = small_region(n, k);
  if (region > kSmallWords) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n <= kSmallN) {
    const int bytes = 4 * (region + small_counter_words(256));
    static bool configured = false;
    if (!configured) {
      if ((err = set_smem(reinterpret_cast<const void*>(small_kernel<256>),
                          4 * (kSmallWords + small_counter_words(256)))) != cudaSuccess)
        return err;
      configured = true;
    }
    small_kernel<256><<<rows, 256, bytes, st>>>(v, n, k, ov, oi);
    return cudaGetLastError();
  }
  const int bytes = 4 * (region + small_counter_words(1024));
  static bool configured = false;
  if (!configured) {
    if ((err = set_smem(reinterpret_cast<const void*>(small_kernel<1024>),
                        4 * (kSmallWords + small_counter_words(1024)))) != cudaSuccess)
      return err;
    configured = true;
  }
  small_kernel<1024><<<rows, 1024, bytes, st>>>(v, n, k, ov, oi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int evox_partial_topk(const void* values, int n, int k, int route, void* scratch,
                                 long long scratch_len, void* out_values, void* out_indices,
                                 void* stream) {
  if (n <= 0 || k < 1 || k > n || route < 0 || route > 2 ||
      scratch_len < scratch_words(n, k, route))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  unsigned* ov = static_cast<unsigned*>(out_values);
  int* oi = static_cast<int*>(out_indices);
  cudaError_t err;
  if (route == 0) return static_cast<int>(small_launch(v, 1, n, k, ov, oi, st));
  unsigned* base = static_cast<unsigned*>(scratch);
  Control* ctl = reinterpret_cast<Control*>(base);
  unsigned* sel_hist = base + 64;
  unsigned* sort_hist = sel_hist + kSelPasses * kSelBins;
  const long long ctiles = ceil_div(n, kCompactTile);
  int* tile_l = reinterpret_cast<int*>(base + kCtlWords);
  int* tile_b = tile_l + ctiles;
  unsigned* key0 = reinterpret_cast<unsigned*>(tile_b + ctiles);
  int* idx0 = reinterpret_cast<int*>(key0 + k);
  if ((err = cudaMemsetAsync(base, 0, 4 * kCtlWords, st)) != cudaSuccess)
    return static_cast<int>(err);
  if (k < n) {
    const int grid = static_cast<int>(std::min(ceil_div(n, kSelThreads * kSelUnroll), 132LL * 4));
    select_kernel<0><<<grid, kSelThreads, 0, st>>>(v, n, k, ctl, sel_hist);
    select_kernel<1><<<grid, kSelThreads, 0, st>>>(v, n, k, ctl, sel_hist + kSelBins);
    select_kernel<2><<<grid, kSelThreads, 0, st>>>(v, n, k, ctl, sel_hist + 2 * kSelBins);
  }
  compact_count_kernel<<<static_cast<int>(ctiles), kCompactThreads, 0, st>>>(v, n, ctl, tile_l,
                                                                             tile_b);
  compact_scatter_kernel<<<static_cast<int>(ctiles), kCompactThreads, 0, st>>>(
      v, n, k, ctl, tile_l, tile_b, key0, idx0, route == 2 ? sort_hist : nullptr);
  if (route == 1) {
    if (4 * k > kSmallWords) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = 4 * (4 * ((k + 3) & ~3) + counter_words(1024));
    static bool configured = false;
    if (!configured) {
      if ((err = set_smem(reinterpret_cast<const void*>(block_sort_kernel),
                          4 * (kSmallWords + 12 + counter_words(1024)))) != cudaSuccess)
        return static_cast<int>(err);
      configured = true;
    }
    block_sort_kernel<<<1, 1024, bytes, st>>>(key0, idx0, k, ctl, ov, oi);
    return static_cast<int>(cudaGetLastError());
  }
  unsigned* key1 = reinterpret_cast<unsigned*>(idx0 + k);
  int* idx1 = reinterpret_cast<int*>(key1 + k);
  int* counts = idx1 + k;
  sort_pass<0>(key0, idx0, key1, idx1, k, ctl, sort_hist, counts, ov, oi, st);
  sort_pass<1>(key0, idx0, key1, idx1, k, ctl, sort_hist, counts, ov, oi, st);
  sort_pass<2>(key0, idx0, key1, idx1, k, ctl, sort_hist, counts, ov, oi, st);
  sort_pass<3>(key0, idx0, key1, idx1, k, ctl, sort_hist, counts, ov, oi, st);
  const int emit_grid = static_cast<int>(std::min(ceil_div(k, 1024), 132LL * 8));
  emit_kernel<<<emit_grid, 1024, 0, st>>>(key0, idx0, k, ctl, ov, oi);
  return static_cast<int>(cudaGetLastError());
}

// The small route alone, with fewer arguments to pass: at small n the
// host's side of a call, not the card, sets its time.
extern "C" int evox_partial_topk_small(const void* values, int n, int k, void* out_values,
                                       void* out_indices, void* stream) {
  return evox_partial_topk(values, n, k, 0, nullptr, 0, out_values, out_indices, stream);
}

// The small route over a (rows, n) row-major input in one launch: the k
// smallest of each row to row b of the (rows, k) outputs. What vmap of the
// JAX kernel gives: one kernel with a grid over the rows.
extern "C" int evox_partial_topk_small_rows(const void* values, int rows, int n, int k,
                                            void* out_values, void* out_indices, void* stream) {
  if (rows < 1 || n <= 0 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(small_launch(static_cast<const float*>(values), rows, n, k,
                                       static_cast<unsigned*>(out_values),
                                       static_cast<int*>(out_indices),
                                       static_cast<cudaStream_t>(stream)));
}

// count launches of an empty kernel, back to back: the card's floor under
// any call that launches.
extern "C" int evox_topk_empty_launch(int count, void* stream) {
  for (int i = 0; i < count; ++i) empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
