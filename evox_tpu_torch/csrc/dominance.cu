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
// Design. One warp per 32-row word: lane k owns row 32w + k and keeps its
// m objectives in registers. A block of kWarps warps shares a tile of
// kTileJ columns, staged in shared memory objective-major (ys[k][j]), so
// every lane of a warp reads the same column value (a broadcast, no bank
// conflict). For each column j the lanes compare their row with it and
// __ballot_sync packs the 32 answers into the word; bit k is lane k, the
// JAX bit order. Lane c keeps the word of column jb + c, so after 32
// columns each lane holds one word and the warp stores 32 consecutive
// words at once (coalesced). Lanes past n vote 0 but stay in the ballot.
// The dense (n, n) boolean matrix never exists, so the kernel needs no
// chunked build; the plain version keeps the JAX package's chunked build
// above n = 20000. A second small kernel sums __popc over each column of
// words for count.
//
// What bounds it on an H100: the 2m compares and the and/or logic of each
// of the n^2 (row, column) pairs, about n^2 * 3m operations (3.6e9 at
// n = 20000, m = 3), against n^2 / 8 bytes of words written (50 MB). The
// operations bound it; the design spends no instruction on data movement
// inside the column loop beyond one shared-memory broadcast per objective.
//
// Numerics. Plain IEEE compares: a NaN objective makes every compare
// false, so a NaN row dominates nothing and is dominated by nothing, and a
// row of +inf dominates nothing, as in the JAX package.
//
// C interface (loaded with ctypes): evox_packed_dominance returns
// cudaGetLastError() after the launches; 0 means launched.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // words (32-row groups) per block
constexpr int kTileJ = 256;  // columns per block
constexpr int kMaxM = 32;    // objectives the kernel takes

template <int MAXM>
__global__ void __launch_bounds__(kWarps * 32)
dominance_pack_kernel(const float* __restrict__ fit, int n, int m, int n_words,
                      int* __restrict__ packed) {
  __shared__ float ys[MAXM][kTileJ];
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row = w * 32 + lane;
  const bool live = row < n;
  const int j0 = blockIdx.y * kTileJ;

  float x[MAXM];
#pragma unroll
  for (int k = 0; k < MAXM; ++k) x[k] = (k < m && live) ? __ldg(fit + (long long)row * m + k) : 0.0f;

  // stage the column tile: the tile's rows are contiguous in fit, so the
  // reads are coalesced; columns past n read as 0 and are never stored
  const int jmax = min(kTileJ, n - j0);
  for (int t = threadIdx.x; t < kTileJ * m; t += blockDim.x) {
    const int jj = t / m, k = t - jj * m;
    ys[k][jj] = jj < jmax ? __ldg(fit + (long long)(j0 + jj) * m + k) : 0.0f;
  }
  __syncthreads();
  if (w >= n_words) return;  // whole warps: w is uniform in a warp

  for (int jb = 0; jb < jmax; jb += 32) {
    unsigned mine = 0;
#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      bool le = true, lt = false;
#pragma unroll
      for (int k = 0; k < MAXM; ++k) {
        if (k < m) {
          const float y = ys[k][jb + c];
          le = le && (x[k] <= y);
          lt = lt || (x[k] < y);
        }
      }
      const unsigned word = __ballot_sync(0xffffffffu, live && le && lt);
      if (lane == c) mine = word;
    }
    const int j = j0 + jb + lane;
    if (j < n) packed[(long long)w * n + j] = static_cast<int>(mine);
  }
}

// count[j] = sum over words of popcount(packed[w][j]); consecutive threads
// read consecutive columns of one word row
__global__ void column_popcount_kernel(const int* __restrict__ packed, int n, int n_words,
                                       int* __restrict__ count) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int c = 0;
  for (int w = 0; w < n_words; ++w) c += __popc(static_cast<unsigned>(__ldg(packed + (long long)w * n + j)));
  count[j] = c;
}

template <int MAXM>
void launch_pack(const float* fit, int n, int m, int n_words, int* packed, cudaStream_t st) {
  const dim3 grid((n_words + kWarps - 1) / kWarps, (n + kTileJ - 1) / kTileJ);
  dominance_pack_kernel<MAXM><<<grid, kWarps * 32, 0, st>>>(fit, n, m, n_words, packed);
}

}  // namespace

extern "C" int evox_packed_dominance(const void* fitness, int n, int m, void* packed,
                                     void* count, void* stream) {
  if (n <= 0 || m <= 0 || m > kMaxM || (n + kTileJ - 1) / kTileJ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fit = static_cast<const float*>(fitness);
  int* words = static_cast<int*>(packed);
  const int n_words = (n + 31) / 32;
  // the smallest register file that holds the row's objectives
  if (m <= 4) {
    launch_pack<4>(fit, n, m, n_words, words, st);
  } else if (m <= 8) {
    launch_pack<8>(fit, n, m, n_words, words, st);
  } else if (m <= 16) {
    launch_pack<16>(fit, n, m, n_words, words, st);
  } else {
    launch_pack<32>(fit, n, m, n_words, words, st);
  }
  column_popcount_kernel<<<(n + 255) / 256, 256, 0, st>>>(words, n, n_words,
                                                           static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
