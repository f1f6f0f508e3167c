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
// Design: the TPU kernel's comparison counting, made global. Each value's
// bits become an order-preserving uint32 key u (sign set: all bits
// flipped; sign clear: the sign bit set), and
//   rank_i = #{j : u_j < u_i} + #{j < i : u_j == u_i},
// a permutation of 0..n-1. Every i with rank_i < k writes out[rank_i].
// Pass 1 (rank_kernel) has one thread per i; a block stages a tile of
// kTile keys in shared memory and counts against it, and blocks along
// grid.y take different tiles, so the n^2 compares spread over the whole
// card even when n / 256 blocks would not fill it; each block adds its
// partial counts with one atomicAdd per element. Because a tile's indices
// are known, a tile wholly before i counts u_j <= u_i and one wholly after
// counts u_j < u_i, so the inner loop is one 32-bit compare per key. Pass 2
// (scatter_kernel) writes the selected values and indices. No sort and no
// library call.
//
// What bounds it on an H100. The function's own work is O(n): read n
// floats, write k values and k indices, so bytes bound it (a radix select
// would come near that). This design does n^2 compares instead (4e8 at
// n = 20000), which is the simple kernel that is right first; PERF.md
// keeps its time beside the byte bound.
//
// C interface (loaded with ctypes): evox_partial_topk returns
// cudaGetLastError() after the launches; 0 means launched. rank is
// caller-allocated (n,) int32 scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kBlock)
rank_kernel(const float* __restrict__ values, int n, int n_tiles, int* __restrict__ rank) {
  __shared__ unsigned tile[kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  const unsigned ui = live ? order_key(__ldg(values + i)) : 0u;
  int count = 0;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int t0 = t * kTile;
    const int len = min(kTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int s = threadIdx.x; s < len; s += kBlock) tile[s] = order_key(__ldg(values + t0 + s));
    __syncthreads();
    if (!live) continue;
    if (t0 + len <= i) {  // every j of the tile is below i: ties count
      for (int s = 0; s < len; ++s) count += tile[s] <= ui;
    } else if (t0 > i) {  // every j is above i: ties do not count
      for (int s = 0; s < len; ++s) count += tile[s] < ui;
    } else {
      for (int s = 0; s < len; ++s) {
        const unsigned uj = tile[s];
        count += (uj < ui) || (uj == ui && t0 + s < i);
      }
    }
  }
  if (live && count) atomicAdd(rank + i, count);
}

__global__ void scatter_kernel(const float* __restrict__ values, const int* __restrict__ rank,
                               int n, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = rank[i];
  if (r < k) {
    out_v[r] = values[i];
    out_i[r] = i;
  }
}

}  // namespace

extern "C" int evox_partial_topk(const void* values, int n, int k, void* rank, void* out_values,
                                 void* out_indices, void* stream) {
  if (n <= 0 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  int* r = static_cast<int*>(rank);
  cudaError_t err = cudaMemsetAsync(r, 0, sizeof(int) * static_cast<size_t>(n), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid((n + kBlock - 1) / kBlock, n_tiles < 65535 ? n_tiles : 65535);
  rank_kernel<<<grid, kBlock, 0, st>>>(v, n, n_tiles, r);
  scatter_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      v, r, n, k, static_cast<float*>(out_values), static_cast<int*>(out_indices));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
