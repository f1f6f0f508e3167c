// One-block histogram variants on an H100: which way to count digits in
// shared memory, for csrc/topk.cu's select and sort counts.
//
// One block of 1024 threads histograms 20000 keys held in shared memory
// (the top 11 bits, as the select's first pass does) ten times, by
//   0: warp aggregation of the lanes sharing the first two lanes' digits,
//      eight keys a lane at once (one atomicAdd a group);
//   1: a plain shared-memory atomicAdd a key;
//   2: aggregation of lane 0's digit only;
//   3: per-thread register counts of a 4-bit digit and a block reduction;
// on two key laws: keys spread over a few buckets (as distinct integers
// are), and 87 % of the keys one value (NSGA-II's cut key, +inf). Prints
// clock cycles a pass. Build and run from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o evox_tpu_torch/_build/topk_atomics \
//     tools/torch_topk_atomics.cu && evox_tpu_torch/_build/topk_atomics
#include <cstdio>
#include <cuda_runtime.h>
constexpr unsigned kFull = 0xffffffffu, kNoDigit = 0xffffffffu;
__device__ long long g_t[16];

template <int N>
__device__ __forceinline__ void warp_count_n(unsigned* hist, const unsigned (&d)[N], int lane) {
  unsigned d0[N], same0[N], d1[N], same1[N]; int l1[N];
#pragma unroll
  for (int r = 0; r < N; ++r) d0[r] = __shfl_sync(kFull, d[r], 0);
#pragma unroll
  for (int r = 0; r < N; ++r) same0[r] = __ballot_sync(kFull, d[r] == d0[r]);
#pragma unroll
  for (int r = 0; r < N; ++r) l1[r] = same0[r] == kFull ? 0 : __ffs(~same0[r]) - 1;
#pragma unroll
  for (int r = 0; r < N; ++r) d1[r] = __shfl_sync(kFull, d[r], l1[r]);
#pragma unroll
  for (int r = 0; r < N; ++r) same1[r] = __ballot_sync(kFull, d[r] == d1[r]) & ~same0[r];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const unsigned add = lane == 0 ? __popc(same0[r]) : (same1[r] && lane == l1[r]) ? __popc(same1[r]) : (d[r] != d0[r] && d[r] != d1[r]) ? 1u : 0u;
    if (add && d[r] != kNoDigit) atomicAdd(hist + d[r], add);
  }
}

template <int V>
__global__ void __launch_bounds__(1024, 1) k_hist(const unsigned* keys_g, int n, unsigned* out) {
  extern __shared__ unsigned smem[];
  unsigned* keys = smem; unsigned* hist = smem + 20480;
  for (int i = threadIdx.x; i < n; i += 1024) keys[i] = keys_g[i];
  for (int c = threadIdx.x; c < 2048; c += 1024) hist[c] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long t0 = clock64();
  for (int rep = 0; rep < 10; ++rep) {
    if (V == 0) {  // warp_count_n<8>
      for (int base = warp * 32; base < n; base += 1024 * 8) {
        unsigned d[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) { const int i = base + r * 1024 + lane; d[r] = i < n ? keys[i] >> 21 : kNoDigit; }
        warp_count_n<8>(hist, d, lane);
      }
    } else if (V == 1) {  // plain atomics
      for (int i = threadIdx.x; i < n; i += 1024) atomicAdd(hist + (keys[i] >> 21), 1u);
    } else if (V == 2) {  // lane 0 aggregation
      for (int base = warp * 32; base < n; base += 1024) {
        const int i = base + lane; const unsigned d = i < n ? keys[i] >> 21 : kNoDigit;
        const unsigned d0 = __shfl_sync(kFull, d, 0); const unsigned same = __ballot_sync(kFull, d == d0);
        if (lane == 0) { if (d0 != kNoDigit) atomicAdd(hist + d0, __popc(same)); }
        else if (d != d0 && d != kNoDigit) atomicAdd(hist + d, 1u);
      }
    } else if (V == 3) {  // register counting of a 4-bit digit, then a block reduction
      unsigned c[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // 16 counters of 16 bits
      for (int i = threadIdx.x; i < n; i += 1024) {
        const unsigned d = (keys[i] >> 28) & 15;
#pragma unroll
        for (int q = 0; q < 8; ++q) c[q] += (d >> 1) == q ? (1u << (16 * (d & 1))) : 0u;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int o = 16; o; o >>= 1) c[q] += __shfl_xor_sync(kFull, c[q], o);
      }
      if (lane == 0) for (int q = 0; q < 8; ++q) atomicAdd(hist + q, c[q]);
    }
    __syncthreads();
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) g_t[V] = (t1 - t0) / 10;
  if (threadIdx.x < 4) out[threadIdx.x] = hist[threadIdx.x];
}

int main() {
  const int n = 20000;
  unsigned h[n];
  unsigned* dk; unsigned* out; cudaMalloc(&dk, 4 * n); cudaMalloc(&out, 64);
  for (int law = 0; law < 2; ++law) {
    unsigned s = 12345;
    for (int i = 0; i < n; ++i) {
      s = s * 1664525u + 1013904223u;
      if (law == 0) h[i] = 0xC0000000u + (s >> 4);  // spread over a few top buckets, as distinct ints do
      else h[i] = (s % 100) < 87 ? 0xFF800000u : (0x40000000u + (s >> 8));  // the cut key: mostly +inf
    }
    cudaMemcpy(dk, h, 4 * n, cudaMemcpyHostToDevice);
    cudaFuncSetAttribute(k_hist<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
    cudaFuncSetAttribute(k_hist<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
    cudaFuncSetAttribute(k_hist<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
    cudaFuncSetAttribute(k_hist<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
    for (int rep = 0; rep < 2; ++rep) {
      k_hist<0><<<1, 1024, 100000>>>(dk, n, out); k_hist<1><<<1, 1024, 100000>>>(dk, n, out);
      k_hist<2><<<1, 1024, 100000>>>(dk, n, out); k_hist<3><<<1, 1024, 100000>>>(dk, n, out);
      cudaDeviceSynchronize();
      long long t[16]; cudaMemcpyFromSymbol(t, g_t, sizeof t);
      printf("law %d: cycles per count pass over %d keys: warp_count_n<8> %lld plain atomics %lld lane0-agg %lld regcount4bit %lld (%s)\n",
             law, n, t[0], t[1], t[2], t[3], cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
