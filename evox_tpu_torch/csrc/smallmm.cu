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
// depends on z, the batch count, the grid or the tile: a member computed
// in a batch of 64 equals the same member in a batch of 1, bit for bit,
// and the plain PyTorch version (kernels/smallmm.py::smallmm_plain, a loop
// over k of elementwise multiplies and adds) reproduces it step by step.
//
// Design: a block takes a 16 x 16 tile of c (one output a thread), and
// walks k in tiles of 16: the A and B tiles are staged in shared memory
// (coalesced for either transpose: a transposed operand is loaded along
// its own rows and stored transposed), then each thread runs the 16 steps
// of its sum in order. Grid: (ceil(q / 16), ceil(p / 16), batch).
//
// What bounds it on an H100: 2 p k q operations a member against
// 4 (p k + k q + p q) bytes. CMA-ES's shapes are small (d 16: 16 x 16
// tiles) or issue-bound (d 1000: (24 x 1000)(1000 x 1000), 48 MFLOP on 126
// blocks), and the products cannot use the tensor cores or FMA and keep
// the order above, so the float32 issue rate (67 TFLOP/s counting a
// multiply and an add as two) is the ceiling. This first version is
// simple: one output a thread, no register blocking.
//
// C interface (loaded with ctypes): evox_smallmm returns cudaGetLastError()
// after the launch; 0 means launched.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
smallmm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
               int p, int k, int q, int trans_a, int trans_b) {
  __shared__ float as[kTile][kTile + 1];  // as[r][t] = A(row0 + r, k0 + t)
  __shared__ float bs[kTile][kTile + 1];  // bs[t][s] = B(k0 + t, col0 + s)
  const long long z = blockIdx.z;
  a += z * p * k;
  b += z * k * q;
  c += z * p * q;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kTile) {
    if (trans_a) {  // a is (k, p): read row k0 + ty, columns row0 + tx
      const int kk = k0 + ty, r = row0 + tx;
      as[tx][ty] = (kk < k && r < p) ? a[static_cast<long long>(kk) * p + r] : 0.0f;
    } else {  // a is (p, k): read row row0 + ty, columns k0 + tx
      const int r = row0 + ty, kk = k0 + tx;
      as[ty][tx] = (r < p && kk < k) ? a[static_cast<long long>(r) * k + kk] : 0.0f;
    }
    if (trans_b) {  // b is (q, k): read row col0 + ty, columns k0 + tx
      const int s = col0 + ty, kk = k0 + tx;
      bs[tx][ty] = (s < q && kk < k) ? b[static_cast<long long>(s) * k + kk] : 0.0f;
    } else {  // b is (k, q): read row k0 + ty, columns col0 + tx
      const int kk = k0 + ty, s = col0 + tx;
      bs[ty][tx] = (kk < k && s < q) ? b[static_cast<long long>(kk) * q + s] : 0.0f;
    }
    __syncthreads();
    const int kn = min(kTile, k - k0);  // the padding is never added
    for (int t = 0; t < kn; ++t) acc = __fadd_rn(acc, __fmul_rn(as[ty][t], bs[t][tx]));
    __syncthreads();
  }
  const int i = row0 + ty, j = col0 + tx;
  if (i < p && j < q) c[static_cast<long long>(i) * q + j] = acc;
}

}  // namespace

// a: batch x (p, k), or batch x (k, p) with trans_a; b: batch x (k, q), or
// batch x (q, k) with trans_b; c: batch x (p, q); all contiguous float32
extern "C" int evox_smallmm(const void* a, const void* b, void* c, int batch, int p, int k,
                            int q, int trans_a, int trans_b, void* stream) {
  if (batch <= 0 || batch > 65535 || p <= 0 || k <= 0 || q <= 0 ||
      (p + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((q + kTile - 1) / kTile, (p + kTile - 1) / kTile, batch);
  const dim3 block(kTile, kTile);
  smallmm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), p, k,
      q, trans_a, trans_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
