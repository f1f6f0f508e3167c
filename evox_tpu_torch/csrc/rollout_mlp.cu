// Fused big-policy rollout for Hopper (sm_90a): whole chain-walker episodes
// of a per-individual multi-layer tanh MLP, one block per env.
//
// Replaces the Pallas TPU kernel
// evox_tpu/kernels/rollout_mlp.py::fused_mlp_rollout (pallas_call at :569;
// body _rollout_mlp_kernel :294, layer loop _mlp_planes :267, walker physics
// chain_walker_planes :84). Computes, for every env (individual i, episode
// e), the total reward of one episode of at most T steps: observation from
// the walker state, an MLP of up to 4 layers (tanh after each but the last
// and the "linear" ones), then 5 substeps of rod-spring, torque, contact and
// friction forces with semi-implicit Euler; the terminating step's reward
// counts, later ones do not.
//
// Design. One block per env, on a grid of (n, episodes). The block copies
// its individual's whole policy (20945 floats, 83.8 KB at 244-64-64-17)
// into dynamic shared memory once, with cp.async, reading the weights
// through the strides it is given: the engine hands in permuted views of
// the (pop, dim) OpenES population, so no copy of the population is made.
// The observation, the activations and the scratch of the reductions sit
// beside it (~2 KB), so two blocks share an SM (227 KB per block at most;
// kernels/rollout_mlp.py::fused_rollout_analysis reports the budget).
// The MLP runs one output per thread (64 threads at the main path's
// widths), each dot product a sequential chain over its inputs read from
// shared memory (w[k][j] by thread j: no bank conflicts, h[k] broadcast).
// The physics runs one mass per lane of warp 0 (at most 32 masses); link
// quantities come from the neighbouring lane by shuffle. The block exits
// as soon as its env is done: finer than the TPU kernel's per-tile exit,
// with the same totals. The TPU kernel's 128-individual VMEM tiles, its
// packed while-loop carry and its padding have no counterpart here.
//
// What bounds it on an H100. Per live env-step ~41.9k operations of the
// MLP (2 per multiply-add) and ~8k of observation and physics; at 65536
// envs x up to 100 steps that is ~3.3e11 operations, ~5 ms at 67 TFLOP/s.
// The weights are read from device memory once (5.5 GB, 1.6 ms at 3.35
// TB/s). This first kernel is far from either: each dot product is a
// dependent chain of adds (-fmad=false, sequential order), two blocks of
// two warps per SM leave little to hide the latency with, and the block
// re-reads its 83.8 KB policy from shared memory every step (~18 ms at
// 128 B/clk per SM). PERF.md has its measured time.
//
// Numerics. Compiled without --use_fast_math and with -fmad=false
// (kernels/_build.py): every operation rounds on its own, in the order of
// the plain PyTorch version (kernels/rollout_mlp.py::fused_mlp_rollout_plain,
// which fixes each order of summation), with the libdevice calls PyTorch's
// CUDA ops use (tanhf, rsqrtf for torch.rsqrt, IEEE division). Maximum and
// minimum propagate NaN as torch.maximum/minimum do, sign keeps NaN as
// jnp.sign does, and the exploded test sees a NaN state as exploded. The
// two agree bit for bit.
//
// C interface (loaded with ctypes): evox_fused_mlp_rollout takes three
// host arrays (integers, walker constants, device pointers; layouts below)
// and returns cudaGetLastError() after the launch; 0 means launched.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxMasses = 32;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int n_layers;
  int fan[kMaxLayers + 1];  // obs, hidden..., act
  int linear_mask;          // bit l: no tanh after layer l
  int n, T;
  int n_masses, act_dim, substeps;
  // shared-memory offsets in floats (kernels/rollout_mlp.py::_smem_plan)
  int w_off[kMaxLayers], b_off[kMaxLayers], h_off[kMaxLayers + 1], scratch_off;
  // element strides: w[l] is (fan_in, fan_out, n), b[l] is (fan_out, n)
  long long w_sk[kMaxLayers], w_sj[kMaxLayers], w_si[kMaxLayers];
  long long b_sj[kMaxLayers], b_si[kMaxLayers];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* planes;  // (4N + A + 2, envs): px, py, vx, vy, pa, t, done
  float* out;           // (envs,)
  long long envs;       // episodes * n
  // walker constants, rounded to float32 as the plain version's scalars are
  float h, rod_length, inv_rod_length, rod_stiffness, rod_damping, torque_scale,
      ground_stiffness, ground_damping, friction, gravity, stand_height, max_steps, n_masses_f;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// torch.maximum / torch.minimum on the card: a NaN argument wins (fmaxf and
// fminf alone would drop it), else fmaxf / fminf
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// jnp.sign: +-1, +-0 kept, NaN kept
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// per-link force -> per-mass: +f on the link's lower mass, -f on its upper
// (the plain version's cat([f, 0]) - cat([0, f])); all 32 lanes call it
__device__ __forceinline__ float pad_ends(float f, int m, int links) {
  const float prev = __shfl_up_sync(kFull, f, 1);
  const float lo = m < links ? f : 0.0f;
  const float hi = m > 0 ? prev : 0.0f;
  return lo - hi;
}

// action-independent contact normal force on one mass
__device__ __forceinline__ float ground(const Params& p, float py, float vy) {
  const float depth = nan_max(-py, 0.0f);
  const float contact = depth > 0.0f ? 1.0f : 0.0f;
  const float fn = p.ground_stiffness * depth - p.ground_damping * vy * contact;
  return nan_max(fn, 0.0f) * contact;
}

// warp 0: the observation (obs_planes' row order) into shared memory;
// rows past obs_dim are dropped, rows past the walker's own are zero (set once)
__device__ __forceinline__ void walker_obs(const Params& p, float* obs, const float* pa,
                                           float px, float py, float vx, float vy) {
  const int m = threadIdx.x;
  const int N = p.n_masses, L = N - 1, A = p.act_dim, D = p.fan[0];
  const float px0 = __shfl_sync(kFull, px, 0);
  const float py0 = __shfl_sync(kFull, py, 0);
  const float head = __shfl_sync(kFull, py, N - 1);
  const float px1 = __shfl_down_sync(kFull, px, 1);
  const float py1 = __shfl_down_sync(kFull, py, 1);
  const float vx1 = __shfl_down_sync(kFull, vx, 1);
  const float vy1 = __shfl_down_sync(kFull, vy, 1);
  if (m >= N) return;
  auto put = [&](int row, float value) {
    if (row < D) obs[row] = value;
  };
  put(2 * m, px - px0);
  put(2 * m + 1, py - py0);
  put(2 * N + 2 * m, vx);
  put(2 * N + 2 * m + 1, vy);
  if (m < L) {
    const float dx = px1 - px, dy = py1 - py;
    const float dd = dx * dx + dy * dy + 1e-12f;
    const float inv = rsqrtf(dd);
    const float rvx = vx1 - vx, rvy = vy1 - vy;
    put(4 * N + m, dx * inv);
    put(4 * N + L + m, dy * inv);
    put(4 * N + 2 * L + m, (dx * rvy - dy * rvx) * (inv * inv));
    put(4 * N + 3 * L + m, dd * inv * p.inv_rod_length - 1.0f);
  }
  put(4 * N + 4 * L + m, ground(p, py, vy) * 0.01f);
  if (m < A) put(5 * N + 4 * L + m, pa[m]);
  if (m == 0) {
    const int g = 5 * N + 4 * L + A;
    put(g, py);
    put(g + 1, head);
    put(g + 2, vx);
    put(g + 3, vy);
  }
}

// all threads: the MLP from the observation to the action, in the plain
// version's order (start from the bias, add h[k] * w[k][j] for k = 0, 1, ...)
__device__ __forceinline__ void mlp(const Params& p, float* smem) {
  for (int l = 0; l < p.n_layers; ++l) {
    const int fi = p.fan[l], fo = p.fan[l + 1];
    const float* W = smem + p.w_off[l];
    const float* B = smem + p.b_off[l];
    const float* hin = smem + p.h_off[l];
    float* hout = smem + p.h_off[l + 1];
    const bool squash = l < p.n_layers - 1 && !((p.linear_mask >> l) & 1);
    for (int j = threadIdx.x; j < fo; j += blockDim.x) {
      float acc = B[j];
      const float* wj = W + j;
#pragma unroll 8
      for (int k = 0; k < fi; ++k) acc = acc + hin[k] * wj[k * fo];
      hout[j] = squash ? tanhf(acc) : acc;
    }
    __syncthreads();
  }
}

// warp 0: one env step from the action in shared memory; lane 0 keeps the
// return and the step counter and raises the done flag
__device__ __forceinline__ void walker_step(const Params& p, const float* act, float* sq,
                                            float* vxs, float* flag, float& px, float& py,
                                            float& vx, float& vy, float& t, float& total) {
  const int m = threadIdx.x;
  const int N = p.n_masses, L = N - 1, A = p.act_dim;
  const float ta = tanhf(m < A ? act[m] : 0.0f);  // substep-invariant
  const float tq = m < A ? ta * p.torque_scale : 0.0f;
  if (m < A) sq[m] = ta * ta;
  for (int s = 0; s < p.substeps; ++s) {
    const float px1 = __shfl_down_sync(kFull, px, 1);
    const float py1 = __shfl_down_sync(kFull, py, 1);
    const float vx1 = __shfl_down_sync(kFull, vx, 1);
    const float vy1 = __shfl_down_sync(kFull, vy, 1);
    const float dx = px1 - px, dy = py1 - py;
    const float dd = dx * dx + dy * dy + 1e-12f;
    const float inv = rsqrtf(dd);
    const float dist = dd * inv;
    const float ux = dx * inv, uy = dy * inv;
    const float rel_v = (vx1 - vx) * ux + (vy1 - vy) * uy;
    const float mag = p.rod_stiffness * (dist - p.rod_length) + p.rod_damping * rel_v;
    float fx = pad_ends(mag * ux, m, L);
    float fy = -p.gravity + pad_ends(mag * uy, m, L);
    const float coef = tq * nan_min(inv, 1e6f);
    fx = fx + pad_ends(coef * -uy, m, L);
    fy = fy + pad_ends(coef * ux, m, L);
    const float fn = ground(p, py, vy);
    const float lim = fabsf(vx) * 50.0f;
    const float ft = -nan_min(nan_max(p.friction * fn * sign_of(vx), -lim), lim);
    fx = fx + ft;
    fy = fy + fn;
    vx = vx + p.h * fx;
    vy = vy + p.h * fy;
    px = px + p.h * vx;
    py = py + p.h * vy;
  }
  if (m < N) vxs[m] = vx;
  const float head = __shfl_sync(kFull, py, N - 1);
  // exploded: a non-finite or |coordinate| > 1e3 on any mass (NaN fails <=)
  const bool wild = m < N && !(fabsf(px) <= 1e3f && fabsf(py) <= 1e3f);
  const bool exploded = __any_sync(kFull, wild);
  __syncwarp();
  if (m == 0) {
    float sv = vxs[0];
    for (int q = 1; q < N; ++q) sv = sv + vxs[q];
    float sc = sq[0];
    for (int q = 1; q < A; ++q) sc = sc + sq[q];
    const float reward = sv / p.n_masses_f + 1.0f - 0.01f * sc;
    total = total + reward;
    t = t + 1.0f;
    if (head < p.stand_height || exploded || t >= p.max_steps) flag[0] = 1.0f;
  }
}

// __grid_constant__: the device functions take p by reference and index its
// arrays at run time, which would otherwise copy it to local memory
__global__ void __launch_bounds__(kMaxThreads)
    mlp_rollout_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  const long long env = (long long)blockIdx.y * p.n + i;

  // 1. individual i's policy into shared memory, through its strides
  for (int l = 0; l < p.n_layers; ++l) {
    const int fo = p.fan[l + 1];
    const int count = p.fan[l] * fo;
    const float* src = p.w[l] + (long long)i * p.w_si[l];
    float* dst = smem + p.w_off[l];
    int k = tid / fo, j = tid - (tid / fo) * fo;
    for (int idx = tid; idx < count; idx += blockDim.x) {
      cp_async4(dst + idx, src + k * p.w_sk[l] + j * p.w_sj[l]);
      j += blockDim.x;
      while (j >= fo) {
        j -= fo;
        ++k;
      }
    }
    const float* bsrc = p.b[l] + (long long)i * p.b_si[l];
    for (int jj = tid; jj < fo; jj += blockDim.x) {
      cp_async4(smem + p.b_off[l] + jj, bsrc + jj * p.b_sj[l]);
    }
  }

  const int N = p.n_masses, L = N - 1, A = p.act_dim;
  float* obs = smem + p.h_off[0];
  float* act = smem + p.h_off[p.n_layers];  // the action, then the previous action
  float* sq = smem + p.scratch_off;         // tanh(action)^2, by action
  float* vxs = sq + 32;                     // vx, by mass
  float* flag = vxs + 32;                   // done, 0 or 1
  for (int r = 5 * N + 4 * L + A + 4 + tid; r < p.fan[0]; r += blockDim.x) obs[r] = 0.0f;

  // 2. the env state: one mass per lane of warp 0
  float px = 0.0f, py = 0.0f, vx = 0.0f, vy = 0.0f, t = 0.0f, total = 0.0f;
  if (tid < 32) {
    const float* s0 = p.planes + env;
    if (tid < N) {
      px = s0[(long long)tid * p.envs];
      py = s0[(long long)(N + tid) * p.envs];
      vx = s0[(long long)(2 * N + tid) * p.envs];
      vy = s0[(long long)(3 * N + tid) * p.envs];
    }
    if (tid < A) act[tid] = s0[(long long)(4 * N + tid) * p.envs];
    if (tid == 0) {
      t = s0[(long long)(4 * N + A) * p.envs];
      flag[0] = s0[(long long)(4 * N + A + 1) * p.envs] > 0.5f ? 1.0f : 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. the episode; the flag is block-uniform between barriers
  for (int step = 0; step < p.T; ++step) {
    if (flag[0] != 0.0f) break;
    if (tid < 32) walker_obs(p, obs, act, px, py, vx, vy);
    __syncthreads();
    mlp(p, smem);  // ends with a barrier: the action is in place
    if (tid < 32) walker_step(p, act, sq, vxs, flag, px, py, vx, vy, t, total);
    __syncthreads();
  }
  if (tid == 0) p.out[env] = total;
}

// layouts of the three host arrays
constexpr int kInts = 49;    // see the parsing below
constexpr int kFloats = 13;  // h, rod_length, 1/rod_length, rod_stiffness, rod_damping,
                             // torque_scale, ground_stiffness, ground_damping, friction,
                             // gravity, stand_height, max_steps, n_masses
constexpr int kPtrs = 10;    // w[0..3], b[0..3], planes, out

}  // namespace

extern "C" int evox_fused_mlp_rollout(const long long* ints, int n_ints, const float* floats,
                                      int n_floats, const void* const* ptrs, int n_ptrs,
                                      void* stream) {
  if (n_ints != kInts || n_floats != kFloats || n_ptrs != kPtrs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  int at = 0;
  p.n_layers = static_cast<int>(ints[at++]);
  for (int l = 0; l <= kMaxLayers; ++l) p.fan[l] = static_cast<int>(ints[at++]);
  p.linear_mask = static_cast<int>(ints[at++]);
  const long long n = ints[at++];
  const long long episodes = ints[at++];
  p.T = static_cast<int>(ints[at++]);
  p.n_masses = static_cast<int>(ints[at++]);
  p.act_dim = static_cast<int>(ints[at++]);
  p.substeps = static_cast<int>(ints[at++]);
  const int threads = static_cast<int>(ints[at++]);
  const long long smem_bytes = ints[at++];
  for (int l = 0; l < kMaxLayers; ++l) p.w_off[l] = static_cast<int>(ints[at++]);
  for (int l = 0; l < kMaxLayers; ++l) p.b_off[l] = static_cast<int>(ints[at++]);
  for (int l = 0; l <= kMaxLayers; ++l) p.h_off[l] = static_cast<int>(ints[at++]);
  p.scratch_off = static_cast<int>(ints[at++]);
  for (int l = 0; l < kMaxLayers; ++l) p.w_sk[l] = ints[at++];
  for (int l = 0; l < kMaxLayers; ++l) p.w_sj[l] = ints[at++];
  for (int l = 0; l < kMaxLayers; ++l) p.w_si[l] = ints[at++];
  for (int l = 0; l < kMaxLayers; ++l) p.b_sj[l] = ints[at++];
  for (int l = 0; l < kMaxLayers; ++l) p.b_si[l] = ints[at++];
  const float* f = floats;
  p.h = f[0];
  p.rod_length = f[1];
  p.inv_rod_length = f[2];
  p.rod_stiffness = f[3];
  p.rod_damping = f[4];
  p.torque_scale = f[5];
  p.ground_stiffness = f[6];
  p.ground_damping = f[7];
  p.friction = f[8];
  p.gravity = f[9];
  p.stand_height = f[10];
  p.max_steps = f[11];
  p.n_masses_f = f[12];
  for (int l = 0; l < kMaxLayers; ++l) {
    p.w[l] = static_cast<const float*>(ptrs[l]);
    p.b[l] = static_cast<const float*>(ptrs[kMaxLayers + l]);
  }
  p.planes = static_cast<const float*>(ptrs[2 * kMaxLayers]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[2 * kMaxLayers + 1]));

  bool ok = at == kInts && p.n_layers >= 1 && p.n_layers <= kMaxLayers && p.n_masses >= 3 &&
            p.n_masses <= kMaxMasses && p.act_dim >= 1 && p.act_dim < p.n_masses - 1 &&
            p.act_dim == p.fan[p.n_layers] && p.substeps >= 0 && p.T >= 0 && n >= 1 &&
            n <= 0x7fffffffLL && episodes >= 1 && episodes <= 65535 && threads >= 32 &&
            threads <= kMaxThreads && threads % 32 == 0 && smem_bytes > 0 &&
            smem_bytes <= 232448;
  for (int l = 0; ok && l <= p.n_layers; ++l) ok = p.fan[l] >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.n = static_cast<int>(n);
  p.envs = n * episodes;

  cudaError_t err = cudaFuncSetAttribute(mlp_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(episodes));
  mlp_rollout_kernel<<<grid, threads, static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
