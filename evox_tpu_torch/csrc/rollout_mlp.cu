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
// its individual's policy into dynamic shared memory once, with cp.async,
// reading the weights through the strides it is given (the engine hands in
// permuted views of the (pop, dim) OpenES population; no copy of it is
// made). Each layer's weights are stored as [k/4][j][k%4], so a thread
// reads four of its output's weights with one 16-byte load and a quarter
// warp reads 128 contiguous bytes (no bank conflict); the activations are
// read as 16-byte broadcasts.
// - Split dot products. Output j's sum over k is cut into S slices of
//   whole quads of k (slice s: quads [Q s / S, Q (s+1) / S), Q =
//   ceil(fan_in / 4); S = 4, 2 or 1, the most that leaves no slice empty).
//   Lane s * G + jl of a warp (G = 32 / S outputs a warp) adds slice s of
//   its output in k order, slice 0 from the bias and the others from -0.0
//   (an exact identity: -0.0 + x is x for every x, -0.0 too); the slices
//   combine by a butterfly of __shfl_xor_sync, (s0 + s1) + (s2 + s3), the
//   same expression in every lane (IEEE addition commutes). Layer 0's chain
//   at the main path's widths is 15 or 16 quads a lane, 60 to 64 dependent
//   adds and two of the tree, where the first version added all 244 in one
//   thread; loads go four quads (dense) or two (dense0_main) ahead of their
//   adds.
// - Two instances. The generic one keeps every layer in shared memory,
//   one output a thread (up to 256 threads, two blocks an SM at the main
//   path's widths). The one built for the main path's policy (244-64-64-17,
//   tanh, tanh) runs 128 threads, each with two outputs, j and j + 32, of
//   the same slice (one activation load feeds both chains), and holds in
//   registers layer 1's 64 x 64 weights and the last three quads of each
//   slice of layer 0: 56 weights a thread, loaded once per episode. Its
//   block needs 56944 bytes of shared memory, so four blocks (16 warps)
//   share an SM, where the first version fitted two blocks of two warps;
//   __launch_bounds__ holds it to 128 registers a thread.
//   kernels/rollout_mlp.py::_smem_plan chooses the instance and the layout,
//   and fused_rollout_analysis reports the budget.
// - Two residencies (the JAX kernel's weight_dtype). Each instance is built
//   for float and for __nv_bfloat16 weights (Wt). With bf16 the copy-in reads
//   the float32 planes it is given with plain loads (cp.async cannot
//   convert) and stores each weight and bias rounded to nearest even
//   (__float2bfloat16_rn), so the population is never cast in device
//   memory; the block's policy takes half the shared memory (29392 bytes
//   at the main path's widths, against 56944), a quad of weights is one
//   8-byte load widened to four floats by shifts (exact), and the main
//   instance's register-held weights are rounded and widened once, at
//   copy-in. Sums, their order and the physics are the float instance's.
// - The walker's physics runs on warp 0, one mass per lane (at most 32),
//   link quantities from the neighbouring lane by shuffle. After the
//   substeps warp 0 leaves the reward's terms in shared memory for warp 1,
//   which is idle by then and sums them in index order while warp 0 tests
//   for done (head height, explosion, time limit) and builds the next
//   observation from the state in its registers.
// - Barriers per step: one after each layer but the last, one that only
//   the warps computing the action and warp 0 meet, one that hands the
//   reward to warp 1 (bar.arrive / bar.sync), and one that ends the step and
//   carries the done flag (__syncthreads_or). The block exits at its env's
//   own done: finer than the TPU kernel's per-tile exit, with the same
//   totals. The TPU kernel's 128-individual VMEM tiles, its packed
//   while-loop carry and its padding have no counterpart here.
//
// What bounds it on an H100. Per live env-step ~41.9k operations of the
// MLP (2 per multiply-add) and ~8k of observation and physics; the main
// path's 4.9M live env-steps need ~2.5e11, 3.7 ms at 67 TFLOP/s; the
// weights are read from device memory once (5.5 GB, 1.65 ms at 3.35 TB/s).
// What stands between the kernel and that bound is latency: a step is a
// chain (three layers, five substeps of physics on one warp, the
// observation, barriers) that no other warp of the block can overlap, so an
// SM hides it only across its four blocks, and shared memory (its 228 KB
// hold four envs' policies) sets that count. Shared-memory bandwidth is
// below it: every step re-reads ~54 KB of weights and, counting a 16-byte
// broadcast at a warp's 512 B, ~46 KB of activations, ~780 clocks of an
// SM's 128 B a clock, against ~1,570 clocks an env-step an SM measured.
// PERF.md has the measured time and the phase split of a step.
//
// Numerics. Compiled without --use_fast_math and with -fmad=false
// (kernels/_build.py): every operation rounds on its own, in the order of
// the plain PyTorch version (kernels/rollout_mlp.py::fused_mlp_rollout_plain
// and _mlp_planes, which fix each order of summation from the same slice
// plan), with the libdevice calls PyTorch's CUDA ops use (tanhf, rsqrtf for
// torch.rsqrt, IEEE division). Maximum and minimum propagate NaN as
// torch.maximum/minimum do, sign keeps NaN as jnp.sign does, and the
// exploded test sees a NaN state as exploded. The two agree bit for bit.
//
// C interface (loaded with ctypes): evox_fused_mlp_rollout takes three
// host arrays (integers, walker constants, device pointers; layouts below)
// and returns the launch's error (cudaLaunchKernel's); 0 means launched.
// evox_mlp_rollout_blocks_per_sm reports the runtime's occupancy of an
// instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxMasses = 32;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// the main instance: 244-64-64-17, 4 slices a layer, 128 threads (two
// outputs a thread), 4 blocks an SM; layer 1's weights in registers (16 x 2
// a thread), and the last kMainRegQuads quads of each slice of layer 0
// (3 x 2 x 4 a thread); layer 0's other 49 quads in shared memory, quad q
// of slice s at row q - 3 s
constexpr int kMainIn = 244, kMainHidden = 64, kMainOut = 17;
constexpr int kMainFan[4] = {kMainIn, kMainHidden, kMainHidden, kMainOut};
constexpr int kMainThreads = 128;
constexpr int kMainBlocksPerSM = 4;
constexpr int kMainQuads = kMainIn / 4;  // 61
constexpr int kMainRegQuads = 3;

struct Params {
  int n_layers;
  int fan[kMaxLayers + 1];  // obs, hidden..., act
  int slices[kMaxLayers];   // S of each layer: 1, 2 or 4
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

// named barrier `id` of `count` threads: wait for it, or only arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The resident policy's element type Wt: float, or __nv_bfloat16 for the
// bf16 residency (weights and biases rounded to nearest even at copy-in,
// as the plain version's .to(torch.bfloat16) rounds; widened back to float
// where they are read, which is exact). Everything else is float.
// A quad [k/4][j][k%4] of weights at quad index q, widened.
__device__ __forceinline__ float4 load_quad(const float* W, int q) {
  return reinterpret_cast<const float4*>(W)[q];
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* W, int q) {
  const uint2 u = reinterpret_cast<const uint2*>(W)[q];  // element 0 in the low half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load_one(const float* B, int j) { return B[j]; }

__device__ __forceinline__ float load_one(const __nv_bfloat16* B, int j) {
  return __bfloat162float(B[j]);
}

// one element of the policy into shared memory: float by cp.async; bf16
// by a plain load and a rounding store (cp.async cannot convert)
__device__ __forceinline__ void copy_in(float* dst, const float* src) { cp_async4(dst, src); }

__device__ __forceinline__ void copy_in(__nv_bfloat16* dst, const float* src) {
  *dst = __float2bfloat16_rn(__ldg(src));
}

// the resident weights or biases at offset `off` (in floats) of shared memory
template <typename Wt>
__device__ __forceinline__ const Wt* region(const float* smem, int off) {
  return reinterpret_cast<const Wt*>(smem + off);
}

// a register-held weight as the residency holds it
template <typename Wt>
__device__ __forceinline__ float resident(float x) {
  return x;
}

template <>
__device__ __forceinline__ float resident<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.maximum / torch.minimum on the card: a NaN argument wins (fmaxf and
// fminf alone would drop it), else fmaxf / fminf
// (selects, no branch)
__device__ __forceinline__ float nan_max(float a, float b) {
  const float r = fmaxf(a, b);
  return a != a ? a : (b != b ? b : r);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  const float r = fminf(a, b);
  return a != a ? a : (b != b ? b : r);
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

// warp 0: the observation (obs_planes' row order) into shared memory from
// the state in registers; pa is lane m's previous action (m < A); rows past
// obs_dim are dropped, rows past the walker's own are zero (set once)
__device__ __forceinline__ void walker_obs(const Params& p, float* obs, float pa, float px,
                                           float py, float vx, float vy) {
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
  if (m < A) put(5 * N + 4 * L + m, pa);
  if (m == 0) {
    const int g = 5 * N + 4 * L + A;
    put(g, py);
    put(g + 1, head);
    put(g + 2, vx);
    put(g + 3, vy);
  }
}

// all threads: one layer, hout[j] = f(b[j] + sum_k hin[k] w[k][j]) for j <
// fo, in the slice order of the header (W is [k/4][j][k%4], hin and W
// 16-byte aligned, hin padded to whole quads)
template <typename Wt>
__device__ __forceinline__ void dense(const Wt* W, const Wt* B, const float* hin,
                                      float* hout, int fi, int fo, int S, bool squash) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int G = 32 / S;
  const int s = lane / G, jl = lane - s * G;
  const int Q = (fi + 3) >> 2;
  const int qa = Q * s / S, qb = Q * (s + 1) / S;
  const int qfull = min(qb, fi >> 2);  // a short last quad is added on its own
  const float4* h4 = reinterpret_cast<const float4*>(hin);
  for (int jb = warp * G; jb < fo; jb += nwarps * G) {  // warp-uniform
    const int j = jb + jl;
    float acc = -0.0f;
    if (j < fo) {
      if (s == 0) acc = load_one(B, j);
      int q = qa;
      for (; q + 4 <= qfull; q += 4) {  // four quads' loads ahead of their adds
        float4 x[4], w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = h4[q + u];
          w[u] = load_quad(W, (q + u) * fo + j);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = acc + x[u].x * w[u].x;
          acc = acc + x[u].y * w[u].y;
          acc = acc + x[u].z * w[u].z;
          acc = acc + x[u].w * w[u].w;
        }
      }
      for (; q < qfull; ++q) {
        const float4 x = h4[q];
        const float4 w = load_quad(W, q * fo + j);
        acc = acc + x.x * w.x;
        acc = acc + x.y * w.y;
        acc = acc + x.z * w.z;
        acc = acc + x.w * w.w;
      }
      if (qfull < qb) {
        const float4 x = h4[qfull];
        const float4 w = load_quad(W, qfull * fo + j);
        const int rem = fi - 4 * qfull;
        acc = acc + x.x * w.x;
        if (rem > 1) acc = acc + x.y * w.y;
        if (rem > 2) acc = acc + x.z * w.z;
      }
    }
    if (S >= 2) acc = acc + __shfl_xor_sync(kFull, acc, G);
    if (S >= 4) acc = acc + __shfl_xor_sync(kFull, acc, 2 * G);
    if (j < fo && s == 0) hout[j] = squash ? tanhf(acc) : acc;
  }
}

// the main instance's slice bounds of layer 0: slice s takes quads
// [61 s / 4, 61 (s + 1) / 4)
__device__ __forceinline__ int main_qa(int s) { return kMainQuads * s / 4; }

// the main instance's layer 0 (244 -> 64, tanh): thread (jp, s) = (warp * 8
// + lane % 8, lane / 8) sums slice s of outputs jp and jp + 32, two chains
// in k order: the slice's quads from shared memory, then its last three
// from registers (wr[t][o][r]: quad qb - 3 + t, output jp + 32 o); the same
// slices and tree as dense()
template <typename Wt>
__device__ __forceinline__ void dense0_main(const Wt* W, const Wt* B, const float* hin,
                                            float* hout,
                                            const float (&wr)[kMainRegQuads][2][4]) {
  const int lane = threadIdx.x & 31;
  const int s = lane >> 3, jp = (threadIdx.x >> 5) * 8 + (lane & 7);
  const int qa = main_qa(s), qr = main_qa(s + 1) - kMainRegQuads;
  const float4* h4 = reinterpret_cast<const float4*>(hin);
  int w4 = (qa - kMainRegQuads * s) * kMainHidden;  // quad index of row q's output 0
  float a0 = s == 0 ? load_one(B, jp) : -0.0f;
  float a1 = s == 0 ? load_one(B, jp + 32) : -0.0f;
  int q = qa;
  for (; q + 2 <= qr; q += 2, w4 += 2 * kMainHidden) {  // two quads' loads ahead
    float4 x[2], u[2], v[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      x[t] = h4[q + t];
      u[t] = load_quad(W, w4 + t * kMainHidden + jp);
      v[t] = load_quad(W, w4 + t * kMainHidden + jp + 32);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      a0 = a0 + x[t].x * u[t].x;
      a1 = a1 + x[t].x * v[t].x;
      a0 = a0 + x[t].y * u[t].y;
      a1 = a1 + x[t].y * v[t].y;
      a0 = a0 + x[t].z * u[t].z;
      a1 = a1 + x[t].z * v[t].z;
      a0 = a0 + x[t].w * u[t].w;
      a1 = a1 + x[t].w * v[t].w;
    }
  }
  if (q < qr) {
    const float4 x = h4[q], u = load_quad(W, w4 + jp), v = load_quad(W, w4 + jp + 32);
    a0 = a0 + x.x * u.x;
    a1 = a1 + x.x * v.x;
    a0 = a0 + x.y * u.y;
    a1 = a1 + x.y * v.y;
    a0 = a0 + x.z * u.z;
    a1 = a1 + x.z * v.z;
    a0 = a0 + x.w * u.w;
    a1 = a1 + x.w * v.w;
  }
#pragma unroll
  for (int t = 0; t < kMainRegQuads; ++t) {
    const float4 x = h4[qr + t];
    a0 = a0 + x.x * wr[t][0][0];
    a1 = a1 + x.x * wr[t][1][0];
    a0 = a0 + x.y * wr[t][0][1];
    a1 = a1 + x.y * wr[t][1][1];
    a0 = a0 + x.z * wr[t][0][2];
    a1 = a1 + x.z * wr[t][1][2];
    a0 = a0 + x.w * wr[t][0][3];
    a1 = a1 + x.w * wr[t][1][3];
  }
  a0 = a0 + __shfl_xor_sync(kFull, a0, 8);
  a1 = a1 + __shfl_xor_sync(kFull, a1, 8);
  a0 = a0 + __shfl_xor_sync(kFull, a0, 16);
  a1 = a1 + __shfl_xor_sync(kFull, a1, 16);
  if (s == 0) {
    hout[jp] = tanhf(a0);
    hout[jp + 32] = tanhf(a1);
  }
}

// the main instance's layer 1 (64 -> 64, tanh): thread (jp, s) holds
// w[16 s + t][jp + 32 o] in w[t][o]; the same slices and tree as dense()
template <typename Wt>
__device__ __forceinline__ void dense1_main(const float (&w)[16][2], const Wt* B,
                                            const float* hin, float* hout) {
  const int lane = threadIdx.x & 31;
  const int s = lane >> 3, jp = (threadIdx.x >> 5) * 8 + (lane & 7);
  const float4* h4 = reinterpret_cast<const float4*>(hin) + 4 * s;
  float a0 = s == 0 ? load_one(B, jp) : -0.0f;
  float a1 = s == 0 ? load_one(B, jp + 32) : -0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = h4[q];
    a0 = a0 + x.x * w[4 * q][0];
    a1 = a1 + x.x * w[4 * q][1];
    a0 = a0 + x.y * w[4 * q + 1][0];
    a1 = a1 + x.y * w[4 * q + 1][1];
    a0 = a0 + x.z * w[4 * q + 2][0];
    a1 = a1 + x.z * w[4 * q + 2][1];
    a0 = a0 + x.w * w[4 * q + 3][0];
    a1 = a1 + x.w * w[4 * q + 3][1];
  }
  a0 = a0 + __shfl_xor_sync(kFull, a0, 8);
  a1 = a1 + __shfl_xor_sync(kFull, a1, 8);
  a0 = a0 + __shfl_xor_sync(kFull, a0, 16);
  a1 = a1 + __shfl_xor_sync(kFull, a1, 16);
  if (s == 0) {
    hout[jp] = tanhf(a0);
    hout[jp + 32] = tanhf(a1);
  }
}

// warp 0: one env step from the action in shared memory; hands the
// reward's terms to the reward warp (rw: vx by mass, then tanh(action)^2 by
// action; `handoff`: that warp is another one, else warp 0 reads them
// itself), then builds the next observation; returns done (the same in
// every lane)
__device__ __forceinline__ bool walker_step(const Params& p, const float* act, float* obs,
                                            float* rw, bool handoff, float& px, float& py,
                                            float& vx, float& vy, float& t) {
  const int m = threadIdx.x;
  const int N = p.n_masses, L = N - 1, A = p.act_dim;
  const float a = m < A ? act[m] : 0.0f;
  const float ta = tanhf(a);  // substep-invariant
  const float tq = m < A ? ta * p.torque_scale : 0.0f;
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
  if (m < N) rw[m] = vx;
  if (m < A) rw[kMaxMasses + m] = ta * ta;
  if (handoff) {
    bar_arrive(2, 64);
  } else {
    __syncwarp();
  }
  const float head = __shfl_sync(kFull, py, N - 1);
  // exploded: a non-finite or |coordinate| > 1e3 on any mass (NaN fails <=)
  const bool wild = m < N && !(fabsf(px) <= 1e3f && fabsf(py) <= 1e3f);
  const bool exploded = __any_sync(kFull, wild);
  t = t + 1.0f;
  const bool done = head < p.stand_height || exploded || t >= p.max_steps;
  walker_obs(p, obs, a, px, py, vx, vy);
  return done;
}

// the reward warp: one step's reward from the terms walker_step left in rw,
// the mean vx and the squared actions summed in index order (_ordered_sum);
// the loads are independent, only the adds chain
__device__ __forceinline__ float walker_reward(const Params& p, const float* rw) {
  const int N = p.n_masses, A = p.act_dim;
  float sv = rw[0];
  float sc = rw[kMaxMasses];
#pragma unroll
  for (int q = 1; q < kMaxMasses; ++q) {
    if (q < N) sv = sv + rw[q];
    if (q < A) sc = sc + rw[kMaxMasses + q];
  }
  return sv / p.n_masses_f + 1.0f - 0.01f * sc;
}

// __grid_constant__: the device functions take p by reference and index its
// arrays at run time, which would otherwise copy it to local memory
template <bool kMain, typename Wt>
__global__ void __launch_bounds__(kMain ? kMainThreads : kMaxThreads,
                                  kMain ? kMainBlocksPerSM : 2)
    mlp_rollout_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x;
  const long long env = (long long)blockIdx.y * p.n + i;

  // 1. individual i's policy, through its strides: weights to shared memory
  // as [k/4][j][k%4] (the main instance: its register-held quads of layer 0
  // and layer 1 to registers), biases; rounded to Wt on the way
  for (int l = 0; l < p.n_layers; ++l) {
    const int fo = p.fan[l + 1];
    const float* bsrc = p.b[l] + (long long)i * p.b_si[l];
    Wt* bdst = reinterpret_cast<Wt*>(smem + p.b_off[l]);
    for (int jj = tid; jj < fo; jj += blockDim.x) {
      copy_in(bdst + jj, bsrc + jj * p.b_sj[l]);
    }
    if (kMain && l == 1) continue;
    const int count = p.fan[l] * fo;
    const float* src = p.w[l] + (long long)i * p.w_si[l];
    Wt* dst = reinterpret_cast<Wt*>(smem + p.w_off[l]);
    const int dk = blockDim.x / fo, dj = blockDim.x - dk * fo;
    int k = tid / fo, j = tid - (tid / fo) * fo;
    for (int idx = tid; idx < count; idx += blockDim.x) {
      int row = k >> 2;
      if (kMain && l == 0) {  // rows of the quads held in shared memory
        const int s = (row >= main_qa(1)) + (row >= main_qa(2)) + (row >= main_qa(3));
        row = row < main_qa(s + 1) - kMainRegQuads ? row - kMainRegQuads * s : -1;
      }
      if (row >= 0) copy_in(dst + ((row * fo + j) << 2) + (k & 3), src + k * p.w_sk[l] + j * p.w_sj[l]);
      k += dk;
      j += dj;
      if (j >= fo) {
        j -= fo;
        ++k;
      }
    }
  }
  float w0r[kMainRegQuads][2][4], w1r[16][2];
  if (kMain) {
    const int s = lane >> 3, jp = warp * 8 + (lane & 7);
    const int q0 = main_qa(s + 1) - kMainRegQuads;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float* src0 = p.w[0] + (long long)i * p.w_si[0] + (jp + 32 * o) * p.w_sj[0];
#pragma unroll
      for (int t = 0; t < kMainRegQuads; ++t) {
#pragma unroll
        for (int r = 0; r < 4; ++r) w0r[t][o][r] = resident<Wt>(src0[(4 * (q0 + t) + r) * p.w_sk[0]]);
      }
      const float* src1 = p.w[1] + (long long)i * p.w_si[1] + (jp + 32 * o) * p.w_sj[1];
#pragma unroll
      for (int t = 0; t < 16; ++t) w1r[t][o] = resident<Wt>(src1[(16 * s + t) * p.w_sk[1]]);
    }
  }

  const int N = p.n_masses, L = N - 1, A = p.act_dim, n_layers = p.n_layers;
  float* obs = smem + p.h_off[0];
  const float* act = smem + p.h_off[n_layers];
  float* rw = smem + p.scratch_off;
  const int nwarps = blockDim.x >> 5;
  for (int r = 5 * N + 4 * L + A + 4 + tid; r < p.fan[0]; r += blockDim.x) obs[r] = 0.0f;
  // the warps that compute the action (warp 0 among them)
  const int g_last = 32 / p.slices[n_layers - 1];
  const int n_last = min(nwarps, (p.fan[n_layers] + g_last - 1) / g_last);

  // 2. the env state: one mass per lane of warp 0, and the first observation
  float px = 0.0f, py = 0.0f, vx = 0.0f, vy = 0.0f, t = 0.0f, total = 0.0f;
  bool done0 = false;
  if (warp == 0) {
    const float* s0 = p.planes + env;
    if (lane < N) {
      px = s0[(long long)lane * p.envs];
      py = s0[(long long)(N + lane) * p.envs];
      vx = s0[(long long)(2 * N + lane) * p.envs];
      vy = s0[(long long)(3 * N + lane) * p.envs];
    }
    const float pa = lane < A ? s0[(long long)(4 * N + lane) * p.envs] : 0.0f;
    t = s0[(long long)(4 * N + A) * p.envs];
    done0 = lane == 0 && s0[(long long)(4 * N + A + 1) * p.envs] > 0.5f;
    walker_obs(p, obs, pa, px, py, vx, vy);
  }
  cp_async_wait_all();
  bool done = __syncthreads_or(done0);

  // 3. the episode; done is block-uniform (the barrier that ends a step
  // reduces it)
  for (int step = 0; step < p.T && !done; ++step) {
    if (kMain) {  // the widths as constants
      dense0_main(region<Wt>(smem, p.w_off[0]), region<Wt>(smem, p.b_off[0]), obs,
                  smem + p.h_off[1], w0r);
      __syncthreads();
      dense1_main(w1r, region<Wt>(smem, p.b_off[1]), smem + p.h_off[1], smem + p.h_off[2]);
      __syncthreads();
      dense(region<Wt>(smem, p.w_off[2]), region<Wt>(smem, p.b_off[2]), smem + p.h_off[2],
            smem + p.h_off[3], kMainHidden, kMainOut, 4, false);
    } else {
      for (int l = 0; l < n_layers; ++l) {
        const bool squash = l < n_layers - 1 && !((p.linear_mask >> l) & 1);
        dense(region<Wt>(smem, p.w_off[l]), region<Wt>(smem, p.b_off[l]), smem + p.h_off[l],
              smem + p.h_off[l + 1], p.fan[l], p.fan[l + 1], p.slices[l], squash);
        if (l < n_layers - 1) __syncthreads();
      }
    }
    // the action is in place once its warps are: only warp 0 waits
    if (n_last > 1) {
      if (warp == 0) {
        bar_sync(1, 32 * n_last);
      } else if (warp < n_last) {
        bar_arrive(1, 32 * n_last);
      }
    } else {
      __syncwarp();
    }
    // warp 0 steps the walker; warp 1 (idle by then) adds the reward while
    // warp 0 builds the next observation
    bool d = false;
    if (warp == 0) {
      d = walker_step(p, act, obs, rw, nwarps > 1, px, py, vx, vy, t);
      if (nwarps == 1) total = total + walker_reward(p, rw);
    } else if (warp == 1) {
      bar_sync(2, 64);
      total = total + walker_reward(p, rw);
    }
    done = __syncthreads_or(d);
  }
  if (tid == (nwarps > 1 ? 32 : 0)) p.out[env] = total;
}

// layouts of the three host arrays
constexpr int kInts = 55;    // see the parsing below
constexpr int kFloats = 13;  // h, rod_length, 1/rod_length, rod_stiffness, rod_damping,
                             // torque_scale, ground_stiffness, ground_damping, friction,
                             // gravity, stand_height, max_steps, n_masses
constexpr int kPtrs = 10;    // w[0..3], b[0..3], planes, out

// the instance's kernel: main or generic, float or bf16 residency
const void* instance(bool main_instance, bool bf16) {
  if (main_instance) {
    return bf16 ? reinterpret_cast<const void*>(&mlp_rollout_kernel<true, __nv_bfloat16>)
                : reinterpret_cast<const void*>(&mlp_rollout_kernel<true, float>);
  }
  return bf16 ? reinterpret_cast<const void*>(&mlp_rollout_kernel<false, __nv_bfloat16>)
              : reinterpret_cast<const void*>(&mlp_rollout_kernel<false, float>);
}

// the instance's attributes: shared memory past 48 KB, and the most of it
// for shared memory (blocks an SM)
cudaError_t prepare(const void* fn, int smem_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

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
  for (int l = 0; l < kMaxLayers; ++l) p.slices[l] = static_cast<int>(ints[at++]);
  p.linear_mask = static_cast<int>(ints[at++]);
  const long long n = ints[at++];
  const long long episodes = ints[at++];
  p.T = static_cast<int>(ints[at++]);
  p.n_masses = static_cast<int>(ints[at++]);
  p.act_dim = static_cast<int>(ints[at++]);
  p.substeps = static_cast<int>(ints[at++]);
  const bool main_instance = ints[at++] != 0;
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
  const bool bf16 = ints[at++] != 0;
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
  for (int l = 0; ok && l < p.n_layers; ++l) {
    const int S = p.slices[l];
    ok = p.fan[l] >= 1 && p.fan[l + 1] >= 1 && (S == 1 || S == 2 || S == 4) &&
         S <= (p.fan[l] + 3) / 4;
  }
  if (ok && main_instance) {
    ok = p.n_layers == 3 && p.linear_mask == 0 && threads == kMainThreads;
    for (int l = 0; ok && l < 3; ++l) ok = p.fan[l] == kMainFan[l] && p.slices[l] == 4;
    ok = ok && p.fan[3] == kMainFan[3];
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.n = static_cast<int>(n);
  p.envs = n * episodes;

  const void* fn = instance(main_instance, bf16);
  cudaError_t err = prepare(fn, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(episodes));
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchKernel(fn, grid, dim3(threads), args,
                                           static_cast<size_t>(smem_bytes),
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int evox_mlp_rollout_blocks_per_sm(int main_instance, int bf16, int threads,
                                              int smem_bytes, int* blocks) {
  const void* fn = instance(main_instance != 0, bf16 != 0);
  cudaError_t err = prepare(fn, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, smem_bytes));
}

extern "C" const char* evox_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
