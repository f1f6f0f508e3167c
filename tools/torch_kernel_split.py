#!/usr/bin/env python3
"""Where the pendulum rollout kernel (``fused_rollout``) and the dominance
kernel (``packed_dominance``) of one checkout spend their instructions and
their time, on one CUDA card.

Run from a checkout, with the checkout to measure as its argument::

    python3 tools/torch_kernel_split.py DIR --out-dir PATH

It builds DIR's ``evox_tpu_torch/csrc/{rollout,dominance}.cu`` and writes,
under ``--out-dir`` (a directory that ``.gitignore`` lists keeps the
listings out of the tree):

1. ``*.sass``: ``cuobjdump -sass`` of both libraries, and an opcode count
   per kernel function.
2. ``libdevice.{ptx,sass}``: ``tanhf``, ``sinf``, ``cosf``, ``sincosf`` and
   ``fmodf(x, 2*pi)``, one to a kernel, compiled with the port's flags,
   and their instruction counts.
3. The dominance kernel on the NSGA-II main path's first merged fitness
   (n 20000, m 3): the whole call timed with CUDA events, and, where DIR's
   ``dominance.cu`` packs and counts in two kernels (``launch_pack`` and
   ``column_popcount_kernel``), each of them timed alone the same way;
   where DIR's wrapper plans the launch (``launch_plan``), the plan and the
   runtime's blocks an SM and registers.
4. The pendulum kernel on the main path's first-generation inputs (pop
   65536, 2 episodes, T 200), timed, and timed again at one block an SM and
   at one full wave, for the cost of a warp-step alone and at full load.
5. A probe: the pendulum step written out phase by phase (trig of the
   observation, the first layer's multiplies and adds, 16 ``tanhf``, the
   second layer, the floored modulo, the rest of the step), with
   ``clock64()`` read at each boundary (lane 0 of every warp), and the same
   kernel with one phase at a time replaced by a copy of its input
   (ablation: the time that phase adds at full load). The probe repeats
   the step's operations; it is not the kernel itself.

The last line of standard output is one JSON object with the numbers;
the card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// clock64 read after the value v exists (v is an input of the asm)
__device__ __forceinline__ long long clk(float v) {
  long long t;
  asm volatile("{\n .reg .pred p;\n setp.eq.f32 p, %1, %1;\n mov.u64 %0, %%clock64;\n}"
               : "=l"(t) : "f"(v) : "memory");
  return t;
}

__device__ __forceinline__ float floored_mod(float x, float y) {
  float m = fmodf(x, y);
  if (m != 0.0f && ((m < 0.0f) != (y < 0.0f))) m += y;
  return m;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// DROP bits: 1 tanh, 2 obs trig, 4 floored modulo, 8 the step's sinf;
// CLOCKS: clock64 at each phase boundary (6 phases)
template <int DROP, bool CLOCKS>
__global__ void __launch_bounds__(128)
pendulum_probe(const float* __restrict__ theta, const float* __restrict__ state0,
               float* __restrict__ out, int n, int T, long long* __restrict__ clocks) {
  constexpr int H = 16, DIM = 3 * H + H + H + 1;
  const int i = blockIdx.x * 128 + threadIdx.x;
  const bool live = i < n;
  const long long env = (long long)blockIdx.y * n + i;
  const long long envs = (long long)gridDim.y * n;
  float w[DIM];
  const float* row = theta + (long long)i * DIM;
#pragma unroll
  for (int k = 0; k < DIM; ++k) w[k] = live ? __ldg(row + k) : 0.0f;
  float th = live ? __ldg(state0 + env) : 0.0f;
  float thdot = live ? __ldg(state0 + envs + env) : 0.0f;
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  float total = 0.0f;
  for (int t = 0; t < T; ++t) {
    long long c0 = CLOCKS ? clk(th) : 0;
    float o0, o1;
    if (DROP & 2) { o0 = th; o1 = th * 0.5f; } else { o0 = cosf(th); o1 = sinf(th); }
    const float o[3] = {o0, o1, thdot};
    long long c1 = CLOCKS ? clk(o0 + o1) : 0;
    float h[H];
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = w[3 * H + j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = h[j] + o[k] * w[k * H + j];
    }
    long long c2 = 0;
    if (CLOCKS) { float s = 0.0f; for (int j = 0; j < H; ++j) s += h[j]; c2 = clk(s); }
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = (DROP & 1) ? h[j] : tanhf(h[j]);
    long long c3 = 0;
    if (CLOCKS) { float s = 0.0f; for (int j = 0; j < H; ++j) s += h[j]; c3 = clk(s); }
    float a = w[DIM - 1];
#pragma unroll
    for (int j = 0; j < H; ++j) a = a + h[j] * w[4 * H + j];
    long long c4 = CLOCKS ? clk(a) : 0;
    const float u = clip(a, -2.0f, 2.0f);
    const float norm_th = (DROP & 4) ? th : floored_mod(th + kPi, kTwoPi) - kPi;
    long long c5 = CLOCKS ? clk(norm_th) : 0;
    const float cost = norm_th * norm_th + 0.1f * (thdot * thdot) + 0.001f * (u * u);
    float nthdot = thdot + (15.0f * ((DROP & 8) ? th : sinf(th)) + 3.0f * u) * 0.05f;
    nthdot = clip(nthdot, -8.0f, 8.0f);
    th = th + nthdot * 0.05f;
    thdot = nthdot;
    total += -cost;
    if (CLOCKS) {
      long long c6 = clk(total);
      acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2;
      acc[3] += c4 - c3; acc[4] += c5 - c4; acc[5] += c6 - c5;
    }
  }
  if (live) out[env] = total;
  if (CLOCKS && (threadIdx.x & 31) == 0) {
    const long long warp = ((long long)blockIdx.y * gridDim.x * 128 + blockIdx.x * 128 + threadIdx.x) >> 5;
#pragma unroll
    for (int p = 0; p < 6; ++p) clocks[warp * 6 + p] = acc[p];
  }
}

template <int DROP, bool CLOCKS>
int run(const void* theta, const void* state0, void* out, int n, int episodes, int T, void* clocks,
        void* stream) {
  const dim3 grid((n + 127) / 128, episodes);
  pendulum_probe<DROP, CLOCKS><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(state0),
      static_cast<float*>(out), n, T, static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_pendulum(int variant, const void* theta, const void* state0, void* out,
                              int n, int episodes, int T, void* clocks, void* stream) {
  switch (variant) {
    case 0: return run<0, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 1: return run<1, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 2: return run<2, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 4: return run<4, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 8: return run<8, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 15: return run<15, false>(theta, state0, out, n, episodes, T, clocks, stream);
    case 16: return run<0, true>(theta, state0, out, n, episodes, T, clocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int probe_pendulum_occupancy(int* blocks, int* regs) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, pendulum_probe<0, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pendulum_probe<0, false>, 128, 0));
}
"""

# the kernels' split and occupancy, for a dominance.cu that packs and counts
# in two kernels (launch_pack<MAXM>, column_popcount_kernel) and a rollout.cu
# with rollout_kernel<Pendulum, 16> at kBlock threads
SPLIT_CU = r"""
#include "{dominance}"
extern "C" int split_pack(const void* fit, int n, int m, void* packed, void* stream) {{
  launch_pack<4>(static_cast<const float*>(fit), n, m, (n + 31) / 32, static_cast<int*>(packed),
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}}
extern "C" int split_count(const void* packed, int n, void* count, void* stream) {{
  column_popcount_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), n, (n + 31) / 32, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}}
extern "C" int split_pack_occupancy(int* blocks, int* regs) {{
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, dominance_pack_kernel<4>);
  *regs = a.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dominance_pack_kernel<4>, kWarps * 32, 0));
}}
"""

ROLLOUT_OCC_CU = r"""
#include "{rollout}"
extern "C" int split_rollout_occupancy(int* blocks, int* regs) {{
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, rollout_kernel<Pendulum, 16>);
  *regs = a.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rollout_kernel<Pendulum, 16>, kBlock, 0));
}}
"""

LIBDEVICE_CU = r"""
__global__ void k_tanhf(const float* x, float* y) { int i = blockIdx.x * blockDim.x + threadIdx.x; y[i] = tanhf(x[i]); }
__global__ void k_sinf(const float* x, float* y) { int i = blockIdx.x * blockDim.x + threadIdx.x; y[i] = sinf(x[i]); }
__global__ void k_cosf(const float* x, float* y) { int i = blockIdx.x * blockDim.x + threadIdx.x; y[i] = cosf(x[i]); }
__global__ void k_sincosf(const float* x, float* y) { int i = blockIdx.x * blockDim.x + threadIdx.x; float s, c; sincosf(x[i], &s, &c); y[2 * i] = s; y[2 * i + 1] = c; }
__global__ void k_fmodf(const float* x, float* y) { int i = blockIdx.x * blockDim.x + threadIdx.x; y[i] = fmodf(x[i], 6.28318530717958647692f); }
"""


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text -> {function: [opcode, ...]} (opcodes
    without their modifiers; predicates dropped)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            out[name].append(m.group(2))
    return out


def opcode_counts(ops: list) -> dict:
    return dict(Counter(op.split(".")[0] for op in ops).most_common())


def nvcc(build, flags, src: Path, out: Path, extra=()) -> str:
    res = subprocess.run([build.nvcc_path(), *flags, *extra, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src.name}: {res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def cuobjdump(build, path: Path) -> str:
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree", type=Path)
    parser.add_argument("--out-dir", type=Path, required=True)
    args = parser.parse_args()
    tree = args.tree.resolve()
    out_dir = args.out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import rollout as kr

    if not torch.cuda.is_available():
        print("torch_kernel_split: no CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke._nvidia_smi()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    result = {"nvidia_smi": smi, "clocks": clocks, "tree": str(tree)}
    libs = _build.build(["rollout", "dominance"])

    # 1. SASS of the built libraries
    sass = {}
    for name, path in libs.items():
        text = cuobjdump(_build, path)
        (out_dir / f"{name}.sass").write_text(text)
        sass[name] = {fn: {"instructions": len(ops), "opcodes": opcode_counts(ops)}
                      for fn, ops in sass_functions(text).items()}
    result["sass"] = sass

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 2. libdevice's functions, one to a kernel
        src = tmp / "libdevice.cu"
        src.write_text(LIBDEVICE_CU)
        nvcc(_build, [f for f in flags if f not in ("-Xptxas", "-v")], src, out_dir / "libdevice.ptx", ["-ptx"])
        nvcc(_build, flags, src, tmp / "libdevice.cubin", ["-cubin"])
        text = cuobjdump(_build, tmp / "libdevice.cubin")
        (out_dir / "libdevice.sass").write_text(text)
        result["libdevice"] = {fn: {"instructions": len(ops), "opcodes": opcode_counts(ops)}
                               for fn, ops in sass_functions(text).items()}

        # probe and split libraries
        src = tmp / "probe.cu"
        src.write_text(PROBE_CU)
        log = nvcc(_build, _build.NVCC_FLAGS, src, tmp / "libprobe.so")
        probe = ctypes.CDLL(str(tmp / "libprobe.so"))
        result["probe_ptxas"] = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        split = rocc = None
        try:
            src = tmp / "split.cu"
            src.write_text(SPLIT_CU.format(dominance=_build.SOURCES["dominance"]))
            nvcc(_build, _build.NVCC_FLAGS, src, tmp / "libsplit.so")
            split = ctypes.CDLL(str(tmp / "libsplit.so"))
        except RuntimeError as err:  # another design: one kernel, no split
            result["dominance_split"] = f"not split: {str(err)[:300]}"
        try:
            src = tmp / "rocc.cu"
            src.write_text(ROLLOUT_OCC_CU.format(rollout=_build.SOURCES["rollout"]))
            nvcc(_build, _build.NVCC_FLAGS, src, tmp / "librocc.so")
            rocc = ctypes.CDLL(str(tmp / "librocc.so"))
        except RuntimeError as err:
            result["rollout_occupancy"] = f"not queried: {str(err)[:300]}"

        # 3. dominance on the NSGA-II main path's first merged fitness
        wf2 = chip_smoke.build_nsga2_path(torch)
        state = wf2.step(wf2.init(chip_smoke.SEED))
        off, astate = wf2.algorithm.ask(state.algo)
        fit, _ = wf2.problem.evaluate(state.prob, off)
        merged = torch.cat([astate.fitness, fit]).contiguous()
        n, m = merged.shape
        dev = merged.device
        dom = {"n": n, "m": m,
               "ms": chip_smoke._time_ms(lambda: kd.packed_dominance(merged, device=dev), 3, 20)}
        if split is not None:
            stream = torch.cuda.current_stream().cuda_stream
            packed = torch.empty(((n + 31) // 32, n), dtype=torch.int32, device=dev)
            count = torch.empty(n, dtype=torch.int32, device=dev)
            for fn in (split.split_pack, split.split_count):
                fn.restype = ctypes.c_int
            split.split_pack.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p]
            split.split_count.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
            dom["pack_ms"] = chip_smoke._time_ms(
                lambda: split.split_pack(merged.data_ptr(), n, m, packed.data_ptr(), stream), 3, 20)
            dom["count_ms"] = chip_smoke._time_ms(
                lambda: split.split_count(packed.data_ptr(), n, count.data_ptr(), stream), 3, 20)
            want = kd.packed_dominance(merged, device=dev)
            torch.cuda.synchronize()
            dom["split_equal"] = bool(torch.equal(packed, want[0]) and torch.equal(count, want[1]))
            b, r = ctypes.c_int(0), ctypes.c_int(0)
            split.split_pack_occupancy(ctypes.byref(b), ctypes.byref(r))
            dom["pack_blocks_per_sm"], dom["pack_registers"] = b.value, r.value
        if hasattr(kd, "launch_plan"):
            plan = kd.launch_plan(n, m)
            dom["plan"] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in plan.items()}
            dom.update(kd.kernel_occupancy(plan, m))
        result["dominance"] = dom
        print(f"[dominance] {json.dumps(dom)}", flush=True)
        del wf2, state, merged

        # 4. the pendulum kernel on the main path's inputs and at two loads
        wf, _ = chip_smoke.build_main_path(torch, chip_smoke.SEED)
        state = wf.init(chip_smoke.SEED)
        pop, _ = wf.algorithm.ask(state.algo)
        kw = wf.problem.fused_inputs(state.prob, pop)
        pend = {"ms": chip_smoke._time_ms(lambda: kr.fused_rollout(**kw), 3, 20)}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if rocc is not None:
            b, r = ctypes.c_int(0), ctypes.c_int(0)
            rocc.split_rollout_occupancy(ctypes.byref(b), ctypes.byref(r))
            pend["blocks_per_sm"], pend["registers"] = b.value, r.value
        per_sm = pend.get("blocks_per_sm", 3)
        theta = kw["theta"]
        for label, blocks in (("one_block_an_sm", sms), ("one_full_wave", sms * per_sm)):
            nn = min(128 * blocks, theta.shape[0])
            sub = dict(kw, theta=theta[:nn].contiguous(), episodes=1,
                       init_state={k: v[:nn].contiguous() for k, v in kw["init_state"].items()})
            pend[f"{label}_ms"] = chip_smoke._time_ms(lambda: kr.fused_rollout(**sub), 3, 20)
            pend[f"{label}_n"] = nn
        result["pendulum"] = pend
        print(f"[pendulum] {json.dumps(pend)}", flush=True)

        # 5. the probe: clocks per phase, and ablations at full load
        probe.probe_pendulum.restype = ctypes.c_int
        probe.probe_pendulum.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p]
        n, ep, T = pop.shape[0], kw["episodes"], kw["T"]
        theta = kw["theta"].contiguous()
        planes = torch.stack([kw["init_state"][k] for k in ("th", "thdot")]).contiguous()
        out = torch.empty(ep * n, device=dev)
        warps = ep * ((n + 127) // 128) * 4
        clk = torch.zeros(warps * 6, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(variant, nn=n, episodes=ep):
            err = probe.probe_pendulum(variant, theta.data_ptr(), planes.data_ptr(), out.data_ptr(),
                                       nn, episodes, T, clk.data_ptr(), stream)
            if err:
                raise RuntimeError(f"probe variant {variant}: CUDA error {err}")

        launch(0)
        torch.cuda.synchronize()
        want = kr.fused_rollout(**kw)
        torch.cuda.synchronize()
        probe_res = {"probe_equals_kernel": bool(torch.equal(out, want))}
        names = {0: "all", 1: "no_tanh", 2: "no_obs_trig", 4: "no_floored_mod",
                 8: "no_step_sinf", 15: "none_of_them", 16: "with_clocks"}
        for v, label in names.items():
            probe_res[f"{label}_ms"] = chip_smoke._time_ms(lambda: launch(v), 2, 10)
        phases = ("obs_trig", "layer1_mul_add", "tanhf_x16", "layer2_mul_add",
                  "floored_mod", "step_rest")
        for label, nn, episodes in (("full_load", n, ep), ("one_block_an_sm", 128 * sms, 1)):
            clk.zero_()
            launch(16, nn, episodes)
            torch.cuda.synchronize()
            used = episodes * ((nn + 127) // 128) * 4
            per = clk[: used * 6].view(used, 6).double().mean(0) / T
            probe_res[f"clocks_per_step_{label}"] = {p: float(c) for p, c in zip(phases, per)}
            probe_res[f"clocks_per_step_{label}"]["sum"] = float(per.sum())
        b, r = ctypes.c_int(0), ctypes.c_int(0)
        probe.probe_pendulum_occupancy(ctypes.byref(b), ctypes.byref(r))
        probe_res["blocks_per_sm"], probe_res["registers"] = b.value, r.value
        result["probe"] = probe_res
        print(f"[probe] {json.dumps(probe_res)}", flush=True)
    (out_dir / "split.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "sass"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
