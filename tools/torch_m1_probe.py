#!/usr/bin/env python3
"""Where a staged slice of kernel M1's sum spends its cycles, on one CUDA card.

Builds a probed copy of ``evox_tpu_torch/csrc/smallmm.cu`` under
``evox_tpu_torch/_build/probe/`` (the source itself is not changed): thread
0 of block 0 reads ``clock64()`` around each phase of every slice (issuing
the next slice's copies, waiting for this slice's, the barrier, the sum,
the closing barrier) into a device array; ``--sync-copies`` makes the
staging copies plain loads and stores, a control for ``cp.async``'s issue
cost. Then it runs one call at each of
CMA-ES's long sums on path 5 through the port's own wrapper, pointed at the
probed library, and prints the median cycles of each phase a slice; a
one-thread kernel beside it times 1024 dependent ``__fadd_rn`` and 1024
steps of M1's sum from shared memory, the latency floor of a chain. Run
from a checkout::

    python3 tools/torch_m1_probe.py [--sync-copies] [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("issue", "wait", "barrier", "sum", "close")
SHAPES = (("|ps| dot", 1, 1, 1000, 1, False, False),
          ("B z_w", 1, 1000, 1000, 1, False, False),
          ("ask", 1, 24, 1000, 1000, False, True))


def probed_source(text: str, sync_copies: bool = False) -> str:
    """The kernel source with ``clock64()`` reads around a slice's phases;
    with ``sync_copies`` the staging copies are plain loads and stores in
    place of ``cp.async`` (a control for the copies' issue cost)."""
    def sub(old: str, new: str) -> None:
        nonlocal text
        if old not in text:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        text = text.replace(old, new, 1)

    sub("namespace {\n", "__device__ long long g_probe[64 * 8];\n\nnamespace {\n")
    sub("  for (int s = 0; s < slices; ++s) {\n",
        "  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;\n"
        "  for (int s = 0; s < slices; ++s) {\n"
        "    long long c0 = clock64();\n")
    sub("    cp_wait_at_most(ring - 1);\n    __syncthreads();\n",
        "    long long c1 = clock64();\n    cp_wait_at_most(ring - 1);\n"
        "    long long c2 = clock64();\n    __syncthreads();\n    long long c3 = clock64();\n")
    sub("    __syncthreads();  // every thread is done with the slot before it is refilled\n",
        "    long long c4 = clock64();\n"
        "    __syncthreads();  // every thread is done with the slot before it is refilled\n"
        "    long long c5 = clock64();\n"
        "    if (probe && s < 64) {\n"
        "      g_probe[s * 8 + 0] = c1 - c0; g_probe[s * 8 + 1] = c2 - c1;\n"
        "      g_probe[s * 8 + 2] = c3 - c2; g_probe[s * 8 + 3] = c4 - c3;\n"
        "      g_probe[s * 8 + 4] = c5 - c4; g_probe[s * 8 + 5] = ring;\n"
        "    }\n")
    if sync_copies:
        sub('  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s), "l"(src));\n',
            "  (void)s;\n  *dst = __ldg(src);\n")
        sub('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src));\n',
            "  (void)s;\n  *reinterpret_cast<float4*>(dst) = "
            "__ldg(reinterpret_cast<const float4*>(src));\n")
    text += ("\nextern \"C\" int evox_probe_read(long long* out) {\n"
             "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));\n"
             "}\n")
    text += CHAIN_PROBE
    return text


# The cycles of 1024 dependent __fadd_rn, and of 1024 steps of
# acc = rn(acc + rn(x * y)) with x, y loaded from shared memory, in one
# thread: the latency floor of a sum in M1's order.
CHAIN_PROBE = r"""
__global__ void evox_chain_probe_kernel(const float* x, float* out, long long* cycles) {
  __shared__ float s[1024];
  for (int t = threadIdx.x; t < 1024; t += blockDim.x) s[t] = x[t];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc = 0.0f, v = x[0];
  long long c0 = clock64();
#pragma unroll 32
  for (int t = 0; t < 1024; ++t) acc = __fadd_rn(acc, v);
  long long c1 = clock64();
  float acc2 = 0.0f;
#pragma unroll 32
  for (int t = 0; t < 1024; ++t) acc2 = __fadd_rn(acc2, __fmul_rn(s[t], s[1023 - t]));
  long long c2 = clock64();
  out[0] = acc + acc2;
  cycles[0] = c1 - c0;
  cycles[1] = c2 - c1;
}

extern "C" int evox_chain_probe(const void* x, void* out, void* cycles) {
  evox_chain_probe_kernel<<<1, 32>>>(static_cast<const float*>(x), static_cast<float*>(out),
                                     static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sync-copies", action="store_true")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_m1_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import smallmm as km

    probe_dir = _build.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    src = probe_dir / "smallmm_probe.cu"
    src.write_text(probed_source(_build.SOURCES["smallmm"].read_text(), args.sync_copies))
    _build.SOURCES["smallmm"] = src
    read = _build.function("smallmm", "evox_probe_read", [ctypes.c_void_p])
    chain = _build.function("smallmm", "evox_chain_probe", [ctypes.c_void_p] * 3)
    x = torch.rand(1024, device="cuda")
    res = torch.zeros(1, device="cuda")
    cyc = torch.zeros(2, dtype=torch.int64, device="cuda")
    for _ in range(3):
        if chain(x.data_ptr(), res.data_ptr(), cyc.data_ptr()):
            raise SystemExit("probe: the chain kernel did not launch")
    torch.cuda.synchronize()
    out = {"shapes": [], "cycles_per_dependent_fadd": cyc[0].item() / 1024,
           "cycles_per_step_fmul_fadd_from_smem": cyc[1].item() / 1024}
    print(json.dumps({k: v for k, v in out.items() if k != "shapes"}), flush=True)
    for name, b, p, k, q, ta, tb in SHAPES:
        g = torch.Generator().manual_seed(k + p + q)
        a = torch.randn((p, k) if not ta else (k, p), generator=g).cuda()
        bb = torch.randn((q, k) if tb else (k, q), generator=g).cuda()
        for _ in range(3):
            got = km.smallmm(a, bb, ta, tb, device=a.device)
        torch.cuda.synchronize()
        if not torch.equal(got, km.smallmm_plain(a, bb, ta, tb)):
            raise SystemExit(f"probe: {name} disagrees with the plain version")
        buf = (ctypes.c_longlong * (64 * 8))()
        err = read(ctypes.addressof(buf))
        if err:
            raise SystemExit(f"probe: reading the cycles failed ({err})")
        slices = -(-k // km.launch_plan(b, p, k, q, ta, tb)["kslice"])
        rows = [list(buf[s * 8:s * 8 + 6]) for s in range(min(slices, 64))]
        entry = {"name": name, "p": p, "k": k, "q": q, "ring": rows[0][5],
                 "median_cycles": {ph: statistics.median(r[i] for r in rows[1:])
                                   for i, ph in enumerate(PHASES)},
                 "first_slices": rows[:4]}
        out["shapes"].append(entry)
        print(json.dumps(entry), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
