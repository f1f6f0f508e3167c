#!/usr/bin/env python3
"""Phase split of ``partial_topk``'s small route (one block) on a CUDA card.

Builds a copy of ``evox_tpu_torch/csrc/topk.cu`` with a ``clock64()``
reading after each barrier-separated phase of ``small_kernel`` and of the
one-block sort (the copy goes to ``evox_tpu_torch/_build/probe/``; the
tree's source is not touched), runs ``partial_topk`` through it on the
NSGA-II main path's first-generation cut key and on a few other shapes,
checks each result against ``partial_topk_reference``, and prints one JSON
line a shape with the microseconds of each phase (cycles at the SM clock
the card reports):

- ``load``: the values into shared memory as keys;
- ``selP.zero``, ``selP.count``, ``selP``: select pass P's cleared bins, its
  histogram, its bucket choice;
- ``compact``: the stable compaction;
- ``or_and``: the sort's OR and AND of the keys it sorts;
- ``sortP.zero``, ``sortP.count``, ``sortP.scan``, ``sortP``: each digit
  pass that runs (cleared counters, counts, scan, scatter);
- ``write``: the result to the output arrays.

The readings add a barrier each, so the phases sum to a little more than
the unprobed kernel's time. Run from the root of a checkout::

    python3 tools/torch_topk_probe.py [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE_DEFS = """
__device__ long long g_probe[128];
#define PROBE(i) do { __syncthreads(); if (threadIdx.x == 0) g_probe[i] = clock64(); } while (0)
#define PROBEG(i) do { barrier<T, true>(); if (threadIdx.x == 0) g_probe[i] = clock64(); } while (0)
"""

# (text in csrc/topk.cu, the reading, before or after the text); PROBEG inside the
# sort, which a group of the block's threads runs
MARKS = (
    ("  __shared__ int sm[33];\n\n  if (k == n) {", "  PROBE(0);\n", "before"),
    ("  for (int i = threadIdx.x; i < n; i += T) keys[i] = order_key(__ldg(values + i));\n",
     "  PROBE(1);\n", "after"),
    ("    if (threadIdx.x == 0) any_s = any_inv_s = 0u;\n    __syncthreads();\n",
     "    PROBE(50 + 4 * p);\n", "after"),
    ("      atomicOr(&any_inv_s, any_inv);\n    }\n    __syncthreads();\n",
     "    PROBE(51 + 4 * p);\n", "after"),
    ("    advance(mask, bits, less, done, p, d, below, counters[d], any_s == ~any_inv_s, any_s, "
     "k);\n",
     "    PROBE(2 + p);\n", "after"),
    ("  // 3. sort:", "  PROBE(5);\n", "before"),
    ("  const unsigned vary = any_s ^ all_s;\n", "  PROBEG(6);\n", "after"),
    ("    reinterpret_cast<uint4*>(counters)[c] = make_uint4(0u, 0u, 0u, 0u);\n"
     "  barrier<T, true>();\n",
     "  PROBEG(70 + shift / 4 * 5);\n", "after"),
    ("  for (int j = j0; j < j1; ++j) "
     "++ctr[((src_key[j] >> shift) & (kBlockDigits - 1)) * T + t];\n"
     "  barrier<T, true>();\n", "  PROBEG(71 + shift / 4 * 5);\n", "after"),
    ("  mine[1] = w[1];\n  barrier<T, true>();\n", "  PROBEG(72 + shift / 4 * 5);\n", "after"),
    ("    in_b = !in_b;\n", "    PROBEG(8 + p);\n", "after"),
    ("  write_out(in_y ? y_key : x_key, in_y ? y_idx : x_idx, x_key, x_idx, m, k, out_v, out_i);\n",
     "  PROBE(40);\n", "after"),
    ("    write_out(in_y ? y_key : x_key, in_y ? y_idx : x_idx, x_key, x_idx, k, k, out_v, "
     "out_i);\n",
     "    PROBE(40);\n", "after"),
)

NAMES = {0: "start", 1: "load", 5: "compact", 6: "or_and", 40: "write"}
for _p in range(3):
    NAMES.update({50 + 4 * _p: f"sel{_p}.zero", 51 + 4 * _p: f"sel{_p}.count", 2 + _p: f"sel{_p}"})
for _p in range(8):
    NAMES.update({70 + 5 * _p: f"sort{_p}.zero", 71 + 5 * _p: f"sort{_p}.count",
                  72 + 5 * _p: f"sort{_p}.scan", 8 + _p: f"sort{_p}"})


def probe_source() -> str:
    src = (ROOT / "evox_tpu_torch" / "csrc" / "topk.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + PROBE_DEFS, 1)
    for text, reading, where in MARKS:
        if text not in src:
            raise RuntimeError(f"csrc/topk.cu no longer holds the probe's mark {text!r}")
        src = src.replace(text, reading + text if where == "before" else text + reading)
    return src + """
extern "C" int evox_topk_probe_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 128));
}
extern "C" int evox_topk_probe_reset() {
  static const long long zero[128] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof zero));
}
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch

    import chip_smoke
    import torch_topk_sweep
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import topk as kt

    path = _build.BUILD_DIR / "probe" / "topk.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(probe_source())
    _build.SOURCES["topk"] = path  # this process builds and loads the probed copy
    read = _build.function("topk", "evox_topk_probe_read", [ctypes.c_void_p])
    reset = _build.function("topk", "evox_topk_probe_reset", [])
    khz = torch.cuda.get_device_properties(0).clock_rate if hasattr(
        torch.cuda.get_device_properties(0), "clock_rate") else None
    if not khz:  # the SM clock from nvidia-smi, in MHz
        import subprocess

        khz = 1000 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
    keys = torch_topk_sweep.main_path_keys(torch, False)
    dev = keys["key"].device
    shapes = [("cut (main path)", keys["key"], keys["k"])]
    for law, n, k in (("distinct", 1000, 1), ("distinct", 1000, 1000), ("distinct", 20000, 1),
                      ("distinct", 20000, 10000), ("rounded", 20000, 10000)):
        v = chip_smoke.topk_values(torch, law, n, 1000 + n, 0.87, 6).to(dev)
        shapes.append((f"{law} n={n} k={k}", v, k))
    rows = []
    for label, v, k in shapes:
        for _ in range(2):
            kt.partial_topk(v, k)
        torch.cuda.synchronize()
        reset()
        got = kt.partial_topk(v, k)
        torch.cuda.synchronize()
        want = kt.partial_topk_reference(v, k)
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        buf = (ctypes.c_longlong * 128)()
        read(ctypes.addressof(buf))
        t = list(buf)
        seen = sorted((i for i in NAMES if t[i]), key=lambda i: t[i])
        us = {NAMES[b]: (t[b] - t[a]) / khz * 1e3 for a, b in zip(seen, seen[1:])}
        row = {"shape": label, "plan": dict(kt.launch_plan(v.numel(), k)), "bit_for_bit": same,
               "total_us": (t[40] - t[0]) / khz * 1e3, "sm_clock_khz": khz, "us": us}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not same:
            return 1
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
