#!/usr/bin/env python3
"""Sweep of ``partial_topk`` (B4) against ``torch.topk`` on one CUDA card.

Times the port's ``partial_topk`` and ``torch.topk(v, k, largest=False)``
with CUDA events at every shape of the sweep:

- n in ``chip_smoke.TOPK_NS`` = {1000, 20000, 100003, 1000000, 16777217}
  (2**24 + 1 is just above the JAX kernel's envelope; the port has none);
- k in {1, 100, n // 10, n // 2, n};
- the three value laws of ``chip_smoke.topk_values``: ``distinct``,
  ``rounded`` (heavy ties, NaNs of both signs, ±inf, ±0.0) and ``cut`` (the
  NSGA-II main path's cut key: at n 20000 the main path's own
  first-generation key, elsewhere a synthetic key with the same share of
  +inf rows and its -inf boundary rows).

With ``--check`` every shape is also held bit for bit against
``partial_topk_reference``. ``--parent-rules`` times the comparison-counting
kernel of earlier checkouts only where it finishes in time: every k at n <=
100003, k = n // 2 with 2 launches at n 1e6, nothing at 2**24 + 1.
``--split`` profiles 20 calls at the main-path input and at a few other
shapes (torch.profiler) and reports the device time of each kernel of a
call. ``--host`` times the host's side of a call at n 1000 piece by piece;
``--device-time`` adds, at n 1000, the device time of a call of each
(torch.profiler), where the back-to-back CUDA-event times measure the
host. ``--path`` runs NSGA-II's
main path (``chip_smoke.build_nsga2_path``) for 20 generations after the
init step and a warm-up and records, for every generation, how many keys of
the cut key lie below +inf (the cut front).

Run from the root of a checkout (writes the full results with ``--out``)::

    python3 tools/torch_topk_sweep.py [--check] [--parent-rules] [--split]
        [--path] [--ns 1000 20000] [--out PATH]

``--ab DIR_A DIR_B`` instead times ``partial_topk`` at the main-path input
in both checkouts in turns A, B, B, A, one process each (each builds its
own ``csrc/topk.cu``), and checks that their outputs agree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main_path_keys(torch, record_path: bool) -> dict:
    """The NSGA-II main path's first-generation cut key (n 20000, k 10000),
    as ``chip_smoke.phase_nsga2_kernels`` builds it, and with
    ``record_path`` the cut front of each of 20 generations."""
    import importlib

    import chip_smoke
    from evox_tpu_torch.operators.selection import crowding_distance, non_dominated_sort

    # the module, not the function of the same name that the package exports
    non_dominate = importlib.import_module("evox_tpu_torch.operators.selection.non_dominate")

    wf = chip_smoke.build_nsga2_path(torch)
    state = wf.step(wf.init(chip_smoke.SEED))
    off, astate = wf.algorithm.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    k = wf.algorithm.pop_size
    rank, cut = non_dominated_sort(merged, until=k, return_cut_rank=True)
    crowd = crowding_distance(merged, mask=rank == cut)
    key = torch.where(rank == cut, -crowd, float("inf"))
    out = {"key": key, "k": k}
    if record_path:
        fronts = []
        inner = non_dominate.partial_topk

        def recorder(v, kk, device=None):
            fronts.append(v < float("inf"))
            return inner(v, kk, device=device)

        non_dominate.partial_topk = recorder
        try:
            state = wf.step(state)  # warm-up generation
            fronts.clear()
            wf.run(state, 20)
        finally:
            non_dominate.partial_topk = inner
        out["cut_front_per_generation"] = [int(f.sum()) for f in fronts]
    return out


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def reps_of(n: int) -> tuple:
    # at n 1000 a call's time is the host's, which varies: average more calls
    if n <= 1000:
        return 20, 200
    return (3, 20) if n <= 1000000 else (1, 5)


def sweep(torch, kt, chip_smoke, args, main_key, inf_share, n_ninf) -> list:
    dev = main_key.device
    rows = []
    plan_of = getattr(kt, "launch_plan", None)
    for n in args.ns:
        for law in chip_smoke.TOPK_LAWS:
            if law == "cut" and n == main_key.numel():
                v = main_key
            else:
                v = chip_smoke.topk_values(torch, law, n, 1000 + n, inf_share, n_ninf).to(dev)
            for k in chip_smoke.topk_ks(n):
                row = {"n": n, "k": k, "law": law}
                if plan_of is not None:
                    row["plan"] = plan_of(n, k)["route"]
                warm, reps = reps_of(n)
                timed = not args.parent_rules or n <= 100003 or (n <= 1000000 and k == n // 2)
                if args.parent_rules and n > 100003:
                    warm, reps = 1, 2
                if timed:
                    row["ms"] = chip_smoke._time_ms(lambda: kt.partial_topk(v, k, device=dev),
                                                    warm, reps)
                warm, reps = reps_of(n)
                row["library_ms"] = chip_smoke._time_ms(
                    lambda: torch.topk(v, k, largest=False), warm, reps)
                if args.device_time and n <= 1000:  # where the host's side of a call shows
                    row["device_us"] = chip_smoke.device_us_per_call(
                        torch, lambda: kt.partial_topk(v, k, device=dev))
                    row["library_device_us"] = chip_smoke.device_us_per_call(
                        torch, lambda: torch.topk(v, k, largest=False))
                if args.check and timed:
                    got = kt.partial_topk(v, k, device=dev)
                    want = kt.partial_topk_reference(v, k)
                    row["mismatches"] = chip_smoke.compare_exact(
                        f"partial_topk, sweep {law} n={n} k={k}", got, want)["mismatches"]
                print(f"[sweep] {json.dumps(row)}", flush=True)
                rows.append(row)
            del v
            torch.cuda.empty_cache()
    return rows


def split(torch, v, k, label: str) -> list:
    """Device time of each kernel of one call on ``v``, over 20 profiled
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from evox_tpu_torch.kernels import topk as kt

    dev = v.device
    for _ in range(3):
        kt.partial_topk(v, k, device=dev)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kt.partial_topk(v, k, device=dev)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append({"shape": label, "kernel": evt.key[:60],
                         "device_us_per_call": evt.self_device_time_total / calls,
                         "launches_per_call": evt.count / calls})
    rows.sort(key=lambda r: -r["device_us_per_call"])
    for r in rows:
        print(f"[split] {json.dumps(r)}", flush=True)
    return rows


def host_probe(torch, kt, dev, calls: int = 500) -> dict:
    """Host microseconds a call of each piece of the wrapper takes, enqueued
    back to back (the card keeps up at n 1000), beside torch.topk's."""
    from evox_tpu_torch.core.device import resolve_device

    v = torch.rand(1000, device=dev)
    out_v = torch.empty((1,), dtype=torch.float32, device=dev)
    out_i = torch.empty((1,), dtype=torch.int32, device=dev)

    def rate(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    fn, full = kt._function("evox_partial_topk_small"), kt._function("evox_partial_topk")
    stream = torch.cuda.current_stream().cuda_stream
    out = {
        "partial_topk": rate(lambda: kt.partial_topk(v, 1)),
        "partial_topk_device": rate(lambda: kt.partial_topk(v, 1, device=dev)),
        "launch": rate(lambda: kt._launch(v, 1, 1000)),
        "torch_topk": rate(lambda: torch.topk(v, 1, largest=False)),
        "torch_empty": rate(lambda: torch.empty((1,), dtype=torch.float32, device=dev)),
        "new_empty": rate(lambda: v.new_empty((1,))),
        "check_args": rate(lambda: kt._check_args(v, 1)),
        "resolve_device": rate(lambda: resolve_device(dev)),
        "launch_plan": rate(lambda: kt.launch_plan(1000, 1)),
        "current_device": rate(torch.cuda.current_device),
        "raw_stream": rate(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "c_call": rate(lambda: fn(v.data_ptr(), 1000, 1, out_v.data_ptr(), out_i.data_ptr(),
                                  stream)),
        "c_call_nine_arguments": rate(lambda: full(v.data_ptr(), 1000, 1, 0, None, 0,
                                                   out_v.data_ptr(), out_i.data_ptr(), stream)),
        "empty_launch": rate(lambda: kt.empty_launch(1, dev)),
    }
    print(f"[host us] {json.dumps(out)}", flush=True)
    return out


def measure_main(tree: Path) -> dict:
    """One A/B turn: ``partial_topk`` at the main-path input in ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import topk as kt

    _build.build(["topk"])
    keys = main_path_keys(torch, False)
    key, k = keys["key"], keys["k"]
    got = kt.partial_topk(key, k, device=key.device)
    torch.cuda.synchronize()
    return {"tree": str(tree), "ms": chip_smoke._time_ms(
        lambda: kt.partial_topk(key, k, device=key.device), 3, 20), "sha256": _digest(*got)}


def ab(a: Path, b: Path, out_path) -> int:
    smi = _smi()
    print(smi, flush=True)
    turns = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure-main",
                              str(tree)],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {"nvidia_smi": smi, "turns": turns,
               "a": [t["ms"] for t in turns if t["tree"] == str(a)],
               "b": [t["ms"] for t in turns if t["tree"] == str(b)],
               "same_outputs": len({t["sha256"] for t in turns}) == 1}
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("a", "b", "same_outputs")}), flush=True)
    return 0 if summary["same_outputs"] else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ns", type=int, nargs="*", default=None)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--parent-rules", action="store_true")
    parser.add_argument("--split", action="store_true")
    parser.add_argument("--path", action="store_true")
    parser.add_argument("--host", action="store_true")
    parser.add_argument("--device-time", action="store_true")
    parser.add_argument("--ab", type=Path, nargs=2, default=None)
    parser.add_argument("--measure-main", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if args.measure_main is not None:
        print(json.dumps(measure_main(args.measure_main.resolve())), flush=True)
        return 0
    if args.ab is not None:
        return ab(args.ab[0].resolve(), args.ab[1].resolve(), args.out)

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_topk_sweep: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import topk as kt

    if args.ns is None:
        args.ns = list(chip_smoke.TOPK_NS)
    smi = _smi()
    print(smi, flush=True)
    _build.build(["topk"])
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "ptxas": [line.strip() for line in (_build.build_log("topk") or "").splitlines()
                        if "registers" in line or "spill" in line or "Compiling" in line]}
    for line in result["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    keys = main_path_keys(torch, args.path)
    key, k = keys["key"], keys["k"]
    n = key.numel()
    front = int((key < float("inf")).sum())
    n_ninf = int((key == float("-inf")).sum())
    inf_share = 1.0 - front / n
    result["main_path"] = {"n": n, "k": k, "cut_front": front, "ninf": n_ninf}
    if args.path:
        result["main_path"]["cut_front_per_generation"] = keys["cut_front_per_generation"]
    print(f"[main path] {json.dumps(result['main_path'])}", flush=True)
    empty = getattr(kt, "empty_launch", None)
    if empty is not None:
        result["empty_launch_ms"] = chip_smoke._time_ms(lambda: empty(100, key.device), 2, 5) / 100
    if args.host:
        result["host_us"] = host_probe(torch, kt, key.device)
    if args.split:
        result["split"] = split(torch, key, k, f"cut {n} {k}")
        for law, sn, sk in (("distinct", 1000, 1), ("distinct", 1000, 1000), ("distinct", 20000, 1),
                            ("distinct", 20000, 20000), ("distinct", 1000000, 500000),
                            ("distinct", 16777217, 1), ("distinct", 16777217, 8388608)):
            if sn in args.ns:
                sv = chip_smoke.topk_values(torch, law, sn, 1000 + sn, inf_share, n_ninf)
                sv = sv.to(key.device)
                result["split"] += split(torch, sv, sk, f"{law} {sn} {sk}")
                del sv
    result["sweep"] = sweep(torch, kt, chip_smoke, args, key, inf_share, n_ninf)
    slower = [r for r in result["sweep"] if "ms" in r
              and r["ms"] > r["library_ms"] + (0.002 if r["n"] <= 1000 else 0.0)]
    result["slower_than_library"] = slower
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    bad = [r for r in result["sweep"] if r.get("mismatches")]
    print(json.dumps({"shapes": len(result["sweep"]), "mismatched": len(bad),
                      "slower_than_library": len(slower)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
