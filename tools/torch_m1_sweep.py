#!/usr/bin/env python3
"""Kernel M1 (``smallmm``) against the length of its sum, on one CUDA card.

For each shape family ``(batch, p, q)`` the tool times one call at a range
of k, each call's device time taken from 50 calls replayed back to back
from one CUDA graph (no host gap between launches), so the slope over k is
the cost of one staged slice of k and the intercept the launch's own. While
the longest shape replays for about a second, ``nvidia-smi`` samples the
SM clock and the power draw, so the cycles a slice takes can be read off.
Run from a checkout::

    python3 tools/torch_m1_sweep.py [--out PATH]

The last line of standard output is one JSON object with every time; the
card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KS = (32, 64, 128, 256, 512, 1024, 2048)
# (name, batch, p, q, trans_a, trans_b): CMA-ES's long sums on path 5
FAMILIES = (("|ps| dot (1 x k)(k x 1)", 1, 1, 1, False, False),
            ("B z_w (1000 x k)(k x 1)", 1, 1000, 1, False, False),
            ("ask (24 x k)(1000 x k)^T", 1, 24, 1000, False, True))


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _graph_us(torch, fn, calls: int = 50, replays: int = 5) -> tuple:
    """(device µs a call, the graph): ``calls`` calls of ``fn`` replayed
    back to back from one CUDA graph, timed by CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / (replays * calls), graph


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_m1_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from evox_tpu_torch.kernels import smallmm as km

    print(_smi("name,power.limit"), flush=True)
    out = {"device": _smi("name,power.limit"), "families": []}
    last = None
    for name, b, p, q, ta, tb in FAMILIES:
        fam = {"name": name, "b": b, "p": p, "q": q, "k": list(KS), "graph_us": []}
        for k in KS:
            g = torch.Generator().manual_seed(k)
            a = torch.randn((b,) + ((k, p) if ta else (p, k)), generator=g).cuda()
            bb = torch.randn((b,) + ((q, k) if tb else (k, q)), generator=g).cuda()
            us, graph = _graph_us(torch, lambda: km.smallmm(a, bb, ta, tb, device=a.device))
            fam["graph_us"].append(us)
            last = graph
        n = len(KS)
        mx, my = sum(KS) / n, sum(fam["graph_us"]) / n
        slope = sum((x - mx) * (y - my) for x, y in zip(KS, fam["graph_us"])) / sum(
            (x - mx) ** 2 for x in KS)
        fam["us_per_slice_of_32"] = slope * 32
        fam["intercept_us"] = my - slope * mx
        out["families"].append(fam)
        print(json.dumps(fam), flush=True)
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(_smi("clocks.sm,clocks.max.sm,power.draw"))
            time.sleep(0.1)

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.5:  # the last shape, back to back
        last.replay()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    out["clock_samples"] = samples
    print(json.dumps(samples), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"families": [{k: f[k] for k in ("name", "us_per_slice_of_32",
                                                      "intercept_us")}
                                   for f in out["families"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
