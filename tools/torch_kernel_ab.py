#!/usr/bin/env python3
"""A/B of the port's kernels of two checkouts, on one CUDA card, in turns.

Each turn runs in a fresh process inside one checkout: it builds that
checkout's CUDA sources and times, with CUDA events (mean of 20 launches
after 3 warm-up):

- ``rollout``: ``fused_rollout`` on the pendulum main path's
  first-generation inputs (``chip_smoke.build_main_path``: OpenES at pop
  65536, MLP 3-16-1, 2 episodes, T 200, seed 0), and on cartpole at pop
  8192, 2 episodes, T 500 (genomes of scale 0.5, seed 0), and the pendulum
  main path end to end;
- ``dominance``: ``packed_dominance`` on the NSGA-II main path's first
  merged fitness (``chip_smoke.build_nsga2_path``: n 20000, m 3, seed 0),
  and that main path end to end;
- ``m1``: kernel M1 (``smallmm``) at each of ``chip_smoke.SMALLMM_SHAPES``
  (CMA-ES's 13 call shapes on paths 28 and 5): events, the host µs of a
  call (enqueue, back to back) and its device µs (torch.profiler's kernel
  rows);
- ``rows``: B3's rows form at path 31's shape: the same merged fitness,
  ``+inf``-padded and cut into 8 slabs of 2528 rows; one slab and the 8
  slabs of a generation, with a slab's host and device µs;
- ``batched``: B3's batched launch at each of ``chip_smoke.
  DOMINANCE_BATCHES`` (every member a draw of ``chip_smoke.stress_fitness``)
  and B3's single launch at n 1998, 11024 and 20000 (m 3, stress rows):
  events, host µs, device µs (torch.profiler's rows, the counts' zeroing
  apart) and CUDA-graph replays, the plan; at the MO islands' (4, 2000, 3)
  the host µs of the call under ``torch.func.vmap``, of the custom op's
  vmap rule called directly and of the batched wrapper;
- ``digest``: D1 on path 4's CSO state (``chip_smoke.build_cso_path``,
  pop 4096, d 1024, seed 0): the wrapper's events, host and device µs
  (the profiler's, the words partly in the 50 MB L2), the kernel's raw
  launches timed by the checkout's own ``chip_smoke`` (``d1_kernel_us``,
  or the parent's ``d1_kernel_ms``) from device memory, on the state and
  a copy in turns (67 MB), and, where it gives it, partly in L2; and
  ``state_digest``'s host µs. D1 refuses CUDA graph capture, so it has no
  graph replays.

A main path end to end is ms a generation over 20 generations of ``run``
after a warm-up, host clock, card synchronised on both sides. The turns go
A, B, B, A. Each prints one JSON line with the times and a digest of every
output; the last line holds both checkouts' times. Run from a checkout::

    python3 tools/torch_kernel_ab.py DIR_A DIR_B [--only rollout,dominance,m1,rows,batched,digest]
        [--out PATH]
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


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _path_ms(torch, wf, state, gens: int = 20) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run(state, gens)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / gens * 1e3


def _host_us(torch, fn, calls: int = 200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _device_us(torch, fn, calls: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def _graph_us(torch, fn, calls: int = 50, replays: int = 5) -> float:
    """Device microseconds a call of ``fn`` when ``calls`` of them replay
    back to back from one CUDA graph (no host gap between launches), by
    CUDA events around ``replays`` replays. The graph is captured on the
    stream that took the warm-up calls (a wrapper's per-stream state is made
    by then)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    return start.elapsed_time(stop) * 1e3 / (replays * calls)


def _m1(torch, chip_smoke) -> dict:
    from evox_tpu_torch.kernels import smallmm as km

    out = {}
    for name, b, p, k, q, ta, tb in chip_smoke.SMALLMM_SHAPES:
        g = torch.Generator().manual_seed(1000 + p + k + q)
        a = torch.randn((b,) + ((k, p) if ta else (p, k)), generator=g).cuda()
        bb = torch.randn((b,) + ((q, k) if tb else (k, q)), generator=g).cuda()

        A = a.transpose(-1, -2) if ta else a
        B = bb.transpose(-1, -2) if tb else bb

        def call():
            return km.smallmm(a, bb, ta, tb, device=a.device)

        shape = (b, p, q)
        out[name] = {"ms": chip_smoke._time_ms(call, 3, 20), "host_us": _host_us(torch, call),
                     "device_us": _device_us(torch, call), "sha256": _digest(call()),
                     "graph_us": _graph_us(torch, call),
                     "bmm_graph_us": _graph_us(torch, lambda: torch.bmm(A, B)),
                     # the host's side of a call, piece by piece, and torch.bmm's
                     "host_split_us": {
                         "output_alloc": _host_us(torch, lambda: a.new_empty(shape)),
                         "current_device": _host_us(torch, torch.cuda.current_device),
                         "bmm": _host_us(torch, lambda: torch.bmm(A, B))}}
    return out


def _rows(torch, chip_smoke, merged) -> dict:
    from evox_tpu_torch.kernels import dominance as kd

    n, m = merged.shape
    shards = chip_smoke.PATH31_SHARDS
    words_per = -(-(-(-n // 32)) // shards)
    rows = torch.cat([merged, torch.full((words_per * shards * 32 - n, m), float("inf"),
                                         device=merged.device)])
    slabs = [rows[s * words_per * 32:(s + 1) * words_per * 32] for s in range(shards)]

    def one():
        return kd.packed_dominance_rows(slabs[0], merged, device=merged.device)

    def generation():
        return [kd.packed_dominance_rows(r, merged, device=merged.device) for r in slabs]

    words = generation()
    return {"slab_rows": words_per * 32, "ms": chip_smoke._time_ms(one, 3, 20),
            "generation_ms": chip_smoke._time_ms(generation, 3, 20),
            "host_us": _host_us(torch, one), "device_us": _device_us(torch, one),
            "graph_us": _graph_us(torch, one),
            "sha256": _digest(*(x for pair in words for x in pair))}


def _device_split_us(torch, fn, calls: int = 20) -> dict:
    """torch.profiler's device µs a call of ``fn`` by kernel name (a memset
    as ``Memset``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            key = "Memset" if "memset" in e.key.lower() else e.key.split("(")[0][-60:]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / calls
    return out


# B3's single launches beside the batched shapes: IM-MOEA's merged n, the
# archive's, path 2's
B3_SINGLES = ((1998, 3), (11024, 3), (20000, 3))


def _plan(kd, b: int, n: int, m: int) -> dict:
    try:
        plan = kd.launch_plan(n, m, b)
    except TypeError:  # a plan of (n, m) alone: the member on the grid's z axis
        plan = kd.launch_plan(n, m)
    return {k: plan[k] for k in ("tile_words", "grid", "working_blocks", "threads") if k in plan}


def _batched(torch, chip_smoke) -> dict:
    import types

    from evox_tpu_torch.kernels import dominance as kd

    out = {}
    shapes = [tuple(s) for s in chip_smoke.DOMINANCE_BATCHES] + [(1, n, m) for n, m in B3_SINGLES]
    for i, (b, n, m) in enumerate(shapes):
        fit = torch.stack([chip_smoke.stress_fitness(torch, n, m, 1000 * b + n + r, "cpu")
                           for r in range(b)]).cuda()
        dev = fit.device
        if i < len(chip_smoke.DOMINANCE_BATCHES):
            def call(fit=fit):
                return kd.packed_dominance_batched(fit, device=dev)
        else:
            def call(f=fit[0]):
                return kd.packed_dominance(f, device=dev)
        split = _device_split_us(torch, call)
        entry = {"ms": chip_smoke._time_ms(call, 3, 20), "host_us": _host_us(torch, call),
                 "device_us": sum(split.values()), "device_split_us": split,
                 "graph_us": _graph_us(torch, call), "plan": _plan(kd, b, n, m),
                 "sha256": _digest(*call())}
        if (b, n, m) == (4, 2000, 3):
            # the call under torch.func.vmap (custom op, its vmap rule, the
            # wrapper), the rule called directly where the module keeps it,
            # the wrapper; and pieces of the wrapper's host time
            vmapped = torch.func.vmap(lambda f: kd.packed_dominance(f, device=dev))
            host = {"vmap_call": _host_us(torch, lambda: vmapped(fit)),
                    "wrapper": _host_us(torch, call),
                    "new_empty": _host_us(torch, lambda: fit.new_empty((b, (n + 31) // 32, n),
                                                                       dtype=torch.int32)),
                    "current_stream": _host_us(
                        torch, lambda: torch._C._cuda_getCurrentRawStream(0))}
            rule = getattr(kd, "_packed_dominance_vmap", None)
            if callable(rule):
                info = types.SimpleNamespace(batch_size=b, randomness="error")
                host["vmap_rule"] = _host_us(torch, lambda: rule(info, (0,), fit))
            entry["vmap_host_us"] = host
        out[f"{b}x{n}x{m}"] = entry
        del fit
    return out


def _digest_kind(torch, chip_smoke) -> dict:
    from evox_tpu_torch.core.attest import _salt, state_digest
    from evox_tpu_torch.core.struct import named_leaves
    from evox_tpu_torch.kernels import digest as kdg

    wf, _ = chip_smoke.build_cso_path(torch)
    state = wf.init(chip_smoke.SEED).replace(monitors=())
    named = [(n, x) for n, x in named_leaves(state) if isinstance(x, torch.Tensor) and x.numel()]
    leaves, salts = [x for _, x in named], [_salt(n) for n, _ in named]

    def call():
        return kdg.digest_leaves(leaves, salts)

    if hasattr(chip_smoke, "d1_kernel_us"):
        raw = {f"{k}_us": v for k, v in chip_smoke.d1_kernel_us(torch, leaves, salts).items()}
    else:  # the parent's raw launches, from device memory only
        raw = {"memory_us": chip_smoke.d1_kernel_ms(torch, leaves, salts) * 1e3}
    split = _device_split_us(torch, call)
    return {"bytes": sum(x.numel() * x.element_size() for x in leaves), "leaves": len(leaves),
            "ms": chip_smoke._time_ms(call, 3, 20), "host_us": _host_us(torch, call),
            "device_us": sum(split.values()), "device_split_us": split, **raw,
            "state_digest_host_us": _host_us(torch, lambda: state_digest(state)),
            "sha256": _digest(*call())}


def measure(tree: Path, only: set) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import rollout as kr

    _build.build([name for name in ("rollout", "dominance", "smallmm", "digest")
                  if name in _build.SOURCES])
    out = {"tree": str(tree)}
    dev = torch.device("cuda")

    if "rollout" in only:
        wf, _ = chip_smoke.build_main_path(torch, chip_smoke.SEED)
        state = wf.init(chip_smoke.SEED)
        pop, _ = wf.algorithm.ask(state.algo)
        kw = wf.problem.fused_inputs(state.prob, pop)
        totals = kr.fused_rollout(**kw)
        torch.cuda.synchronize()
        out["pendulum_ms"] = chip_smoke._time_ms(lambda: kr.fused_rollout(**kw), 3, 20)
        out["pendulum_sha256"] = _digest(totals)
        out["pendulum_path_ms"] = _path_ms(torch, wf, wf.step(state))
        del wf, state, pop, kw

        env = kr.cartpole_soa(500)
        g = torch.Generator().manual_seed(chip_smoke.SEED)
        theta = (0.5 * torch.randn(8192, 114, generator=g)).to(dev)
        g_dev = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        planes = {k: v.contiguous()
                  for k, v in env.to_soa(env.base.reset(g_dev, 2 * 8192, dev)).items()}
        args = (theta, planes, 500, 4, 16, 2, env, 2)
        totals = kr.fused_rollout(*args, device=dev)
        torch.cuda.synchronize()
        out["cartpole_ms"] = chip_smoke._time_ms(lambda: kr.fused_rollout(*args, device=dev), 3,
                                                 20)
        out["cartpole_sha256"] = _digest(totals)

    if only & {"dominance", "rows"}:
        wf2 = chip_smoke.build_nsga2_path(torch)
        state = wf2.step(wf2.init(chip_smoke.SEED))
        off, astate = wf2.algorithm.ask(state.algo)
        fit, _ = wf2.problem.evaluate(state.prob, off)
        merged = torch.cat([astate.fitness, fit])
        if "dominance" in only:
            packed, count = kd.packed_dominance(merged, device=dev)
            torch.cuda.synchronize()
            out["dominance_ms"] = chip_smoke._time_ms(
                lambda: kd.packed_dominance(merged, device=dev), 3, 20)
            out["dominance_sha256"] = _digest(packed, count)
            out["nsga2_path_ms"] = _path_ms(torch, wf2, wf2.step(state))
        if "rows" in only:
            out["rows"] = _rows(torch, chip_smoke, merged)
    if "m1" in only:
        out["m1"] = _m1(torch, chip_smoke)
    if "batched" in only:
        out["batched"] = _batched(torch, chip_smoke)
    if "digest" in only:
        out["digest"] = _digest_kind(torch, chip_smoke)
    return out


KEYS = ("pendulum_ms", "cartpole_ms", "dominance_ms", "pendulum_path_ms", "nsga2_path_ms")


def _summary_keys(turn: dict) -> dict:
    """A turn's times by name: the flat ones, and M1's and B3 rows' nested."""
    keys = {k: turn[k] for k in KEYS if k in turn}
    for name, e in turn.get("m1", {}).items():
        for field in ("ms", "host_us", "device_us", "graph_us", "bmm_graph_us"):
            keys[f"m1 {name} {field}"] = e[field]
    for field in ("ms", "generation_ms", "host_us", "device_us", "graph_us"):
        if "rows" in turn:
            keys[f"rows {field}"] = turn["rows"][field]
    for shape, e in turn.get("batched", {}).items():
        for field in ("ms", "host_us", "device_us", "graph_us"):
            keys[f"batched {shape} {field}"] = e[field]
        for field, v in e.get("vmap_host_us", {}).items():
            keys[f"batched {shape} {field} host_us"] = v
    for field in ("ms", "host_us", "device_us", "memory_us", "l2_us", "state_digest_host_us"):
        if field in turn.get("digest", {}):
            keys[f"digest {field}"] = turn["digest"][field]
    return keys


def _digests(turn: dict) -> dict:
    out = {k: v for k, v in turn.items() if k.endswith("sha256")}
    out.update({f"m1 {name}": e["sha256"] for name, e in turn.get("m1", {}).items()})
    if "rows" in turn:
        out["rows"] = turn["rows"]["sha256"]
    out.update({f"batched {shape}": e["sha256"] for shape, e in turn.get("batched", {}).items()})
    if "digest" in turn:
        out["digest"] = turn["digest"]["sha256"]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("trees", nargs="*", type=Path)
    parser.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--only", default="rollout,dominance,m1,rows,batched,digest")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    only = set(args.only.split(","))
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve(), only)), flush=True)
        return 0
    if len(args.trees) != 2:
        parser.error("give two checkouts")
    a, b = (t.resolve() for t in args.trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", str(tree),
                              "--only", args.only], cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:] + out.stderr[-8000:], file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {"nvidia_smi": smi, "turns": turns}
    for name, tree in (("a", a), ("b", b)):
        mine = [_summary_keys(t) for t in turns if t["tree"] == str(tree)]
        summary[name] = {"tree": str(tree), **{k: [t[k] for t in mine] for k in mine[0]}}
    digests = [_digests(t) for t in turns]
    summary["same_outputs"] = {k: len({d[k] for d in digests}) == 1 for k in digests[0]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("a", "b", "same_outputs")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
