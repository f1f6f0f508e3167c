#!/usr/bin/env python3
"""A/B of host-bound main paths of two checkouts of the port, on one CUDA
card, in turns, as ``chip_smoke.py`` builds them: path 1 (OpenES on the
fused pendulum, pop 65536), path 2 (NSGA-II on LSMOP1, pop 10000, d 300),
path 7 (MOEA/D on DTLZ2, 9870 subproblems), path 9 (SHADE on Ackley, pop
4096, d 1024), path 14 (8 PSO islands of 512 on Ackley, d 256, migrating
every 8), path 16 (PSO on the host Sphere, pop 2048, d 512, sleeping 4
ms: ``run_host_pipelined`` and the serialized ask, evaluate, tell loop),
path 21 (PSO 256 x 64 on Ackley with ``TelemetryMonitor(30)`` and donated
carries) and path 36's fleet (16 PSO tenants of 256 on Sphere, d 64, each
with ``TelemetryMonitor(8)``, under one vmap): the last two carry the
telemetry ring's sums; path 5 (CMA-ES on Rastrigin at d 1000, pop 24),
path 28 (64 CMA-ES tenants of pop 256 at d 16 under one vmap) and path 31
(path 2 with the mesh-sharded sort on an 8-shard mesh of the card): M1's
and B3 rows' callers; path 30 (``ShardedES(SepCMAES)`` at pop 65536, d 32
on an 8-shard mesh of the card, as the checkout's ``chip_smoke.py`` builds
it) and its replicated twin (``mesh=None, n_shards=8``). ``--only
NAME[,NAME]`` times some of the groups ``pendulum, nsga2, shade, moead,
islands, host, telemetry, cmaes, fleet, sharded_nsga2, sharded_es``.

Each turn runs in a fresh process inside one checkout: it builds that
checkout's CUDA sources, takes the init step and one warm-up generation,
and times 20 generations, three times (host clock, the card synchronised
on both sides); it reports each path's median ms a generation, and for
path 14 the kernels and the device-to-host copies a generation that
torch.profiler counts over 8 generations. The turns go A, B, B, A, so that a slower host between calls
shows on both checkouts alike. Run from a checkout, with both checkouts
unpacked (``git archive``) into directories::

    python3 tools/torch_path_ab.py DIR_A DIR_B [--only NAMES] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

GENERATIONS, REPEATS = 20, 3


def _ms(torch, wf, state, run=None) -> float:
    run = run or wf.run
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, GENERATIONS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / GENERATIONS * 1e3)
    return statistics.median(times)


def _profile_counts(torch, wf, state, gens: int = 8) -> tuple:
    """(kernel launches, device-to-host copies) a generation of ``gens``
    generations, by torch.profiler's CUDA rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wf.run(state, gens)
        torch.cuda.synchronize()
    kernels = copies = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += evt.count if "DtoH" in evt.key else 0
        else:
            kernels += evt.count
    return kernels / gens, copies / gens


def _chained_ms(torch, wf, state) -> float:
    """As :func:`_ms`, each run starting from the last one's state (a
    workflow with donated carries consumes its input)."""
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = wf.run(state, GENERATIONS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / GENERATIONS * 1e3)
    return statistics.median(times)


def _telemetry_paths(torch, chip_smoke) -> dict:
    """Path 21 and path 36's fleet at pop 256, both carrying the
    telemetry ring."""
    import numpy as np

    from evox_tpu_torch.workflows.elastic import ACTIVE_ROWS, BucketShape

    tel = chip_smoke.build_telemetry_path(torch)
    out = {"telemetry": _chained_ms(torch, tel, tel.step(tel.step(tel.init(11))))}
    width = chip_smoke.EL_WIDTH
    fleet = chip_smoke.elastic_factory(torch)(BucketShape(256, chip_smoke.EL_DIM, width))
    state = fleet.init(list(range(width)),
                       hyperparams={ACTIVE_ROWS: np.full((width,), 256, np.int32)})
    out["elastic_fleet"] = _chained_ms(torch, fleet, fleet.run(state, 2))
    return out


def _host_paths(torch, chip_smoke) -> dict:
    """Path 16 piped (``run_host_pipelined``) and serial (ask, evaluate,
    tell on the calling thread, ``bench.py:676-706``)."""
    from evox_tpu_torch.workflows import chunked_evaluate, run_host_pipelined
    from evox_tpu_torch.workflows.common import host_candidates

    wf = chip_smoke.build_host_path(torch)
    state = run_host_pipelined(wf, wf.init(chip_smoke.HE_SEED), 2)

    def serial(s, n):
        for _ in range(n):
            cand, ctx = wf.pipeline_ask(s)
            fitness, _ = chunked_evaluate(wf.problem, s.prob,
                                          host_candidates(wf.host_link, cand), None)
            s = wf.pipeline_tell(s, ctx, fitness, s.prob)
        return s

    return {"host_piped": _ms(torch, wf, state, lambda s, n: run_host_pipelined(wf, s, n)),
            "host_serial": _ms(torch, wf, state, serial)}


def _cmaes_paths(torch, chip_smoke, only: set) -> dict:
    """Path 5 (CMA-ES at d 1000), path 28's fleet (64 tenants under one
    vmap), path 31 (NSGA-II with the mesh-sharded sort, 8 shards) and path
    30 (ShardedES on 8 shards) with its replicated twin."""
    out = {}
    if "cmaes" in only:
        wf = chip_smoke.build_cmaes_path(torch)
        out["cmaes"] = _ms(torch, wf, wf.step(wf.step(wf.init(0))))
    if "fleet" in only:
        fleet, _ = chip_smoke.build_fleet_path(torch)
        state = fleet.run(fleet.init(list(range(chip_smoke.TEN_N))), 2)
        out["fleet"] = _ms(torch, fleet, state)
    if "sharded_nsga2" in only:
        from evox_tpu_torch.core.distributed import create_mesh

        mesh = create_mesh(devices=[torch.device("cuda", 0)] * chip_smoke.PATH31_SHARDS)
        wf = chip_smoke.build_sharded_nsga2_path(torch, mesh)
        out["sharded_nsga2"] = _ms(torch, wf, wf.step(wf.step(wf.init(0))))
    if "sharded_es" in only:
        from evox_tpu_torch.core.distributed import create_mesh

        mesh = create_mesh(devices=[torch.device("cuda", 0)] * chip_smoke.LP_SHARDS)
        for name, m in (("sharded_es", mesh), ("sharded_es_replicated", None)):
            wf = chip_smoke.build_sharded_es_path(torch, m, chip_smoke.LP_SHARDS)
            out[name] = _ms(torch, wf, wf.step(wf.step(wf.init(chip_smoke.LP_SEED))))
    return out


def measure(tree: Path, only: set) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import MOEAD
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.problems.numerical import DTLZ2

    _build.build()
    out = {}
    if "pendulum" in only:
        pendulum, _ = chip_smoke.build_main_path(torch, 0)
        out["pendulum"] = _ms(torch, pendulum, pendulum.step(pendulum.step(pendulum.init(0))))
    if "nsga2" in only:
        nsga2 = chip_smoke.build_nsga2_path(torch)
        wf = StdWorkflow(nsga2.algorithm, nsga2.problem)
        out["nsga2"] = _ms(torch, wf, wf.step(wf.step(wf.init(0))))
    if "shade" in only:
        shade = chip_smoke.build_shade_path(torch)
        out["shade"] = _ms(torch, shade, shade.step(shade.step(shade.init(0))))
    if "moead" in only:
        lb, ub = torch.zeros(chip_smoke.MOEAD_D), torch.ones(chip_smoke.MOEAD_D)
        moead = StdWorkflow(MOEAD(lb, ub, n_objs=chip_smoke.MO_M, pop_size=chip_smoke.MO_POP,
                                  aggregate_op="pbi"),
                            DTLZ2(d=chip_smoke.MOEAD_D, m=chip_smoke.MO_M))
        out["moead"] = _ms(torch, moead, moead.step(moead.step(moead.init(0))))
    if "islands" in only:
        islands, _ = chip_smoke.build_island_paths(torch)
        warm = islands.step(islands.step(islands.init(0)))
        out["islands"] = _ms(torch, islands, warm)
        out["islands_kernels_per_gen"], out["islands_dtoh_per_gen"] = _profile_counts(
            torch, islands, warm)
    if "host" in only:
        out.update(_host_paths(torch, chip_smoke))
    if "telemetry" in only:
        out.update(_telemetry_paths(torch, chip_smoke))
    out.update(_cmaes_paths(torch, chip_smoke, only))
    return out


GROUPS = ("pendulum,nsga2,shade,moead,islands,host,telemetry,cmaes,fleet,sharded_nsga2,sharded_es")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a", type=Path)
    parser.add_argument("b", type=Path)
    parser.add_argument("--only", default=GROUPS)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--turn", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn is not None:
        print(json.dumps(measure(args.turn.resolve(), set(args.only.split(",")))), flush=True)
        return 0
    args.a, args.b = args.a.resolve(), args.b.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for name, tree in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(args.a), str(args.b),
                               "--turn", str(tree), "--only", args.only], capture_output=True,
                              text=True, cwd=str(tree))
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"turn {name} in {tree} exited {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"checkout": name, **result})
        print(json.dumps(turns[-1]), flush=True)
    summary = {"device": smi, "turns": turns, "median_ms_per_generation": {
        side: {path: statistics.median(t[path] for t in turns if t["checkout"] == side)
               for path in turns[0] if path != "checkout"} for side in ("A", "B")}}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
