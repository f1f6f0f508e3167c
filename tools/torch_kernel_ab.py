#!/usr/bin/env python3
"""A/B of the pendulum rollout kernel (``fused_rollout``) and the dominance
kernel (``packed_dominance``) of two checkouts of the port, on one CUDA
card, in turns.

Each turn runs in a fresh process inside one checkout: it builds that
checkout's ``csrc/rollout.cu`` and ``csrc/dominance.cu`` and times, with
CUDA events (mean of 20 launches after 3 warm-up):

- ``fused_rollout`` on the pendulum main path's first-generation inputs
  (``chip_smoke.build_main_path``: OpenES at pop 65536, MLP 3-16-1, 2
  episodes, T 200, seed 0), and on cartpole at pop 8192, 2 episodes, T 500
  (genomes of scale 0.5, seed 0);
- ``packed_dominance`` on the NSGA-II main path's first merged fitness
  (``chip_smoke.build_nsga2_path``: n 20000, m 3, seed 0);

and both main paths end to end, as ``chip_smoke.py`` runs them: ms a
generation over 20 generations of ``run`` after a warm-up, host clock,
card synchronised on both sides.

The turns go A, B, B, A. Each prints one JSON line with the times and a
digest of every output; the last line holds both checkouts' times. Run from
a checkout::

    python3 tools/torch_kernel_ab.py DIR_A DIR_B [--out PATH]
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


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import rollout as kr

    _build.build(["rollout", "dominance"])
    out = {"tree": str(tree)}

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

    dev = torch.device("cuda")
    env = kr.cartpole_soa(500)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    theta = (0.5 * torch.randn(8192, 114, generator=g)).to(dev)
    g_dev = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    planes = {k: v.contiguous() for k, v in env.to_soa(env.base.reset(g_dev, 2 * 8192, dev)).items()}
    args = (theta, planes, 500, 4, 16, 2, env, 2)
    totals = kr.fused_rollout(*args, device=dev)
    torch.cuda.synchronize()
    out["cartpole_ms"] = chip_smoke._time_ms(lambda: kr.fused_rollout(*args, device=dev), 3, 20)
    out["cartpole_sha256"] = _digest(totals)

    wf2 = chip_smoke.build_nsga2_path(torch)
    state = wf2.step(wf2.init(chip_smoke.SEED))
    off, astate = wf2.algorithm.ask(state.algo)
    fit, _ = wf2.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    packed, count = kd.packed_dominance(merged, device=dev)
    torch.cuda.synchronize()
    out["dominance_ms"] = chip_smoke._time_ms(lambda: kd.packed_dominance(merged, device=dev), 3, 20)
    out["dominance_sha256"] = _digest(packed, count)
    out["nsga2_path_ms"] = _path_ms(torch, wf2, wf2.step(state))
    return out


KEYS = ("pendulum_ms", "cartpole_ms", "dominance_ms", "pendulum_path_ms", "nsga2_path_ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", type=Path)
    parser.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve())), flush=True)
        return 0
    if len(args.trees) != 2:
        parser.error("give two checkouts")
    a, b = (t.resolve() for t in args.trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", str(tree)],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {"nvidia_smi": smi, "turns": turns}
    for name, tree in (("a", a), ("b", b)):
        mine = [t for t in turns if t["tree"] == str(tree)]
        summary[name] = {"tree": str(tree), **{k: [t[k] for t in mine] for k in KEYS}}
    same = {k: len({t[k] for t in turns}) == 1
            for k in ("pendulum_sha256", "cartpole_sha256", "dominance_sha256")}
    summary["same_outputs"] = same
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("a", "b", "same_outputs")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
