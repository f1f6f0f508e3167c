#!/usr/bin/env python3
"""A/B of the walker kernel (``fused_mlp_rollout``) of two checkouts of the
port, on one CUDA card, in turns.

Each turn runs in a fresh process inside one checkout: it builds that
checkout's ``csrc/rollout_mlp.cu``, makes the walker main path's
first-generation inputs (``chip_smoke.build_walker_path``: OpenES at pop
65536, MLP 244-64-64-17, T 100, seed 0) and times one launch with CUDA
events, mean of 10 after 2 warm-up, at T 100 (``ms``) and at T 0
(``copy_only_ms``: the launch, the policy copies and the state loads). The
turns go A, B, B, A. Each prints one JSON line, with a digest of the
returns; the last line holds both checkouts' times. Run from a checkout::

    python3 tools/torch_walker_ab.py DIR_A DIR_B [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import rollout_mlp as km

    _build.build(["rollout_mlp"])
    wf, _, adapter = chip_smoke.build_walker_path(torch)
    state = wf.init(chip_smoke.SEED)
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
    totals = km.fused_mlp_rollout(**kw)
    torch.cuda.synchronize()
    ms = chip_smoke._time_ms(lambda: km.fused_mlp_rollout(**kw), 2, 10)
    copy_ms = chip_smoke._time_ms(lambda: km.fused_mlp_rollout(**dict(kw, T=0)), 2, 10)
    digest = hashlib.sha256(totals.cpu().numpy().tobytes()).hexdigest()[:16]
    return {"tree": str(tree), "ms": ms, "copy_only_ms": copy_ms,
            "mean_return": float(totals.mean()), "returns_sha256": digest}


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
        summary[name] = {"tree": str(tree), "ms": [t["ms"] for t in mine],
                         "copy_only_ms": [t["copy_only_ms"] for t in mine]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("a", "b")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
