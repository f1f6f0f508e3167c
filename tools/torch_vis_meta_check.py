#!/usr/bin/env python3
"""The paths of ``chip_smoke.py`` that stream, meta-train and step
optimizers, alone, on one CUDA card: path 41 (path 2 streamed to EvoXVis),
path 42 (LES meta-training at the JAX package's configuration), path 43
(every optimizer on the card against the CPU; OpenES with adamw on path
1), and path 35 (the rollout farms, the per-worker placement on the card).
It builds the CUDA sources first and prints each phase's JSON line;
``--only NAME[,NAME]`` runs some of them (``vis``, ``les_meta``,
``optimizers``, ``farm``), ``--out PATH`` writes every result as JSON. Run
from a checkout::

    python3 tools/torch_vis_meta_check.py [--only vis,les_meta] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=None)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_vis_meta_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evox_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs the paths
    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] in {time.perf_counter() - t0:.2f} s", flush=True)
    phases = {
        "vis": cs.phase_vis_path,
        "les_meta": cs.phase_les_meta_path,
        "optimizers": cs.phase_optimizers_path,
        "farm": cs.phase_farm_path,
    }
    wanted = list(phases) if args.only is None else args.only.split(",")
    out = {}
    for name in wanted:
        t0 = time.perf_counter()
        out[name] = phases[name](torch)
        out[name + "_command_s"] = time.perf_counter() - t0
        print(f"[phase] {name} {out[name + '_command_s']:.1f} s", flush=True)
        torch.cuda.empty_cache()
        if args.out is not None:  # after every phase: a later failure keeps these
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(out, indent=1))
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
