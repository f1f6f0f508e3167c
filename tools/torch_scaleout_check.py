#!/usr/bin/env python3
"""The scale-out and supervision phases of ``chip_smoke.py`` alone, on one
CUDA card: kernel M1 against its plain version and across batch counts,
B3's rows form against the full B3, path 28 (the 64-tenant CMA-ES fleet,
tenants bit for bit with their solo runs) and path 29 (the RunQueue leg),
then paths 30-32 (ShardedES on ``bench.py``'s workload 7, NSGA-II with the
mesh-sharded sort, NSGA-II under ``RunSupervisor``), paths 44-45 (``pair``:
paths 30 and 31 in two processes on the card, held against the runs of
``sharded_es`` and ``sharded_nsga2``, which must come first) and the NCCL
world of one. It builds the CUDA sources first, as ``chip_smoke.py`` does,
and prints each phase's JSON line; ``--only NAME[,NAME]`` runs some of
them, ``--out PATH`` writes every result as JSON. Run from a checkout::

    python3 tools/torch_scaleout_check.py [--only smallmm,dominance_rows] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
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
        print("torch_scaleout_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evox_tpu_torch.kernels import _build

    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} CUDA source(s) in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("dominance", "smallmm"):
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    refs = tempfile.TemporaryDirectory()  # paths 30 and 31's runs, for paths 44-45
    phases = {
        "smallmm": cs.phase_smallmm_kernel,
        "dominance_rows": cs.phase_dominance_rows,
        "fleet": cs.phase_fleet_path,
        "runqueue": cs.phase_runqueue_path,
        "sharded_es": lambda t: cs.phase_sharded_es(t, ref_dir=refs.name),
        "sharded_nsga2": lambda t: cs.phase_sharded_nsga2(t, ref_dir=refs.name),
        "pair": lambda t: cs.phase_pair_paths(t, Path(refs.name)),
        "supervised_nsga2": cs.phase_supervised_nsga2,
        "nccl_world": cs.phase_nccl_world,
    }
    wanted = list(phases) if args.only is None else args.only.split(",")
    if "pair" in wanted and not {"sharded_es", "sharded_nsga2"} <= set(
            wanted[:wanted.index("pair")]):
        parser.error("pair needs sharded_es and sharded_nsga2 before it")
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
    refs.cleanup()
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
