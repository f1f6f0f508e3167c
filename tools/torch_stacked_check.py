#!/usr/bin/env python3
"""The stacked member form's phases of ``chip_smoke.py`` alone, on one CUDA
card: B3 batched over members against its plain version and against
single launches, path 14 (8 PSO islands, stacked), the MO islands, the
SHADE islands, the containers, path 28 (``bench.py``'s workload 5: a
64-tenant CMA-ES fleet against its 64 runs one after the other) and path
29 (``bench.py``'s RunQueue leg). It builds the CUDA sources first, as
``chip_smoke.py`` does, and prints each phase's JSON line; ``--profile``
adds the profiler's kernels and DtoH copies a generation on paths 14 and
28, ``--out PATH`` writes every result as JSON. Run from a checkout::

    python3 tools/torch_stacked_check.py [--profile] [--out PATH]
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
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_stacked_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evox_tpu_torch.kernels import _build

    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} CUDA source(s) in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in (_build.build_log("dominance") or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas dominance] {line.strip()}", flush=True)
    out = {}
    phases = (
        ("dominance_batched", lambda: cs.phase_dominance_batched(torch)),
        ("islands", lambda: cs.phase_island_path(torch, cs.SEED, args.profile)),
        ("mo_islands", lambda: cs.phase_mo_islands(torch, cs.SEED)),
        ("shade_islands", lambda: cs.phase_shade_islands(torch)),
        ("containers", lambda: cs.phase_containers(torch)),
        ("fleet", lambda: cs.phase_fleet_path(torch, profile=args.profile)),
        ("runqueue", lambda: cs.phase_runqueue_path(torch)),
    )
    for name, phase in phases:
        t0 = time.perf_counter()
        out[name] = phase()
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
