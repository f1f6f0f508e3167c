#!/usr/bin/env python3
"""The serving, fleet-health and pod paths of ``chip_smoke.py`` alone, on
one CUDA card: path 36 (elastic serving: buckets, warm admission,
autoscaling, the cold start of a fresh process with and without the
manifest's pre-warm), path 37 (path 28's fleet under a health policy, NaN
in three tenants), path 38 (``MultiLevelES`` over B1's pendulum), path 39
(the multi-pod ``ControlPlane`` with a pod declared dead) and path 40
(path 2 under ``PodSupervisor`` in a world of one over NCCL). It builds the
sources those paths launch (B1's, B3's, B4's and M1's) and prints each
phase's JSON line; ``--only NAME[,NAME]`` runs some of them (``elastic``,
``fleet_health``, ``multilevel``, ``control_plane``, ``pod_supervisor``),
``--profile`` adds path 37's DtoH copies a chunk, ``--cold-rounds N``
sets path 36's cold-start rounds (default ``chip_smoke.py``'s), ``--out
PATH`` writes every result as JSON. Run from a checkout::

    python3 tools/torch_serving_check.py [--only elastic] [--cold-rounds N] [--profile] \
        [--out PATH]
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
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--cold-rounds", type=int, default=None)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_check: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evox_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs the paths
    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _build.build(["rollout", "smallmm", "dominance", "topk"])
    print(f"[build] rollout, smallmm, dominance, topk in {time.perf_counter() - t0:.2f} s",
          flush=True)
    phases = {
        "elastic": lambda torch: cs.phase_elastic_path(
            torch, cold_rounds=cs.EL_COLD_ROUNDS if args.cold_rounds is None
            else args.cold_rounds),
        "fleet_health": lambda torch: cs.phase_fleet_health_path(torch, profile=args.profile),
        "multilevel": cs.phase_multilevel_path,
        "control_plane": cs.phase_control_plane_path,
        "pod_supervisor": cs.phase_pod_supervised_nsga2,
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
