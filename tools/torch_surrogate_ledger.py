#!/usr/bin/env python3
"""The true-evaluation ledger of ``bench.py``'s workload 8 over several seeds.

For each seed, ``SurrogateWorkflow`` (``chip_smoke.build_surrogate_path``:
PSO 128 × 8, ``GPSurrogate``, screen_frac 1/8, a sleep-free host Sphere)
and its full-evaluation twin each ``run`` in chunks of 2 until the
telemetry's best is under 1e-2 (at most 120 generations, as
``bench.py:1001-1011``); prints one JSON line a seed (generations and true
evaluations of each side, their ratio) and a summary line. The counts
depend on the draws, so their spread over seeds is what one seed's ratio
is read against. Runs on the card; ``--device cpu`` runs the CPU's plain
routes (other random streams: other counts, the same law)::

    python3 tools/torch_surrogate_ledger.py [--seeds 8] [--device cpu]
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs

    if args.device != "cpu":
        print(cs._nvidia_smi(), flush=True)
    ratios = []
    for seed in range(args.seeds):
        scr = cs.build_surrogate_path(torch, pop=cs.SUR_LEDGER_POP, sleep=0.0, device=args.device)
        full = cs.full_twin(cs.build_surrogate_path(torch, pop=cs.SUR_LEDGER_POP, sleep=0.0,
                                                    device=args.device))
        s_scr, g_scr, b_scr = cs.run_to_threshold(scr, seed)
        _, g_full, b_full = cs.run_to_threshold(full, seed)
        evals_scr, evals_full = int(s_scr.sur.true_evals), g_full * cs.SUR_LEDGER_POP
        ratios.append(evals_full / evals_scr)
        print(json.dumps({"seed": seed, "screened": {"generations": g_scr, "true_evals": evals_scr,
                                                     "best": b_scr,
                                                     "fallback_gens": int(s_scr.sur.fallback_gens)},
                          "full": {"generations": g_full, "true_evals": evals_full, "best": b_full},
                          "ratio": ratios[-1]}), flush=True)
    print(json.dumps({"device": args.device or "cuda", "seeds": args.seeds, "ratio_min": min(ratios),
                      "ratio_median": statistics.median(ratios), "ratio_max": max(ratios)}),
          flush=True)


if __name__ == "__main__":
    main()
