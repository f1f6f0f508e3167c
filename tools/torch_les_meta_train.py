#!/usr/bin/env python3
"""LES meta-training at the JAX package's full configuration on one CUDA
card (``evox_tpu_torch/algorithms/so/es/les_meta.py``: outer OpenES pop 64,
10 tasks, inner LES pop 16 at d 8 for 40 generations), up to 4000 outer
generations; when the first ``--probe`` generations project the whole run
past ``--budget-s`` seconds, it stops at ``--fallback`` generations and
says so. Prints progress every 100 generations, then the seconds taken and
the mean log10-gap on ``chip_smoke.py``'s 50 held-out tasks (path 42's,
seed 0) of the trained center against the bundled parameters'. The
trained vector goes to ``--out-dir`` (never to the bundled file). Run from
a checkout::

    python3 tools/torch_les_meta_train.py --out-dir chiprun_out/les_meta
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
    parser.add_argument("--outer-gens", type=int, default=4000)
    parser.add_argument("--fallback", type=int, default=1000)
    parser.add_argument("--budget-s", type=float, default=600.0)
    parser.add_argument("--probe", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out-dir", type=Path, default=Path("chiprun_out") / "les_meta")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_les_meta_train: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evox_tpu_torch.algorithms.so.es import les_meta

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    trainer = les_meta.MetaTrainer(args.seed, device=dev)
    ostate, step_seed = trainer.init()
    target = args.outer_gens
    t0 = time.perf_counter()
    done = 0
    while done < target:
        ostate, step_seed, fit = trainer.step(ostate, step_seed)
        done += 1
        if done == args.probe:
            torch.cuda.synchronize()
            projected = (time.perf_counter() - t0) / done * target
            print(f"[probe] {done} generations: {projected:.0f} s projected for {target}",
                  flush=True)
            if projected > args.budget_s:
                target = args.fallback
                print(f"[probe] over the {args.budget_s:.0f} s budget: stopping at {target}",
                      flush=True)
        if done % 100 == 0:
            print(f"meta-gen {done}/{target}: best mean log10-gap {float(fit.min()):.3f}",
                  flush=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    # path 42's held-out tasks and draws
    seed = cs.SEED
    held = les_meta.sample_tasks(seed + 4242, cs.LM_HELD_OUT, les_meta.META_DIM, dev)
    held["type"] = torch.arange(cs.LM_HELD_OUT, dtype=torch.int32, device=dev) % les_meta.N_FAMILIES
    noise = torch.randn((les_meta.INNER_GENS, cs.LM_HELD_OUT, les_meta.INNER_POP,
                         les_meta.META_DIM),
                        generator=torch.Generator(device=dev).manual_seed(seed + 4243), device=dev)
    bundled = torch.from_numpy(np.load(les_meta.PARAMS_PATH)["flat"]).to(dev)
    scores = trainer.meta_fitness(torch.stack([ostate.center, bundled]), held, noise).cpu()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    les_meta.save_params(ostate.center, args.out_dir / "les_params.npz")
    out = {"outer_generations": done, "asked": args.outer_gens, "seconds": seconds,
           "ms_per_outer_generation": seconds * 1e3 / done,
           "held_out_mean_log10_gap": {"trained": float(scores[0]), "bundled": float(scores[1]),
                                       "tasks": cs.LM_HELD_OUT},
           "saved": str(args.out_dir / "les_params.npz")}
    (args.out_dir / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
