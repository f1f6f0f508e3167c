#!/usr/bin/env python3
"""A/B of FMA contraction in the port's rollout kernel, on one CUDA card.

Builds ``evox_tpu_torch/csrc/rollout.cu`` twice into a temporary directory
— with the port's flags (``-fmad=false``) and with contraction allowed —
and runs both on the same inputs: the pendulum main path's first-generation
population (pop 65536, 2 episodes, T 200) and cartpole at pop 8192, T 500.
For each build it prints one JSON line: the time per launch (CUDA events,
turns A, B, B, A) and how many envs match ``fused_rollout_plain`` bit for
bit. Run from the repository root::

    python3 tools/torch_fmad_ab.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fmad_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import rollout as kr

    variants = {
        "no_contraction": _build.NVCC_FLAGS,
        "contraction": tuple(f for f in _build.NVCC_FLAGS if f != "-fmad=false"),
    }
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in variants.items():
            out = Path(tmp) / f"lib{name}.so"
            subprocess.run(
                [_build.nvcc_path(), *flags, "-o", str(out), str(_build.SOURCES["rollout"])],
                check=True, capture_output=True,
            )
            libs[name] = ctypes.CDLL(str(out))

    wf, _ = chip_smoke.build_main_path(torch, 0)
    state = wf.init(0)
    pop, _ = wf.algorithm.ask(state.algo)
    pend = wf.problem.fused_inputs(state.prob, pop)
    g = torch.Generator(device="cuda").manual_seed(0)
    env = kr.cartpole_soa(500)
    theta = 0.5 * torch.randn(8192, 114, generator=g, device="cuda")
    planes = {k: v.contiguous() for k, v in env.to_soa(env.base.reset(g, 2 * 8192, theta.device)).items()}
    cart = dict(theta=theta, init_state=planes, T=500, obs_dim=4, hidden=16, act_dim=2,
                env=env, episodes=2, device="cuda")
    cases = {"pendulum": pend, "cartpole": cart}
    plain = {
        c: kr.fused_rollout_plain(**{k: v for k, v in kw.items() if k != "device"})
        for c, kw in cases.items()
    }

    results = {name: {} for name in variants}
    for name in ("no_contraction", "contraction", "contraction", "no_contraction"):
        kr._LIB.pop("rollout", None)
        _build._loaded["rollout"] = libs[name]
        for c, kw in cases.items():
            got = kr.fused_rollout(**kw)
            ms = chip_smoke._time_ms(lambda: kr.fused_rollout(**kw), 3, 30)
            r = results[name].setdefault(c, {"ms": []})
            r["ms"].append(ms)
            r["exact_frac"] = float((got == plain[c]).float().mean())
            r["max_abs_err"] = float((got - plain[c]).abs().max())
    print(chip_smoke._nvidia_smi())
    for name, r in results.items():
        print(json.dumps({"build": name, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
