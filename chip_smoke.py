#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``evox_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py [--out PATH] [--profile]

Phases (each raises on failure; nothing is caught so the run could still
exit 0):

1. device: the card's name and power limit (nvidia-smi); build every CUDA
   source of the port from the checkout (one nvcc per source, in parallel).
2. kernel against plain: ``fused_rollout`` on the card against
   ``fused_rollout_plain`` on the same inputs — pendulum at pop 65536,
   2 episodes, T 200 (the main path's shape), and cartpole (early exit) at
   pop 8192 and 1500 (ragged edge), T 500. Times both with CUDA events.
3. main path: ``StdWorkflow(OpenES(zeros(81), 65536), PolicyRolloutProblem(
   flat_mlp_policy 3-16-1, pendulum(200), 2 episodes, fused_env=
   pendulum_soa(200)), opt_direction="max")`` — init, one warm-up step,
   then ``run`` for 20 generations with the launch counters set to 0 just
   before and read just after. Checks one launch per generation, finite fitness,
   a center that moved, and the fused engine against the scan engine (the
   plain PyTorch reference engine) on a small population.
4. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when CUDA is unavailable or when the
checkout is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks: FP32 outside the tensor cores and HBM
# bandwidth, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
GENERATIONS = 20  # timed main-path generations, after one warm-up step
SEED = 0


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def _time_ms(fn, warmup: int, reps: int) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rollout_work(n: int, episodes: int, steps: int, obs: int, hidden: int, act: int,
                 env_ops: int, trig: int) -> tuple:
    """(bytes, operations) that a fused rollout must move and do.

    Bytes: genomes read once, state planes read once, returns written once.
    Operations per env-step: the MLP's multiply-adds (2 each), one per tanh,
    one per distinct trig call, and the env step's arithmetic (counted
    from csrc/rollout.cu). Counting a transcendental as one operation makes
    this a lower bound. ``steps`` is the env-steps this run's data needs.
    """
    dim = obs * hidden + hidden + hidden * act + act
    state_planes = {3: 2, 4: 4}[obs]
    nbytes = 4 * (n * dim + state_planes * episodes * n + episodes * n)
    per_step = 2 * (obs * hidden + hidden * act) + hidden + trig + env_ops
    return nbytes, per_step * steps


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want, rtol: float, atol: float) -> dict:
    """Per-env returns against a reference: every env within
    ``atol + rtol * |want|`` (0 and 0: bit for bit)."""
    import torch

    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    stats = {
        "envs": int(got.numel()),
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-6)).max()),
        "median_abs_err": float(diff.median()),
        "outside_tol": int(bad.sum()),
        "rtol": rtol,
        "atol": atol,
        "exact_frac": float((diff == 0).float().mean()),
    }
    print(f"[compare] {name}: {json.dumps(stats)}", flush=True)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel returned non-finite values")
    if stats["outside_tol"]:
        raise AssertionError(f"{name}: disagrees with its reference: {stats}")
    return stats


def build_main_path(torch, seed: int):
    """The main path as a user builds it: ``(workflow, make_problem)``."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.kernels import rollout as kr
    from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, flat_mlp_policy

    soa = kr.pendulum_soa(max_steps=200)
    apply, dim = flat_mlp_policy(soa.base.obs_dim, 16, soa.base.act_dim)

    def make_problem(fused):
        return PolicyRolloutProblem(
            apply, soa.base, num_episodes=2, stochastic_reset=False,
            fused_env=soa if fused else None, early_exit=False,
        )

    class FitnessRecorder(Monitor):
        """Each generation's mean fitness and a finite flag, kept as device
        tensors and read once, after the run."""

        def init(self, seed=None):
            return ()

        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            return mstate + ((fitness.mean(), torch.isfinite(fitness).all()),)

    algo = OpenES(torch.zeros(dim), 65536, learning_rate=0.05, noise_stdev=0.05)
    wf = StdWorkflow(algo, make_problem(True), monitors=[FitnessRecorder()], opt_direction="max")
    return wf, make_problem


def phase_kernels(torch, kr, wf, seed: int) -> dict:
    """Hold fused_rollout against fused_rollout_plain on the card."""
    dev = torch.device("cuda")
    results = {}

    # pendulum: the inputs the main path hands the kernel in its first
    # generation (OpenES's population, the problem's episode resets)
    state = wf.init(seed)
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_inputs(state.prob, pop)
    plain_kw = {k: v for k, v in kw.items() if k != "device"}
    got = kr.fused_rollout(**kw)
    torch.cuda.synchronize()
    want = kr.fused_rollout_plain(**plain_kw)
    torch.cuda.synchronize()
    # bit for bit: the kernel does the plain version's operations in the
    # same order, each rounded on its own (no FMA contraction)
    stats = compare("pendulum, main-path inputs n=65536 ep=2 T=200", got, want,
                    rtol=0.0, atol=0.0)
    stats["ms"] = _time_ms(lambda: kr.fused_rollout(**kw), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(**plain_kw), 1, 3)
    n, ep, T = pop.shape[0], kw["episodes"], kw["T"]
    nbytes, ops = rollout_work(n, ep, ep * n * T, 3, 16, 1, env_ops=25, trig=2)
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    results["pendulum"] = stats

    def stress_inputs(env, n, episodes, scale):
        """Large random genomes and a fresh reset per env: policies that
        drive the system hard, where trajectories are sensitive."""
        g = torch.Generator().manual_seed(seed)
        obs, act = env.base.obs_dim, env.base.act_dim
        dim = obs * 16 + 16 + 16 * act + act
        theta = (scale * torch.randn(n, dim, generator=g)).to(dev)
        g_dev = torch.Generator(device=dev).manual_seed(seed)
        states = env.base.reset(g_dev, episodes * n, dev)
        planes = {k: v.contiguous() for k, v in env.to_soa(states).items()}
        return theta, planes

    # a driven pendulum turns any last-ulp difference into a different
    # trajectory in some envs, so bit-for-bit agreement is the only check
    # that means something here
    env = kr.pendulum_soa(200)
    theta, planes = stress_inputs(env, 65536, 2, 0.5)
    args = (theta, planes, 200, 3, 16, 1, env, 2)
    got = kr.fused_rollout(*args, device=dev)
    want = kr.fused_rollout_plain(*args)
    torch.cuda.synchronize()
    results["pendulum_stress"] = compare(
        "pendulum, stress inputs n=65536 ep=2 T=200", got, want,
        rtol=0.0, atol=0.0)

    # cartpole: terminating, the per-warp early exit; ragged edge at 1500
    env = kr.cartpole_soa(500)
    for n in (8192, 1500):
        theta, planes = stress_inputs(env, n, 2, 0.5)
        args = (theta, planes, 500, 4, 16, 2, env, 2)
        got = kr.fused_rollout(*args, device=dev)
        torch.cuda.synchronize()
        want = kr.fused_rollout_plain(*args)
        torch.cuda.synchronize()
        # bit for bit, as for pendulum (a bang-bang action flips on a
        # last-ulp difference of a1 - a0)
        stats = compare(f"cartpole n={n} ep=2 T=500", got, want,
                        rtol=0.0, atol=0.0)
        if n == 8192:
            stats["ms"] = _time_ms(lambda: kr.fused_rollout(*args, device=dev), 3, 20)
            stats["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(*args), 1, 3)
            steps = int(want.sum().item())  # live env-steps this data needs
            nbytes, ops = rollout_work(n, 2, steps, 4, 16, 2, env_ops=36, trig=2)
            stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
            stats["mean_return"] = float(want.mean())
        results[f"cartpole_{n}"] = stats
    return results


def phase_main_path(torch, kr, wf, make_problem, gens: int, seed: int, profile: bool) -> dict:
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    state = wf.step(state)  # warm-up: first-use library loads, cuBLAS handle
    torch.cuda.synchronize()

    kr.fused_rollout.launches = 0  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kr.fused_rollout.launches  # read just after
    if launches != gens:
        raise AssertionError(f"fused_rollout launched {launches} times in {gens} generations")
    if state.generation != gens + 1:
        raise AssertionError(f"generation {state.generation} != {gens + 1}")
    records = state.monitors[0]
    means = [float(m) for m, _ in records]
    if not all(bool(f) for _, f in records):
        raise AssertionError("non-finite fitness on the main path")
    moved = float((state.algo.center - center0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the center did not move (|delta| = {moved})")

    # the repo's own means: fused engine == scan engine on the same resets,
    # up to float rounding (the scan engine's policy sums in another order)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dim = state.algo.center.shape[0]
    small = state.algo.center + 0.05 * torch.randn(512, dim, generator=g, device="cuda")
    pstate = wf.problem.init(seed)
    f_fused, _ = make_problem(True).evaluate(pstate, small)
    f_scan, _ = make_problem(False).evaluate(pstate, small)
    torch.cuda.synchronize()
    engines = compare("fused engine vs scan engine, pop 512", f_fused, f_scan,
                      rtol=1e-4, atol=1e-2)
    out = {
        "generations": gens,
        "pop": wf.algorithm.pop_size,
        "episodes": wf.problem.num_episodes,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "evals_per_s": gens * wf.algorithm.pop_size / wall,
        "mean_return_first": means[0],
        "mean_return_last": means[-1],
        "center_moved": moved,
        "engines": engines,
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        # the profiler slows the host; the idle share is taken against the
        # unprofiled wall time of a generation
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def profile_generations(torch, wf, state, gens: int) -> dict:
    """Device time by kernel over ``gens`` steady generations
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.run(state, gens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the time of its kernels
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    table = [{"kernel": k[:90], "device_us_per_gen": us / gens, "calls_per_gen": c / gens}
             for us, k, c in rows[:15]]
    for r in table:
        print(f"[profile] {json.dumps(r)}", flush=True)
    return {
        "generations": gens,
        "profiled_wall_us_per_gen": wall_us / gens,
        "device_busy_us_per_gen": busy_us / gens,
        "top": table,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None, help="also write the full results as JSON here")
    parser.add_argument("--profile", action="store_true", help="also profile 5 generations")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    if not (ROOT / "evox_tpu_torch" / "csrc" / "rollout.cu").exists():
        print(f"chip_smoke: no evox_tpu_torch checkout beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # OpenES's tell matmul in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import rollout as kr

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(built)} CUDA source(s) in {build_s:.2f} s: "
          + ", ".join(p.name for p in built.values()), flush=True)
    for name in built:
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    # 2. kernel against plain, on the main path's inputs and on stress inputs
    wf, make_problem = build_main_path(torch, SEED)
    kernels = phase_kernels(torch, kr, wf, SEED)

    # 3. main path
    main_path = phase_main_path(torch, kr, wf, make_problem, GENERATIONS, SEED, args.profile)
    print(f"[main path] {json.dumps(main_path)}", flush=True)
    if "jax" in sys.modules or any(
        k == "evox_tpu" or k.startswith("evox_tpu.") for k in sys.modules
    ):
        raise AssertionError("the port pulled in jax or the JAX package")

    pend = kernels["pendulum"]
    line = {
        "kernels": [
            {
                "name": "fused_rollout",
                "route": "cuda",
                "source": "evox_tpu_torch/csrc/rollout.cu",
                "replaces": "evox_tpu/kernels/rollout.py:468",
                "launches": main_path["launches"],
                "max_abs_err": pend["max_abs_err"],
                "ms": pend["ms"],
                "plain_ms": pend["plain_ms"],
                "bound_ms": pend["bound_ms"],
                "bound_by": pend["bound_by"],
                "library_ms": None,  # no single PyTorch call computes this
            }
        ]
    }
    result = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "kernels": kernels,
        "main_path": main_path,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(line), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
