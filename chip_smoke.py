#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``evox_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py [--out PATH] [--profile]

Phases (each raises on failure; nothing is caught so the run could still
exit 0):

1. device: the card's name and power limit (nvidia-smi); build every CUDA
   source of the port from the checkout (one nvcc per source, in parallel).
2. kernels against plain: ``fused_rollout`` against
   ``fused_rollout_plain`` — pendulum at pop 65536, 2 episodes, T 200 (the
   first main path's shape), wide-angle pendulum stress (th in ±1e3) at
   pop 65536, 1500 and an odd episode count, and cartpole (early exit) at
   pop 8192 and 1500 (ragged edge), T 500; every libdevice function the
   rollout kernel reaches in another form (``sincosf``, ``tanhf`` without
   its clamp) against the original over all 2^32 inputs;
   ``packed_dominance`` against
   ``packed_dominance_reference`` on the second main path's first merged
   fitness (n 20000, m 3) and on stress inputs (m 2, 3, 4, 5, 8, 16, 32
   against n 1, 31, 32, 33, 1000, 20001, with ties, duplicates, ±inf, NaN
   and ±0.0); ``partial_topk`` against
   ``partial_topk_reference`` on that path's cut key (n 20000, k 10000), at
   every shape of the top-k sweep (n 1000 to 2**24 + 1, k 1, 100, n/10,
   n/2, n; the value laws of ``topk_values``; one k at 2**24 + 1), on
   all-equal inputs, at n 1 to 100 and on both sides of each route's
   limit;
   ``fused_mlp_rollout`` against ``fused_mlp_rollout_plain`` on the third
   main path's first-generation inputs (pop 65536, MLP 244-64-64-17, T
   100) and on stress inputs (large
   weights, envs pushed to fall, explode, start done or run out of time; a
   ragged n of 1500 with 2 episodes; a low-rank ``linear=(0,)`` policy;
   the 7-mass walker; widths whose dot products split raggedly; a policy
   whose block is one warp). All bit
   for bit, NaN returns by bit pattern, and a non-finite return only where
   the env exploded. Times each kernel and its plain version with CUDA
   events, and ``torch.topk`` beside ``partial_topk`` (also at n 1e6, k
   n/2, with an empty launch's time as the floor). Records the block
   shape of the rollout, dominance and walker kernels (instance, threads,
   blocks an SM, planned and as the runtime reports it) and ptxas's
   registers and spills of each of their instances, and fails if any
   rollout, dominance or topk instance, or the walker's main one, spills,
   or if the main paths' instances fit fewer blocks an SM than their
   plans.
3. main path 1: ``StdWorkflow(OpenES(zeros(81), 65536),
   PolicyRolloutProblem(flat_mlp_policy 3-16-1, pendulum(200), 2 episodes,
   fused_env=pendulum_soa(200)), opt_direction="max")`` — init, one
   warm-up step, then ``run`` for 20 generations with every launch counter
   set to 0 just before and read just after. Checks one rollout launch per
   generation, finite fitness, a center that moved, and the fused engine
   against the scan engine on a small population.
4. main path 2: ``StdWorkflow(NSGA2(*LSMOP1(d=300, m=3).bounds(), n_objs=3,
   pop_size=10000, use_kernel=True), LSMOP1(d=300, m=3))`` — init step,
   one warm-up generation, then ``run`` for 20 generations, counters as
   above. Checks one ``packed_dominance`` and one ``partial_topk`` launch
   per generation, finite fitness, a population within bounds; one
   ``tell`` on the card against the same ``tell`` on the CPU's plain
   routes (survivors and ranks equal); ``partial_topk`` on that late
   generation's cut key against its plain version; the lexsort truncation
   against the
   partial-top-k one (same survivor set). Reports ms per generation, the
   fronts peeled per generation and a per-stage breakdown of a generation.
5. main path 3: ``StdWorkflow(OpenES(zeros(20945), 65536),
   PolicyRolloutProblem(mlp_policy 244-64-64-17, chain_walker(100), 1
   episode, fused_planes=chain_walker_planes(100)), opt_direction="max",
   pop_transforms=(TreeAndVector.batched_to_tree,),
   fit_transforms=(rank_based_fitness,))`` — init, one warm-up step, then
   ``run`` for 20 generations, counters as above. Checks one
   ``fused_mlp_rollout`` launch per generation and no other, fitness finite
   or non-finite only where the env exploded, a center that moved, and the
   fused engine against the scan engine on 512 genomes near the center at
   T 25. Reports ms per generation, evals/s and the mean episode length.
6. main path 4: ``StdWorkflow(CSO(lb=-32·1, ub=32·1, pop 4096, d 1024),
   Ackley())`` (``bench.py:134-185``, no monitor, as there) — init, the
   init step (everyone evaluated) and one warm-up generation, then ``run``
   for 20 generations, counters as above (no kernel runs). Checks the
   population within bounds and finite fitness; reports ms per generation,
   generations/s and evals/s (pop/2 a generation), and times the replay
   form of ``tell`` (the JAX package's) against the carried one in five
   rounds of turns, equal bit for bit. Then the same run with
   ``EvalMonitor(topk=8)`` from a fresh state: one ``partial_topk`` launch
   a generation, the best fitness falling, the last elite update equal to
   the plain route (indices, values, solutions), and ``partial_topk`` timed
   at the monitor's shapes (n 2048 + k, k 1 and 8) beside ``torch.topk``
   (CUDA events, device time, host time). One CSO generation on the card
   against the CPU on the same draws (positions and velocities bit for bit,
   fitness within 1e-5 relative). PSO, CLPSO, SLPSOGS, SLPSOUS, FIPS
   (ring), DMS-PSO-EL, FSPSO and SwmmPSO (with and without shortcuts) for
   10 generations each on Sphere (pop 1024, d 100) with an EvalMonitor.
   Between paths 2 and 3: the EvalMonitor Pareto archive (pf_capacity 1024)
   over two NSGA-II batches of 10000 on the card (``packed_dominance`` at n
   11024) against the CPU's plain route, rows, order and ``pf_count``
   equal.
7. main path 5: ``StdWorkflow(CMAES(full(1000, 3.0), init_stdev=1.0),
   Rastrigin())``, pop 24 and ``decomp_per_iter`` 8 at their defaults —
   init, one warm-up step and one untimed ``safe_eigh`` (cuSOLVER's first
   call sets it up), then ``run`` over 3 whole decomposition periods (24
   generations), counters as above (no kernel runs). Checks finite
   fitness, a finite and symmetric covariance, a mean that moved and one
   eigendecomposition a period; reports ms per generation, generations/s,
   one ``safe_eigh`` at d 1000 (CUDA events and the host's clock) and a
   split of a generation (ask, Rastrigin, tell, eigh). One CMA-ES
   generation on the card against the CPU (the same draws, fitness and
   (B, D); mean, C, ps, pc and sigma within 1e-4 relative), run on the card
   with TF32 allowed and not (equal bit for bit: its products are full
   float32 either way).
8. main path 6: main path 3 with ``PGPE(pop_size=65536,
   center_init=zeros(20945))`` (ClipUp) in OpenES's place, driven and
   checked as path 3 (one ``fused_mlp_rollout`` launch a generation and no
   other, a center that moved, fused against scan engine); the tell's one
   redraw of delta timed.
9. the rest of the ES family, 10 generations each on Sphere (pop 1024,
   ESMC 1025, d 100) with an EvalMonitor: SepCMAES, IPOPCMAES, MAES,
   LMMAES, RMES, XNES, SeparableNES, SNES, CR_FM_NES, ARS, ASEBO,
   GuidedES, PersistentES, NoiseReuseES, ESMC, DES, AMaLGaM and
   IndependentAMaLGaM, and LES with its bundled meta-trained parameters.
   ARS's tell launches ``partial_topk`` once a
   generation (n 512, k 51) beside the monitor's: its last tell equals a
   tell on the plain route, and B4 at that shape is timed beside
   ``torch.topk``. ``RestartCMAESDriver`` for 2 restarts (pop 17, then 34).
10. main path 7: ``StdWorkflow(MOEAD(zeros(12), ones(12), n_objs=3,
   pop_size=10000, aggregate_op="pbi"), DTLZ2(d=12, m=3))`` (9870
   subproblems, T 20, max_replace 4) — the constructor and its (9870, 20)
   neighbour table timed, the table built on the CPU too (equal element
   for element); init, the init step, one warm-up generation, then ``run``
   for 20 generations, counters as above (no kernel runs). Checks, after
   the run, finite fitness and a population within the bounds; reports ms
   a generation, generations/s, a split (ask, DTLZ2, tell), IGD against ``DTLZ2.pf()``
   and the exact hypervolume at (1.1, 1.1, 1.1); one tell on the card
   against the CPU (the same replacement decisions; population and fitness
   bit for bit where they agree, the deciding aggregation values printed
   where they do not).
11. main path 8: ``StdWorkflow(NSGA3(zeros(7), ones(7), n_objs=3,
   pop_size=10000), DTLZ1(d=7, m=3))`` (9870 reference points, merged n
   19740) — driven and reported as path 7, with one ``packed_dominance``
   launch a generation and the fronts peeled a generation; B3 at n 19740
   against its plain version; the split adds B3, the sort to the cut
   against the full peel, the normalisation and association, the
   closed-form niching and the sequential loop (once, equal); one
   selection on the card against the CPU (survivors and ranks equal).
12. the MO family: MOEADDRA, MOEADM2M, EAGMOEAD, RVEA, RVEAa, TDEA and
   LMOCSO, 10 generations each on DTLZ2(d=12, m=3) at pop 1000 requested
   (990 vectors; B3 once a generation in MOEADM2M's, TDEA's and EAGMOEAD's
   tells), ms a generation and IGD; DTLZ1-7 on the card against the CPU at
   pop 9870, and DTLZ7's ``pf()`` (one B3 launch) against the CPU's.
13. main path 9: ``StdWorkflow(SHADE(lb=-32·1, ub=32·1, pop 4096, d 1024,
   memory_size 100), Ackley())`` (``bench.py:134-185``'s Ackley workload
   at path 4's shape) — init, the init step and one warm-up generation,
   then ``run`` for 20 generations, counters as above: one
   ``partial_topk`` launch a generation (SHADE's pbest cut, n 4096, k 819)
   and no other. Checks the population within bounds, finite fitness and a
   best that did not rise, the cut on the card against a stable argsort,
   B4 at (4096, 819) against its plain version and beside ``torch.topk``;
   reports ms a generation, generations/s, evals/s (pop a generation) and
   a split (ask, Ackley, tell). One SHADE generation on the card against
   the CPU from that state, on the same draws and the same fitness handed
   to both tells (pbest rows, trials, population, fitness, archive, its
   size, the memory position, F, CR and the attribution bit for bit; M_F
   and M_CR within 1e-4 relative).
14. the DE family: DE (rand/1 and best/2), ODE, CoDE (3·pop evaluations a
   generation), SaDE, JaDE and SHADE, 10 generations each on Sphere (pop
   1024, d 100), launches counted (JaDE's and SHADE's pbest cut: one B4
   launch a generation), ms a generation and the best fitness; JaDE's cut
   (n 1024, k 51) against the plain route and beside ``torch.topk``. CEC
   2022 F1-F12 at d 2, 10 and 20 (F6-F8 at 10 and 20) on the card against
   the CPU at 1024 points each, and each member at its optimum.
15. main path 10: ``StdWorkflow(GDE3(*LSMOP1(d=300, m=3).bounds(),
   n_objs=3, pop_size=10000, F=0.5, CR=0.3), LSMOP1(d=300, m=3))`` (path
   2's shape) — driven and reported as path 7, with one
   ``packed_dominance`` launch a generation (n 20000 in ``non_dominate``);
   the split adds the pre-selection, B3, the sort to the cut and the whole
   ``non_dominate``; B3 at the merged fitness (``+inf`` rows included)
   against its plain version; one tell on the card against the CPU's plain
   routes, on a told fitness that pushes 100 parents and 100 trials to
   ``+inf`` (population and fitness, in order, bit for bit). Main path 11:
   ``StdWorkflow(IBEA(zeros(12), ones(12), n_objs=3, pop_size=10000,
   kappa=0.05), DTLZ2(d=12, m=3))`` — 6 timed generations, no kernel
   launch; the split adds the (20000, 20000) indicator terms and the
   10000-removal loop, with the launches a removal makes (profiler) and
   its host time; one selection's fast loop against the step-by-step loop
   on the card (survivors equal) and against the CPU (terms within 1e-5,
   survivors and removal order equal).
16. the indicator and knee family: IBEA, SRA, BCE-IBEA, SPEA2, HypE, KnEA
   and BiGE, 10 generations each on DTLZ2(d=12, m=3) at pop 1000, B3
   launches checked (HypE and KnEA 1 a generation, BiGE 3, BCE-IBEA 1 on
   even generations, the others 0), ms a generation, the split, each
   selection's sequential loop timed alone, IGD; MaF1-15 at m 3 and 5 on
   the card against the CPU at pop 10000, and MaF11's ``pf()`` (one B3
   launch each) against the CPU's.
17. a ``{"kernels": [...]}`` line (B1-B4 with their call sites), then the
   last line ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler breakdown of 5 generations of each main
path (of one decomposition period on path 5). Exits non-zero, with no
result line, when CUDA is unavailable or when the checkout is missing.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
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
# main path 2: bench.py:374-388's NSGA-II workload, at full width
NSGA2_POP = 10000
LSMOP_D, LSMOP_M = 300, 3
# main path 3: bench.py:286-338's walker workload at the north-star
# population (bench.py:329), at full width and full episode cap
WALKER_POP = 65536
WALKER_SIZES = (244, 64, 64, 17)
WALKER_T = 100
# main path 4: bench.py:134-185's CSO workload, at full width (bounds ±32)
CSO_POP, CSO_DIM, CSO_BOUND = 4096, 1024, 32.0
MONITOR_TOPK = 8  # the monitored run's EvalMonitor(topk=8)
CSO_AB_ROUNDS = 5  # rounds of the replay-against-carry turns
# the rest of the PSO family on Sphere, a few generations each
PSO_POP, PSO_DIM, PSO_GENERATIONS = 1024, 100, 10
ARCHIVE_CAP = 1024  # the EvalMonitor Pareto archive's pf_capacity
# main path 5: BASELINE.json's dense CMA-ES at its width, d 1000 (on
# Rastrigin: CEC'22 stops at d 20), default pop (24) and decomposition
# period; the timed run is the smallest whole number of periods >= 20
# generations
CMAES_DIM, CMAES_CENTER = 1000, 3.0
# the rest of the ES family on Sphere, a few generations each
ES_POP, ES_DIM, ES_GENERATIONS = 1024, 100, 10
RESTARTS, RESTART_GENERATIONS = 2, 50  # RestartCMAESDriver on Sphere, d 100
# main paths 7 and 8: BASELINE.json's "NSGA-II + MOEA/D on DTLZ/LSMOP" at
# path 2's pop (10000 requested: 9870 Das-Dennis vectors at m 3), on Deb
# et al.'s DTLZ widths for m 3 (k 10 for DTLZ2: d 12; k 5 for DTLZ1: d 7)
MO_POP, MO_M = 10000, 3
MO_SUBPROBLEMS = 9870  # UniformSampling(10000, 3): H 139
MOEAD_D, NSGA3_D = 12, 7
HV_REF = (1.1, 1.1, 1.1)  # the hypervolume's reference point
# the rest of the decomposition and reference-vector family on DTLZ2(d 12)
MO_FAMILY_POP, MO_GENERATIONS = 1000, 10
# main path 9: bench.py:134-185's Ackley workload and shape (path 4's), with
# SHADE at its default memory size; SHADE's pbest cut on B4 once a generation
SHADE_POP, SHADE_DIM, SHADE_BOUND, SHADE_MEMORY = 4096, 1024, 32.0, 100
# the DE family on Sphere, a few generations each
DE_POP, DE_DIM, DE_GENERATIONS = 1024, 100, 10
CEC_ROWS = 1024  # CEC 2022's points a member and dimension, card against CPU
# main path 10: BASELINE.json's "NSGA-II + MOEA/D on DTLZ/LSMOP" with its DE
# member, GDE3, at path 2's shape (LSMOP1, d 300, m 3, pop 10000) and the
# JAX package's defaults; GDE3_FORCED pairs of the tell checked against the
# CPU are pushed into each +inf branch
GDE3_F, GDE3_CR, GDE3_FORCED = 0.5, 0.3, 100
# main path 11: IBEA on path 7's DTLZ2 (d 12, m 3) at pop 10000, its default
# kappa; a generation is 10000 sequential removals (PERF.md §5 has its
# time), so fewer timed generations
IBEA_KAPPA, IBEA_GENERATIONS = 0.05, 6
MAF_POP = 10000  # MaF1-15's points a member, card against CPU
# fused_rollout's wide-angle pendulum cases: (n, episodes)
PENDULUM_STRESS = ((65536, 2), (1500, 2), (40000, 3))
# partial_topk's sweep: every n against k in {1, 100, n/10, n/2, n} and three
# value laws (topk_values); at 2**24 + 1, just above the JAX kernel's
# envelope, the plain version checks k = n/2 only
TOPK_NS = (1000, 20000, 100003, 1000000, 16777217)
TOPK_LAWS = ("distinct", "rounded", "cut")
TOPK_SPECIAL_BITS = (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFF00000, 0x7F800000,
                     0xFF800000, 0x00000000, 0x80000000)
# packed_dominance's stress cases: every objective count against every n
DOMINANCE_STRESS_M = (2, 3, 4, 5, 8, 16, 32)
DOMINANCE_STRESS_N = (1, 31, 32, 33, 1000, 20001)
# fused_mlp_rollout's stress cases: (name, sizes, n, episodes, T, weight
# scale, linear, walker configuration)
WALKER_STRESS = (
    ("full width", WALKER_SIZES, 8192, 1, WALKER_T, 3.0, (), {}),
    ("ragged n, 2 episodes", (244, 16, 8, 17), 1500, 2, WALKER_T, 3.0, (), {}),
    ("low-rank linear=(0,)", (244, 16, 64, 17), 4096, 1, WALKER_T, 1.0, (0,), {}),
    ("7-mass walker", (64, 16, 16, 4), 2000, 1, 40, 3.0, (), dict(n_masses=7, act_dim=4, obs_dim=64)),
    ("ragged split", (244, 37, 23, 17), 3000, 1, WALKER_T, 3.0, (), {}),
    # 32 threads: the generic instance's one-warp block (slices 4, 2, 1)
    ("one warp", (64, 8, 4, 4), 2000, 1, 40, 3.0, (), dict(n_masses=7, act_dim=4, obs_dim=64)),
)


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
        "elements": int(got.numel()),
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

    # wide angles: th in ±1e3 runs the floored modulo and the trig calls'
    # range reduction far from [-pi, pi]; a ragged n of 1500; an odd
    # episode count
    for sn, sep in PENDULUM_STRESS:
        theta, planes = stress_inputs(env, sn, sep, 0.5)
        g = torch.Generator(device=dev).manual_seed(seed + sn)
        planes["th"] = 2e3 * torch.rand(sep * sn, generator=g, device=dev) - 1e3
        args = (theta, planes, 200, 3, 16, 1, env, sep)
        got = kr.fused_rollout(*args, device=dev)
        want = kr.fused_rollout_plain(*args)
        torch.cuda.synchronize()
        results[f"pendulum_wide_th_{sn}_{sep}"] = compare(
            f"pendulum, stress inputs th in ±1e3 n={sn} ep={sep} T=200", got, want,
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
        stats = compare(f"cartpole n={n} ep=2 T=500", got, want, rtol=0.0, atol=0.0)
        if n == 8192:
            stats["ms"] = _time_ms(lambda: kr.fused_rollout(*args, device=dev), 3, 20)
            stats["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(*args), 1, 3)
            steps = int(want.sum().item())  # live env-steps this data needs
            nbytes, ops = rollout_work(n, 2, steps, 4, 16, 2, env_ops=36, trig=2)
            stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
            stats["mean_return"] = float(want.mean())
        results[f"cartpole_{n}"] = stats

    # every libdevice function the kernel replaces, against the original
    # over all 2^32 float32 bit patterns, bit for bit
    for name in kr.REPLACED_LIBDEVICE:
        res = kr.check_replaced_libdevice(name)
        print(f"[exhaustive] {name}: {json.dumps(res)}", flush=True)
        if res["mismatches"]:
            raise AssertionError(f"{name} differs from the libdevice original: {res}")
        results[f"exhaustive_{name}"] = res

    # the block of each env's instance; no instance spills
    ptxas = {}
    for fname, rep in ptxas_functions(_build_log("rollout")).items():
        found = re.search(r"rollout_kernelINS_\d+(Pendulum|CartPole)E", fname)
        ptxas[found.group(1).lower() if found else fname] = rep
    for env_name in ("pendulum", "cartpole"):
        check_no_spill(ptxas, f"rollout_kernel<{env_name}>", env_name)
    results["pendulum"]["block"] = rollout_block_shape(kr, "pendulum", pop.shape[0],
                                                       kw["episodes"], ptxas)
    results["cartpole_8192"]["block"] = rollout_block_shape(kr, "cartpole", 8192, 2, ptxas)
    return results


def _build_log(name: str) -> str:
    from evox_tpu_torch.kernels import _build

    return _build.build_log(name) or ""


def rollout_block_shape(kr, env_name: str, n: int, episodes: int, ptxas: dict) -> dict:
    """The rollout kernel's launch for an env at ``(n, episodes)``: the
    plan's threads, grid and blocks an SM, the runtime's blocks an SM and
    registers, and ptxas's registers and spills of the env's instance."""
    plan = kr.launch_plan(env_name, n, episodes, torch_sm_count())
    runtime = kr.kernel_occupancy(env_name)
    if runtime["blocks_per_sm"] < plan["blocks_per_sm"]:
        raise AssertionError(f"the rollout kernel for {env_name} fits fewer blocks an SM than "
                             f"its plan: {runtime} against {plan}")
    return {"instance": env_name, **{k: (list(v) if isinstance(v, tuple) else v)
                                     for k, v in plan.items()},
            "runtime_blocks_per_sm": runtime["blocks_per_sm"],
            "registers": runtime["registers"], "ptxas": ptxas.get(env_name)}


def phase_main_path(torch, kr, wf, make_problem, gens: int, seed: int, profile: bool) -> dict:
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    state = wf.step(state)  # warm-up: first-use library loads, cuBLAS handle
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()  # read just after
    want = {"fused_rollout": gens, "packed_dominance": 0, "partial_topk": 0,
            "fused_mlp_rollout": 0}
    if counts != want:
        raise AssertionError(f"launches in {gens} OpenES generations: {counts}, expected {want}")
    launches = counts["fused_rollout"]
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


# ----------------------------------------------------------- main path 2


def launch_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from evox_tpu_torch.kernels import dominance, rollout, rollout_mlp, topk

    return {"fused_rollout": rollout.fused_rollout, "packed_dominance": dominance.packed_dominance,
            "partial_topk": topk.partial_topk, "fused_mlp_rollout": rollout_mlp.fused_mlp_rollout}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def compare_exact(name: str, got, want) -> dict:
    """Tensors equal bit for bit (floats as their int32 bit patterns, so the
    sign of zero and NaN payloads count). ``max_abs_err`` is the largest
    difference of the compared integers (0 when equal)."""
    import torch

    stats = {"elements": 0, "mismatches": 0, "max_abs_err": 0.0}
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} != {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        g, w = g.cpu().to(torch.float64), w.cpu().to(torch.float64)
        stats["elements"] += g.numel()
        stats["mismatches"] += int((g != w).sum())
        if g.numel():
            stats["max_abs_err"] = max(stats["max_abs_err"], float((g - w).abs().max()))
    print(f"[compare] {name}: {json.dumps(stats)}", flush=True)
    if stats["mismatches"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {stats}")
    return stats


def build_nsga2_path(torch):
    """Main path 2 as a user builds it."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import LSMOP1

    class FrontRecorder(Monitor):
        """Each evaluation's finite flag and each generation's fronts peeled
        (the survivors' worst rank + 1: the peel stops at the cut front),
        kept as device tensors and read once, after the run."""

        def init(self, seed=None):
            return ((), ())

        def hooks(self):
            return ("post_eval", "post_step")

        def post_eval(self, mstate, cand, fitness):
            return (mstate[0] + (torch.isfinite(fitness).all(),), mstate[1])

        def post_step(self, mstate, wf_state):
            return (mstate[0], mstate[1] + (wf_state.algo.rank.max() + 1,))

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M)
    algo = NSGA2(*prob.bounds(), n_objs=LSMOP_M, pop_size=NSGA2_POP, use_kernel=True)
    return StdWorkflow(algo, prob, monitors=[FrontRecorder()])


def dominance_work(n: int, m: int) -> tuple:
    """(bytes, operations) of the packed dominance matrix: fitness read
    once, words and counts written once; per (row, column) pair 2m compares
    and m and/or steps, about 3m operations."""
    n_words = (n + 31) // 32
    return 4 * (n * m + n_words * n + n), 3 * m * n * n


def topk_work(n: int, k: int) -> tuple:
    """(bytes, operations) of selecting the k smallest: n floats read, k
    values and k indices written; one key per value (a radix select needs
    O(n) work)."""
    return 4 * n + 8 * k, n


def stress_fitness(torch, n: int, m: int, seed: int, dev):
    """Rounded uniform objectives (ties, zeros of both signs), duplicate
    rows, +inf, -inf and NaN rows and a NaN objective, as far as n and m
    have room for them."""
    g = torch.Generator().manual_seed(seed)
    fit = torch.round(torch.rand(n, m, generator=g) * 20) / 20
    # -0.0 must compare equal to +0.0: flip the sign of half the zeros
    flip = (fit == 0) & (torch.rand(n, m, generator=g) < 0.5)
    fit = torch.where(flip, -fit, fit)
    fit[n // 2] = fit[0]
    fit[n // 3] = fit[min(1, n - 1)]
    if n > 13:  # row 12: row 13 with its zeros negated
        fit[13, 0] = 0.0
        fit[12] = torch.where(fit[13] == 0, -fit[13], fit[13])
    for row, value in ((3, "inf"), (7, "nan")):
        if n > row:
            fit[row] = float(value)
    if n > 11:
        fit[11, m - 1] = float("nan")
    fit[n - 1, 0] = float("-inf")
    return fit.to(dev)


def topk_ks(n: int) -> list:
    return sorted({1, 100, n // 10, n // 2, n} - {0})


def topk_values(torch, law: str, n: int, seed: int, inf_share: float, n_ninf: int):
    """(n,) float32 values on the CPU, made from ``seed``, by value law:
    ``distinct`` (a permutation of the integers, shifted to hold both signs;
    exact in float32 up to 2**24 + 1), ``rounded`` (normals rounded to
    quarters, heavy ties, with NaNs of both signs and payloads, ±inf and
    ±0.0), ``cut`` (NSGA-II's cut key: -crowding on a front of n * (1 -
    inf_share) rows, n_ninf of them -inf, +inf elsewhere)."""
    import numpy as np

    g = torch.Generator().manual_seed(seed)
    if law == "distinct":
        return torch.randperm(n, generator=g).to(torch.float32) - float(n // 2)
    if law == "rounded":
        v = torch.round(torch.randn(n, generator=g) * 4) / 4
        special = torch.from_numpy(np.array(TOPK_SPECIAL_BITS, np.uint32).view(np.int32).copy())
        hit = torch.randint(0, n, (min(n, max(64, n // 1000)),), generator=g)
        v[hit] = special.view(torch.float32).repeat(len(hit) // len(TOPK_SPECIAL_BITS) + 1)[: len(hit)]
        return v
    if law == "cut":
        front = max(1, min(n, round(n * (1.0 - inf_share))))
        v = torch.full((n,), float("inf"))
        rows = torch.randperm(n, generator=g)[:front]
        crowd = torch.rand(front, generator=g) * 2.0
        crowd[: min(n_ninf, front)] = float("inf")  # the front's boundary rows
        v[rows] = -crowd
        return v
    raise ValueError(law)


def topk_stress(torch, kt, dev, seed: int, inf_share: float, n_ninf: int) -> dict:
    """partial_topk against partial_topk_reference, bit for bit: every shape
    and value law of the sweep (one k at 2**24 + 1), all-equal inputs, n of
    a warp or less, and n and k on both sides of each route's limit."""
    results = {}

    def check(label, v, k):
        results[f"partial_topk_{label}"] = compare_exact(
            f"partial_topk, {label}", kt.partial_topk(v, k, device=dev),
            kt.partial_topk_reference(v, k))

    for n in TOPK_NS:
        for law in TOPK_LAWS:
            v = topk_values(torch, law, n, seed + n, inf_share, n_ninf).to(dev)
            for k in topk_ks(n) if n < 2**24 else [n // 2]:
                check(f"sweep {law} n={n} k={k} ({kt.launch_plan(n, k)['route']})", v, k)
            del v
    # all-equal inputs: +inf, one NaN payload, -0.0, on both routes
    for name, bits in (("+inf", 0x7F800000), ("nan 0xffc00123", 0xFFC00123), ("-0.0", 0x80000000)):
        for n in (20000, 100003):
            v = torch.full((n,), bits - 2**32 if bits >= 2**31 else bits, dtype=torch.int32,
                           device=dev).view(torch.float32)
            for k in (1, n // 2, n):
                check(f"all equal {name} n={n} k={k}", v, k)
    # small populations: a warp or less, a ragged warp
    for n in (1, 2, 31, 33, 100):
        for law in ("distinct", "rounded"):
            v = topk_values(torch, law, n, seed + n, inf_share, n_ninf).to(dev)
            for k in sorted({1, max(1, n // 2), n}):
                check(f"small n {law} n={n} k={k}", v, k)
    # each route's limit, from both sides (launch_plan's rules)
    w = kt.SMALL_WORDS
    for n, k in ((w - 2, 1), (w - 1, 1), (w // 4, w // 4), (w // 4 + 1, w // 4 + 1),
                 (w // 2, w // 4), (w // 2 + 1, w // 4), (100003, w // 4), (100003, w // 4 + 1),
                 (kt.SMALL_N, kt.SMALL_N // 2), (kt.SMALL_N + 1, kt.SMALL_N // 2)):
        for law in ("distinct", "rounded"):
            v = topk_values(torch, law, n, seed + n + k, inf_share, n_ninf).to(dev)
            plan = kt.launch_plan(n, k)
            check(f"limit {law} n={n} k={k} ({plan['route']}, {plan['sort']}, "
                  f"scratch {plan['scratch_words']})", v, k)
    return results


def dominance_block_shape(kd, n: int, m: int) -> dict:
    """The dominance kernel's launch at ``(n, m)``: the plan's instance,
    threads, super-tile, grid, shared memory and blocks an SM, the
    runtime's blocks an SM and registers for that instance, and ptxas's
    registers and spills of every instance (keyed by m, 0 the generic)."""
    from evox_tpu_torch.kernels import _build

    plan = kd.launch_plan(n, m)
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("dominance") or "").items():
        found = re.search(r"dominance_kernelILi(\d+)E", name)
        ptxas[int(found.group(1)) if found else name] = rep
    runtime = kd.kernel_occupancy(plan, m)
    if runtime["blocks_per_sm"] < plan["blocks_per_sm"]:
        raise AssertionError(f"the dominance kernel fits fewer blocks an SM than its plan: "
                             f"{runtime} against {plan}")
    return {"instance": plan["instance"], "threads": plan["threads"],
            "tile_words": plan["tile_words"], "grid": list(plan["grid"]),
            "working_blocks": plan["working_blocks"], "smem_bytes": plan["smem_bytes"],
            "planned_blocks_per_sm": plan["blocks_per_sm"],
            "runtime_blocks_per_sm": runtime["blocks_per_sm"],
            "registers": runtime["registers"], "ptxas": ptxas}


def check_no_spill(ptxas: dict, label: str, key) -> None:
    """Fail unless ptxas reported the function under ``key`` without
    spills."""
    rep = ptxas.get(key)
    if rep is None or rep.get("spill_stores", 1) or rep.get("spill_loads", 1):
        raise AssertionError(f"{label}: ptxas reports spills or no report ({key}: {rep})")


def torch_sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_nsga2_kernels(torch, wf, seed: int) -> dict:
    """Hold packed_dominance and partial_topk against their plain versions
    on the card, on the main path's inputs and on stress inputs."""
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import crowding_distance, non_dominated_sort

    # the main path's first merged fitness: parents after the init step,
    # then the first generation's offspring
    state = wf.step(wf.init(seed))
    off, astate = wf.algorithm.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n, m = merged.shape
    k = wf.algorithm.pop_size
    dev = merged.device
    results = {}

    got = kd.packed_dominance(merged, device=dev)
    want = kd.packed_dominance_reference(merged)
    torch.cuda.synchronize()
    stats = compare_exact(f"packed_dominance, main-path merged fitness n={n} m={m}", got, want)
    stats["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=dev), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    nbytes, ops = dominance_work(n, m)
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    results["packed_dominance"] = stats
    stats["block"] = dominance_block_shape(kd, n, m)
    # every instance (exact m = 2, 3, 4; generic 5 to 32) at ragged and
    # whole words (1, 31, 32, 33), a few column blocks (1000) and the plain
    # version's chunked build (20001), with duplicates, ±inf, NaN and ±0.0
    for sm in DOMINANCE_STRESS_M:
        for sn in DOMINANCE_STRESS_N:
            fit_s = stress_fitness(torch, sn, sm, seed + sn + sm, dev)
            results[f"packed_dominance_stress_{sn}_{sm}"] = compare_exact(
                f"packed_dominance, stress n={sn} m={sm}",
                kd.packed_dominance(fit_s, device=dev), kd.packed_dominance_reference(fit_s))
            del fit_s
    for sm in DOMINANCE_STRESS_M:  # no instance spills
        check_no_spill(stats["block"]["ptxas"], f"dominance_kernel, m={sm}",
                       kd.launch_plan(1000, sm)["instance"])

    # the main path's cut key: -crowding on the cut front, +inf elsewhere
    rank, cut = non_dominated_sort(merged, until=k, return_cut_rank=True)
    crowd = crowding_distance(merged, mask=rank == cut)
    cut_key = torch.where(rank == cut, -crowd, float("inf"))
    got = kt.partial_topk(cut_key, k, device=dev)
    want = kt.partial_topk_reference(cut_key, k)
    torch.cuda.synchronize()
    stats = compare_exact(f"partial_topk, main-path cut key n={n} k={k}", got, want)
    stats["ms"] = _time_ms(lambda: kt.partial_topk(cut_key, k, device=dev), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kt.partial_topk_reference(cut_key, k), 3, 20)
    # the library call: torch.topk's tie order is unspecified, so it computes
    # the same set of values but not necessarily the same indices
    stats["library_ms"] = _time_ms(lambda: torch.topk(cut_key, k, largest=False), 3, 20)
    nbytes, ops = topk_work(n, k)
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    stats["cut_front"] = int((rank == cut).sum())
    plan = kt.launch_plan(n, k)
    stats["block"] = {key: plan[key] for key in ("route", "sort", "threads", "launches", "smem_bytes",
                                                 "scratch_words")}
    from evox_tpu_torch.kernels import _build

    # ptxas's registers and spills of every topk kernel; none may spill
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("topk") or "").items():
        found = re.search(r"\d+((?:small|block_sort|select|compact_count|compact_scatter|sort_count|"
                          r"sort_scan|sort_scatter|emit|empty)_kernel|block_sort_pass)(?:ILi(\d+)E)?",
                          name)
        ptxas[f"{found.group(1)}<{found.group(2)}>" if found and found.group(2) else
              found.group(1) if found else name] = rep
    for key in ptxas:
        check_no_spill(ptxas, f"topk {key}", key)
    stats["block"]["ptxas"] = ptxas
    # the card's floor under any call that launches: one empty kernel
    stats["empty_launch_ms"] = _time_ms(lambda: kt.empty_launch(100, dev), 2, 5) / 100
    # and at n 1e6, k n/2 (distinct values), beside the library call
    inf_share = 1.0 - stats["cut_front"] / n
    n_ninf = int((cut_key == float("-inf")).sum())
    big = topk_values(torch, "distinct", 10**6, seed, inf_share, n_ninf).to(dev)
    stats["ms_1e6"] = _time_ms(lambda: kt.partial_topk(big, 10**6 // 2, device=dev), 2, 10)
    stats["library_ms_1e6"] = _time_ms(lambda: torch.topk(big, 10**6 // 2, largest=False), 2, 10)
    del big
    results["partial_topk"] = stats
    results.update(topk_stress(torch, kt, dev, seed, inf_share, n_ninf))
    return results


def nsga2_breakdown(torch, wf, state, reps: int = 5) -> dict:
    """Median host-clock ms of each stage of one generation, each stage
    synchronised on both sides: ask (mating and variation), LSMOP1, the
    whole tell, and inside the tell packed_dominance, the sort (the kernel
    and the peel loop), and partial_topk on the cut key."""
    import statistics

    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import crowding_distance, non_dominated_sort

    algo, prob = wf.algorithm, wf.problem
    k = algo.pop_size
    times = {name: [] for name in ("ask", "evaluate", "tell", "packed_dominance", "sort",
                                   "partial_topk")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        off, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, off))
        timed("tell", lambda: algo.tell(astate, fit))
        merged = torch.cat([astate.fitness, fit])
        timed("packed_dominance", lambda: kd.packed_dominance(merged, device=merged.device))
        rank, cut = timed("sort", lambda: non_dominated_sort(merged, until=k, return_cut_rank=True))
        crowd = crowding_distance(merged, mask=rank == cut)
        cut_key = torch.where(rank == cut, -crowd, float("inf"))
        timed("partial_topk", lambda: kt.partial_topk(cut_key, k, device=merged.device))
    out = {name: statistics.median(v) for name, v in times.items()}
    out["peel"] = out["sort"] - out["packed_dominance"]
    out["tell_rest"] = out["tell"] - out["sort"] - out["partial_topk"]
    return out


def phase_nsga2_path(torch, wf, gens: int, seed: int, profile: bool) -> dict:
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import (crowding_distance, non_dominated_sort,
                                                    rank_crowding_truncate)

    algo = wf.algorithm
    state = wf.step(wf.init(seed))  # init step: evaluate the parents, sort them
    state = wf.step(state)  # warm-up generation
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": gens, "partial_topk": gens,
            "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} NSGA-II generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    flags, fronts = state.monitors[0]
    if not all(bool(f) for f in flags):
        raise AssertionError("non-finite fitness on the NSGA-II path")
    fronts = [int(f) for f in fronts[-gens:]]  # the timed generations
    pop = state.algo.population
    if not (torch.isfinite(state.algo.fitness).all() and (pop >= algo.lb).all()
            and (pop <= algo.ub).all()):
        raise AssertionError("the final population leaves the bounds or its fitness is not finite")

    # one tell on the card against the same tell on the CPU's plain routes
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    on_card = algo.tell(astate, fit)
    cpu_algo = NSGA2(algo.lb.cpu(), algo.ub.cpu(), n_objs=algo.n_objs, pop_size=algo.pop_size,
                     use_kernel=True, device="cpu")
    cpu_state = astate.replace(**{f: getattr(astate, f).cpu() for f in
                                  ("population", "fitness", "offspring", "rank", "crowd")})
    t_cpu = time.perf_counter()
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    cpu_tell_s = time.perf_counter() - t_cpu
    tell_stats = compare_exact(
        "NSGA-II tell on the card against the CPU's plain routes (population, fitness, rank)",
        [on_card.population.cpu(), on_card.fitness.cpu(), on_card.rank.cpu()],
        [on_cpu.population, on_cpu.fitness, on_cpu.rank])
    crowd_card, crowd_cpu = on_card.crowd.cpu(), on_cpu.crowd
    finite = torch.isfinite(crowd_cpu)
    if not torch.equal(torch.isfinite(crowd_card), finite) or not torch.equal(
            crowd_card[~finite], crowd_cpu[~finite]):
        raise AssertionError("NSGA-II tell: the infinite crowding distances differ")
    # the same float32 operations on both devices; the tolerance allows an
    # ulp of the division, which no run has shown
    tell_stats["crowd"] = compare("NSGA-II tell crowd (finite entries), card against CPU",
                                  crowd_card[finite], crowd_cpu[finite], rtol=1e-6, atol=0.0)
    tell_stats["cpu_tell_s"] = cpu_tell_s

    # partial_topk on this late generation's cut key (the first
    # generation's is checked in phase_nsga2_kernels)
    merged = torch.cat([astate.fitness, fit])
    rank, cut = non_dominated_sort(merged, until=algo.pop_size, return_cut_rank=True)
    crowd = crowding_distance(merged, mask=rank == cut)
    cut_key = torch.where(rank == cut, -crowd, float("inf"))
    late_topk = compare_exact(
        f"partial_topk, cut key after {state.generation} generations n={merged.shape[0]} "
        f"k={algo.pop_size}", kt.partial_topk(cut_key, algo.pop_size, device=cut_key.device),
        kt.partial_topk_reference(cut_key, algo.pop_size))
    late_topk["cut_front"] = int((rank == cut).sum())

    # the lexsort truncation against the partial-top-k one, same input
    o_lex, r_lex = rank_crowding_truncate(merged, algo.pop_size, use_kernel=False)
    o_top, r_top = rank_crowding_truncate(merged, algo.pop_size, use_kernel=True)
    lex = dict(zip(o_lex.tolist(), r_lex.tolist()))
    top = dict(zip(o_top.tolist(), r_top.tolist()))
    if lex != top or len(top) != algo.pop_size:
        raise AssertionError("lexsort and partial-top-k truncation keep different survivors")
    print(f"[compare] truncation, lexsort against partial-top-k: {len(top)} survivors, "
          "same set and ranks", flush=True)

    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "fronts_peeled": fronts,
        "tell_vs_cpu": tell_stats,
        "late_cut_key_topk": late_topk,
        "breakdown_ms": nsga2_breakdown(torch, wf, state),
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


# ----------------------------------------------------------- main path 3


def build_walker_path(torch, pop: int = WALKER_POP, T: int = WALKER_T, device=None,
                      algorithm=None):
    """Main path 3 as a user builds it: ``(workflow, make_problem, adapter)``.
    ``algorithm(dim, pop, device)`` builds the algorithm in OpenES's place
    (main path 6: PGPE); ``pop``, ``T`` and ``device`` exist for a rehearsal
    on the CPU at a small size; the chip run takes the defaults."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.kernels import rollout_mlp as km
    from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, mlp_policy
    from evox_tpu_torch.utils import TreeAndVector, rank_based_fitness

    penv = km.chain_walker_planes(max_steps=T)
    init_params, apply = mlp_policy(WALKER_SIZES)
    adapter = TreeAndVector(init_params(SEED, device=device))

    def make_problem(fused, max_episode_length=None):
        return PolicyRolloutProblem(
            apply, penv.base, num_episodes=1, stochastic_reset=False,
            max_episode_length=max_episode_length, fused_planes=penv if fused else None,
            device=device,
        )

    class FitnessRecorder(Monitor):
        """Each generation's raw fitness, kept on the card: no work and no
        host read inside a run. With ``keep_nonfinite`` set (a replay after
        the timed run), also the candidates whose fitness is not finite, for
        the explosion check; finding them reads one count a generation."""

        keep_nonfinite = False

        def init(self, seed=None):
            return ()

        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            kept = None
            if self.keep_nonfinite:
                bad = (~torch.isfinite(fitness)).nonzero()[:, 0]
                if bad.numel():
                    kept = ([{k: v[bad].clone() for k, v in layer.items()} for layer in cand],
                            fitness[bad].clone())
            return mstate + ((fitness, kept),)

    if algorithm is None:
        algo = OpenES(torch.zeros(adapter.dim), pop, learning_rate=0.05, noise_stdev=0.05,
                      device=device)
    else:
        algo = algorithm(adapter.dim, pop, device)
    wf = StdWorkflow(algo, make_problem(True), monitors=[FitnessRecorder()],
                     opt_direction="max", pop_transforms=(adapter.batched_to_tree,),
                     fit_transforms=(rank_based_fitness,), device=device)
    return wf, make_problem, adapter


def mlp_rollout_work(sizes, n: int, episodes: int, steps: int, n_masses: int, act_dim: int,
                     substeps: int) -> tuple:
    """(bytes, operations) that a fused walker rollout must move and do.

    Bytes: each individual's weights and biases read once, the state planes
    read once, the returns written once. Operations per live env-step,
    counted from csrc/rollout_mlp.cu: 2 per multiply-add of the MLP, one
    per tanh, ~32 per mass for the observation, ~60 per mass for each
    substep's forces and integration, and the reward's sums; a
    transcendental counts as one operation, so this is a lower bound.
    ``steps`` is the live env-steps this run's data needs."""
    policy = sum(fi * fo + fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    macs = sum(fi * fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    nbytes = 4 * (n * policy + (4 * n_masses + act_dim + 2) * episodes * n + episodes * n)
    per_step = (2 * macs + sum(sizes[1:-1]) + 3 * act_dim + 32 * n_masses
                + 60 * n_masses * substeps + n_masses + 6)
    return nbytes, per_step * steps


def ptxas_functions(log: str) -> dict:
    """ptxas's report per kernel function in an nvcc log: registers a
    thread and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def walker_block_shape(km, sizes, linear=()) -> dict:
    """The walker kernel's block shape at ``sizes``: the plan's instance,
    threads, registers and blocks an SM, the blocks an SM the runtime
    reports for that instance, and ptxas's registers and spills of both
    instances."""
    import ctypes

    from evox_tpu_torch.kernels import _build

    plan = km.fused_rollout_analysis(sizes, linear=linear)
    fn = _build.function("rollout_mlp", "evox_mlp_rollout_blocks_per_sm", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    _build.check_launch("rollout_mlp", fn(int(plan["instance"] == "main"),
                                          plan["threads_per_block"],
                                          plan["smem_bytes_per_block"], ctypes.byref(blocks)),
                        "occupancy query")
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("rollout_mlp") or "").items():
        # mlp_rollout_kernel<true> (the main instance) mangles to ...ILb1E...
        ptxas["main" if "ILb1E" in name else "generic" if "ILb0E" in name else name] = rep
    return {"instance": plan["instance"], "threads": plan["threads_per_block"],
            "slices": plan["slices"], "smem_bytes": plan["smem_bytes_per_block"],
            "planned_registers": plan["registers_per_thread"],
            "planned_blocks_per_sm": plan["blocks_per_sm"],
            "runtime_blocks_per_sm": blocks.value, "ptxas": ptxas}


def check_exploded(torch, name: str, totals, exploded) -> int:
    """A non-finite return is allowed only where the env exploded (its state
    went non-finite or beyond the bound); returns how many there were."""
    bad = ~torch.isfinite(totals)
    if bool((bad & ~exploded).any()):
        raise AssertionError(f"{name}: non-finite returns from envs that did not explode")
    return int(bad.sum())


def walker_stress_inputs(torch, km, sizes, n: int, episodes: int, T: int, w_scale: float,
                         seed: int, dev, **walker):
    """Large random weights given through strided views, and resets pushed
    to every end of an episode: every 7th env with two masses on one spot
    (the torque term hits its 1e6 cap and the chain explodes), every 11th
    with a NaN velocity, every 13th fallen, every 17th done from the start,
    every 19th two steps from the time limit, every 23rd moved beyond the
    1e3 bound."""
    penv = km.chain_walker_planes(max_steps=T, **walker)
    g = torch.Generator(device=dev).manual_seed(seed)
    weights = tuple((w_scale * torch.randn(n, fi, fo, generator=g, device=dev)).permute(1, 2, 0)
                    for fi, fo in zip(sizes[:-1], sizes[1:]))
    biases = tuple((0.1 * torch.randn(n, fo, generator=g, device=dev)).T for fo in sizes[1:])
    states = penv.base.reset(g, episodes * n, dev)
    planes = penv.to_planes(states)
    idx = torch.arange(episodes * n, device=dev)
    for k, col in (("px", 4), ("py", 4)):
        planes[k][col] = torch.where(idx % 7 == 0, planes[k][col - 1], planes[k][col])
    planes["vx"][2] = torch.where(idx % 11 == 0, float("nan"), planes["vx"][2])
    planes["py"] = torch.where(idx % 13 == 0, 0.3 * planes["py"], planes["py"])
    planes["done"] = (idx % 17 == 0).float()[None]
    planes["t"] = torch.where(idx % 19 == 0, float(T - 2), planes["t"][0])[None]
    planes["px"] = torch.where(idx % 23 == 0, planes["px"] + 2e3, planes["px"])
    return dict(weights=weights, biases=biases, init_state=planes, T=T, sizes=sizes, env=penv,
                episodes=episodes)


def phase_walker_kernels(torch, wf, adapter, seed: int) -> dict:
    """Hold fused_mlp_rollout against fused_mlp_rollout_plain on the card,
    on the main path's first-generation inputs and on stress inputs."""
    from evox_tpu_torch.kernels import rollout_mlp as km

    dev = wf.device
    results = {}
    state = wf.init(seed)
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
    plain_kw = {k: v for k, v in kw.items() if k != "device"}
    got = km.fused_mlp_rollout(**kw)
    torch.cuda.synchronize()
    want, steps, exploded = km.fused_mlp_rollout_plain(**plain_kw, stats=True)
    torch.cuda.synchronize()
    n, ep, T = pop.shape[0], kw["episodes"], kw["T"]
    # bit for bit: the kernel does the plain version's operations in its
    # fixed order, each rounded on its own (no FMA contraction)
    stats = compare_exact(f"fused_mlp_rollout, main-path inputs n={n} ep={ep} T={T}", [got], [want])
    stats["nonfinite"] = check_exploded(torch, "main-path inputs", got, exploded)
    stats["ms"] = _time_ms(lambda: km.fused_mlp_rollout(**kw), 2, 10)
    # T = 0: the launch, the policy copies and the state loads alone; the
    # rest of "ms" is the episodes' steps
    stats["copy_only_ms"] = _time_ms(lambda: km.fused_mlp_rollout(**dict(kw, T=0)), 2, 10)
    stats["plain_ms"] = _time_ms(lambda: km.fused_mlp_rollout_plain(**plain_kw), 1, 2)
    live = int(steps.sum())  # the env-steps this data needs
    cfg = kw["env"].config
    nbytes, ops = mlp_rollout_work(kw["sizes"], n, ep, live, cfg["n_masses"], cfg["act_dim"],
                                   cfg["substeps"])
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats.update(bytes=nbytes, ops=ops, live_steps=live, mean_episode_length=live / (n * ep),
                 exploded=int(exploded.sum()), mean_return=float(want.mean()),
                 block=walker_block_shape(km, kw["sizes"], kw["linear"]))
    print(f"[walker kernel] {json.dumps(stats)}", flush=True)
    del got, want, kw, plain_kw, pop
    results["walker"] = stats

    for i, (name, sizes, sn, sep, sT, scale, linear, walker) in enumerate(WALKER_STRESS):
        skw = walker_stress_inputs(torch, km, sizes, sn, sep, sT, scale, seed + i, dev, **walker)
        got = km.fused_mlp_rollout(**skw, linear=linear, device=dev)
        torch.cuda.synchronize()
        want, steps, exploded = km.fused_mlp_rollout_plain(**skw, linear=linear, stats=True)
        torch.cuda.synchronize()
        label = f"fused_mlp_rollout, stress: {name}, sizes {sizes} n={sn} ep={sep} T={sT}"
        st = compare_exact(label, [got], [want])
        st.update(nonfinite=check_exploded(torch, label, got, exploded),
                  exploded=int(exploded.sum()), mean_episode_length=float(steps.float().mean()))
        if not st["exploded"] or not (steps < sT).any():
            raise AssertionError(f"{label}: the stress inputs ended no episode early")
        results[f"walker_stress_{i}"] = st

    # the main path's instance keeps its plan: no spill, its registers, its
    # blocks an SM (a fall to two undoes the register-held layer)
    block = stats["block"]
    main = block["ptxas"].get("main", {})
    if (block["instance"] != "main" or main.get("spill_stores", 1) or main.get("spill_loads", 1)
            or main.get("registers", 999) > block["planned_registers"]
            or block["runtime_blocks_per_sm"] != block["planned_blocks_per_sm"]):
        raise AssertionError(f"the walker kernel's main instance misses its plan: {block}")
    return results


def phase_walker_path(torch, wf, make_problem, adapter, gens: int, seed: int,
                      profile: bool) -> dict:
    from evox_tpu_torch.kernels import rollout_mlp as km

    on_card = wf.device.type == "cuda"  # False only in a rehearsal on the CPU
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    state = wf.step(state)  # warm-up
    before = state  # states are not changed in place: a replay starts here
    torch.cuda.synchronize()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0,
            "fused_mlp_rollout": gens}
    if launches != want:
        raise AssertionError(f"launches in {gens} walker generations: {launches}, expected {want}")
    if state.generation != gens + 1:
        raise AssertionError(f"generation {state.generation} != {gens + 1}")
    fitness = torch.stack([f for f, _ in state.monitors[0][-gens:]])  # (gens, pop)
    finite = torch.isfinite(fitness)
    means = (torch.where(finite, fitness, 0.0).sum(1) / finite.sum(1).clamp_min(1)).tolist()
    if not finite.any(1).all():
        raise AssertionError("no finite fitness in a generation of the walker path")
    nonfinite = int((~finite).sum())
    if nonfinite:
        # non-finite fitness only where the env exploded: replay the timed
        # generations, untimed, keeping the candidates at fault
        wf.monitors[0].keep_nonfinite = True
        replay = wf.run(before, gens)
        wf.monitors[0].keep_nonfinite = False
        records = replay.monitors[0][-gens:]
        compare_exact("walker main path, replayed fitness", [f for f, _ in records],
                      list(fitness))
        for _, kept in records:
            if kept is not None:
                tree, fit = kept
                kw = wf.problem.fused_planes_inputs(replay.prob, tree)
                kw.pop("device")
                _, _, exploded = km.fused_mlp_rollout_plain(**kw, stats=True)
                check_exploded(torch, "walker main path", fit, exploded)
    moved = float((state.algo.center - center0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the center did not move (|delta| = {moved})")

    # the episode lengths of the last population, from the plain version
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
    kw.pop("device")
    _, steps, _ = km.fused_mlp_rollout_plain(**kw, stats=True)
    del pop, kw

    # the repo's own means: fused engine == scan engine on the same resets,
    # up to float rounding (the scan engine's matmuls sum in another order);
    # JAX's own tolerance (tests/test_kernels_mlp.py:158-160)
    dev = wf.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    small = state.algo.center + 0.05 * torch.randn(512, adapter.dim, generator=g, device=dev)
    tree = adapter.batched_to_tree(small)
    pstate = wf.problem.init(seed)
    f_fused, _ = make_problem(True, 25).evaluate(pstate, tree)
    f_scan, _ = make_problem(False, 25).evaluate(pstate, tree)
    torch.cuda.synchronize()
    engines = compare("walker fused engine vs scan engine, pop 512, T 25", f_fused, f_scan,
                      rtol=2e-3, atol=2e-3)
    pop_size = wf.algorithm.pop_size
    out = {
        "generations": gens,
        "pop": pop_size,
        "episodes": wf.problem.num_episodes,
        "T": wf.problem.max_len,
        "launches": launches["fused_mlp_rollout"],
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "evals_per_s": gens * pop_size / wall,
        "mean_fitness_first": means[0],
        "mean_fitness_last": means[-1],
        "nonfinite_fitness": nonfinite,
        "mean_episode_length_last": float(steps.float().mean()),
        "peak_memory_gb": peak_gb,  # of the timed generations (the state included)
        "center_moved": moved,
        "engines": engines,
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


# ----------------------------------------------------------- main path 4


def build_cso_path(torch, pop: int = CSO_POP, dim: int = CSO_DIM, monitor: bool = False,
                   algo_cls=None, device=None):
    """Main path 4 as a user builds it (``bench.py:134-185``): ``(workflow,
    monitor or None)``. ``algo_cls`` swaps in a CSO variant (the replay
    form); ``pop``, ``dim`` and ``device`` exist for a rehearsal on the CPU
    at a small size."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.pso import CSO
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Ackley

    cls = algo_cls or CSO
    bound = torch.full((dim,), CSO_BOUND)
    algo = cls(lb=-bound, ub=bound, pop_size=pop, device=device)
    mon = EvalMonitor(topk=MONITOR_TOPK, device=device) if monitor else None
    wf = StdWorkflow(algo, Ackley(), monitors=[mon] if monitor else [], device=device)
    return wf, mon


def replay_cso_class():
    """CSO whose ``tell`` replays ``ask``'s pass from the generation seed,
    the JAX package's design (``evox_tpu/algorithms/so/pso/cso.py:142-159``),
    in place of taking the pass that ``ask`` kept: timed beside the port's
    form, with the same numbers."""
    from evox_tpu_torch.algorithms.so.pso import CSO

    class ReplayCSO(CSO):
        def ask(self, state):
            cand, state = super().ask(state)
            return cand, state.replace(pending=None)

        def tell(self, state, fitness):
            done = self._pair_pass(state, *self._draw(state.pair_seed))
            return super().tell(state.replace(pending=done), fitness)

    return ReplayCSO


def _check_swarm(torch, name: str, algo, population) -> None:
    if not (torch.isfinite(population).all() and (population >= algo.lb).all()
            and (population <= algo.ub).all()):
        raise AssertionError(f"{name}: the population leaves the bounds or is not finite")


def phase_cso_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 4: CSO on Ackley at pop 4096, d 1024, no monitor (as
    bench.py), then the replay form against the carried one in turns."""
    wf, _ = build_cso_path(torch)
    algo = wf.algorithm
    # the init step (everyone evaluated, no pair pass), then one warm-up
    # generation: the first pair pass allocates its buffers
    state = wf.step(wf.step(wf.init(seed)))
    warm = state
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} CSO generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    _check_swarm(torch, "CSO path", algo, state.algo.population)
    if not torch.isfinite(state.algo.fitness).all():
        raise AssertionError("non-finite fitness on the CSO path")

    # the replay form against the carried one: CSO_AB_ROUNDS rounds of turns
    # carry, replay, replay, carry from the same state (the host's time
    # swings between runs); the same draws give the same numbers
    replay_wf, _ = build_cso_path(torch, algo_cls=replay_cso_class())
    turns, finals = [], {}
    order = (("carry", wf), ("replay", replay_wf), ("replay", replay_wf), ("carry", wf))
    for name, w in order * CSO_AB_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = w.run(warm, gens)
        torch.cuda.synchronize()
        turns.append({"form": name, "ms_per_generation": (time.perf_counter() - t0) / gens * 1e3})
        finals[name] = end.algo
    compare_exact("CSO replay form against the carried form, after 20 generations",
                  [finals["replay"].population, finals["replay"].velocity, finals["replay"].fitness],
                  [finals["carry"].population, finals["carry"].velocity, finals["carry"].fitness])
    half = algo.pop_size // 2
    medians = {form: statistics.median(t["ms_per_generation"] for t in turns if t["form"] == form)
               for form in ("carry", "replay")}
    print(f"[cso path] replay against carry, medians of {2 * CSO_AB_ROUNDS} runs each: "
          f"{json.dumps(medians)}", flush=True)
    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "dim": algo.dim,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * half / wall,
        "best_fitness_last": float(state.algo.fitness.min()),
        "replay_against_carry": turns,
        "replay_against_carry_median_ms": medians,
        "breakdown_ms": cso_breakdown(torch, wf, state),
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def cso_breakdown(torch, wf, state, reps: int = 10) -> dict:
    """Median host-clock ms of each stage of one CSO generation, each stage
    synchronised on both sides: the seed split (host only), the draw, the
    ask (the draw and the pair pass), Ackley, the tell, and a whole step."""
    from evox_tpu_torch.utils.common import split_seed

    algo, prob = wf.algorithm, wf.problem
    times = {name: [] for name in ("split_seed", "draw", "ask", "evaluate", "tell", "step")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        timed("split_seed", lambda: split_seed(state.algo.seed))
        timed("draw", lambda: algo._draw(state.algo.seed))
        cand, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, cand))
        timed("tell", lambda: algo.tell(astate, fit))
        timed("step", lambda: wf.step(state))
    return {name: statistics.median(v) for name, v in times.items()}


def device_us_per_call(torch, fn, calls: int = 20) -> float:
    """Device microseconds a call of ``fn`` keeps the card busy (every kernel
    it launches, torch.profiler), without the host's side of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def host_us_per_call(torch, fn, calls: int = 500) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue, back to back
    (the card keeps up with calls this small)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_cso_monitored(torch, gens: int, seed: int) -> dict:
    """The same run from a fresh state with ``EvalMonitor(topk=8)``: one
    elite update (one ``partial_topk`` launch) a generation, the best
    fitness falling, the last update held against the plain route, and B4
    timed at the monitor's shapes beside ``torch.topk``."""
    from evox_tpu_torch.kernels import topk as kt

    wf, mon = build_cso_path(torch, monitor=True)
    state = wf.step(wf.step(wf.init(seed)))  # the init step and a warm-up generation, as above
    best_warm = float(mon.get_best_fitness(state.monitors[0]))
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens - 1)
    before = state
    state = wf.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": gens, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} monitored CSO generations: {launches}, "
                             f"expected {want}")
    best_end = float(mon.get_best_fitness(state.monitors[0]))
    print(f"[cso monitored] best fitness after the warm-up {best_warm!r}, after {gens} more "
          f"generations {best_end!r}", flush=True)
    if not best_end < best_warm:
        raise AssertionError(f"the best fitness did not fall: {best_warm} -> {best_end}")

    # the last elite update: the same generation again (the draws come from
    # the state's seeds), its merged key through the plain route
    cand, _ = wf.algorithm.ask(before.algo)
    fit, _ = wf.problem.evaluate(before.prob, cand)
    prev = before.monitors[0]
    sign = mon.opt_direction[0]
    merged_key = torch.cat([prev.topk_fitness * sign, fit * sign])
    merged_fit = torch.cat([prev.topk_fitness, fit])
    merged_sol = torch.cat([prev.topk_solution, cand])
    plain_v, plain_i = kt.partial_topk_reference(merged_key, MONITOR_TOPK)
    last = state.monitors[0]
    elite = compare_exact(
        f"EvalMonitor elite, last update (n={merged_key.shape[0]}, k={MONITOR_TOPK}) against the "
        "plain route", [kt.partial_topk(merged_key, MONITOR_TOPK)[1], last.topk_fitness,
                        last.topk_solution],
        [plain_i, merged_fit[plain_i], merged_sol[plain_i]])

    # B4 at the monitor's shapes (n = pop/2 + topk), against torch.topk
    shapes = []
    for k in (1, MONITOR_TOPK):
        v = torch.cat([merged_key[:k], fit * sign]).contiguous()
        n = v.shape[0]
        compare_exact(f"partial_topk at the monitor's shape n={n} k={k}",
                      kt.partial_topk(v, k), kt.partial_topk_reference(v, k))
        b4 = lambda: kt.partial_topk(v, k)
        lib = lambda: torch.topk(v, k, largest=False)
        nbytes, ops = topk_work(n, k)
        row = {"n": n, "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
               "device_us": device_us_per_call(torch, b4),
               "library_device_us": device_us_per_call(torch, lib),
               "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
               "plain_ms": _time_ms(lambda: kt.partial_topk_reference(v, k), 5, 50)}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops)
        print(f"[monitor topk] {json.dumps(row)}", flush=True)
        shapes.append(row)
    return {
        "generations": gens,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "best_fitness_warmup": best_warm,
        "best_fitness_end": best_end,
        "last_elite_update": elite,
        "topk_at_monitor_shapes": shapes,
    }


def phase_cso_card_vs_cpu(torch, seed: int) -> dict:
    """One CSO generation on the card against the same generation on the
    CPU, from the same first-generation state with the draws made on the
    CPU and moved to the card."""
    from evox_tpu_torch.problems.numerical import ackley_func

    wf_cpu, _ = build_cso_path(torch, device="cpu")
    wf_card, _ = build_cso_path(torch)
    cpu, card = wf_cpu.algorithm, wf_card.algorithm
    state = cpu.init(seed)
    cand, state = cpu.init_ask(state)
    state = cpu.init_tell(state, ackley_func(cand))
    card_state = state.replace(population=state.population.cuda(), velocity=state.velocity.cuda(),
                               fitness=state.fitness.cuda())
    draws = cpu._draw(seed + 1)
    cpu._draw = lambda s: draws
    card._draw = lambda s: tuple(d.cuda() for d in draws)
    results = {}
    for name, algo, st in (("cpu", cpu, state), ("card", card, card_state)):
        c, st = algo.ask(st)
        st = algo.tell(st, ackley_func(c))
        results[name] = st
    got, want = results["card"], results["cpu"]
    # phi = 0 (bench.py's CSO): positions and velocities are the same
    # elementwise float32 operations on both devices, one rounding each, on
    # the same draws: bit for bit. The new fitness is Ackley's two means over
    # d 1024, which the card sums in another order: n·eps ≈ 1.2e-4 relative
    # in a mean at worst, shrunk by Ackley's outer terms (its value ~20 here
    # moves by less than 1e-5 relative for such an error)
    out = {"population": compare("CSO generation, population, card against CPU",
                                 got.population.cpu(), want.population, rtol=0.0, atol=0.0),
           "velocity": compare("CSO generation, velocity, card against CPU",
                               got.velocity.cpu(), want.velocity, rtol=0.0, atol=0.0),
           "fitness": compare("CSO generation, fitness, card against CPU",
                              got.fitness.cpu(), want.fitness, rtol=1e-5, atol=0.0)}
    return out


def phase_pso_family(torch, gens: int, seed: int) -> dict:
    """Every other algorithm of the PSO family for a few generations on the
    card: Sphere, pop 1024, d 100, an EvalMonitor on each (FIPS on the ring,
    DMS-PSO-EL in sub-swarms of 16 so that they divide 1024)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so import pso
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Sphere

    lb, ub = torch.full((PSO_DIM,), -10.0), torch.full((PSO_DIM,), 10.0)
    n = PSO_POP
    makers = {
        "PSO": lambda: pso.PSO(lb, ub, n),
        "CLPSO": lambda: pso.CLPSO(lb, ub, n),
        "SLPSOGS": lambda: pso.SLPSOGS(lb, ub, n),
        "SLPSOUS": lambda: pso.SLPSOUS(lb, ub, n),
        "FIPS (ring)": lambda: pso.FIPS(lb, ub, n, topology="ring"),
        "DMSPSOEL": lambda: pso.DMSPSOEL(lb, ub, n, sub_swarm_size=16),
        "FSPSO": lambda: pso.FSPSO(n, PSO_DIM),
        "SwmmPSO": lambda: pso.SwmmPSO(lb, ub, n),
        "SwmmPSO (shortcuts)": lambda: pso.SwmmPSO(lb, ub, n, shortcut_p=0.05),
    }
    out = {}
    for name, make in makers.items():
        algo = make()
        mon = EvalMonitor()
        wf = StdWorkflow(algo, Sphere(), monitors=[mon])
        state = wf.step(wf.init(seed))
        best_warm = float(mon.get_best_fitness(state.monitors[0]))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches["partial_topk"] != gens:
            raise AssertionError(f"{name}: {launches} in {gens} monitored generations")
        best = float(mon.get_best_fitness(state.monitors[0]))
        if not (math.isfinite(best) and best <= best_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}")
        _check_swarm(torch, name, algo, state.algo.population)
        row = {"pop": n, "dim": PSO_DIM, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "best_fitness_warmup": best_warm, "best_fitness": best}
        print(f"[pso family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_monitor_archive(torch, wf, seed: int) -> dict:
    """The EvalMonitor Pareto archive (pf_capacity 1024) on the card
    against the CPU's plain route, on the NSGA-II path's fitness: the
    parents' batch of 10000, then the offspring's; B3 runs at n 11024."""
    from evox_tpu_torch.monitors import EvalMonitor

    state = wf.step(wf.init(seed))  # the init step: the parents evaluated
    off, _ = wf.algorithm.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    batches = [(state.algo.population, state.algo.fitness), (off, fit)]
    card = EvalMonitor(multi_obj=True, pf_capacity=ARCHIVE_CAP)
    cpu = EvalMonitor(multi_obj=True, pf_capacity=ARCHIVE_CAP, device="cpu")
    s_card, s_cpu = card.init(), cpu.init()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for cand, f in batches:
        s_card = card.post_eval(s_card, cand, f)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"fused_rollout": 0, "packed_dominance": 2, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in two archive updates: {launches}, expected {want}")
    for cand, f in batches:
        s_cpu = cpu.post_eval(s_cpu, cand.cpu(), f.cpu())
    # B3 alone at the second update's merged fitness (the archive after the
    # first batch, then the offspring's)
    from evox_tpu_torch.kernels import dominance as kd

    merged = torch.cat([card.post_eval(card.init(), *batches[0]).topk_fitness, batches[1][1]])
    b3 = {"ms": _time_ms(lambda: kd.packed_dominance(merged), 3, 20)}
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(*merged.shape))
    stats = compare_exact(
        f"EvalMonitor archive (cap {ARCHIVE_CAP}, n {ARCHIVE_CAP + f.shape[0]}) on the card "
        "against the CPU's plain route (fitness, solutions, pf_count)",
        [s_card.topk_fitness, s_card.topk_solution, s_card.pf_count],
        [s_cpu.topk_fitness, s_cpu.topk_solution, s_cpu.pf_count])
    stats.update({"n": ARCHIVE_CAP + f.shape[0], "m": f.shape[1], "launches": launches,
                  "pf_count": int(s_card.pf_count), "ms_per_update": wall / len(batches) * 1e3,
                  "packed_dominance": b3})
    return stats


# ----------------------------------------------------------- main path 5


def build_cmaes_path(torch, dim: int = CMAES_DIM, device=None):
    """Main path 5 as a user builds it: ``StdWorkflow(CMAES(full(dim, 3.0),
    1.0), Rastrigin())``, pop and decomposition period at their defaults.
    ``dim`` and ``device`` exist for a rehearsal on the CPU."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.problems.numerical import Rastrigin

    algo = CMAES(torch.full((dim,), CMAES_CENTER), init_stdev=1.0, device=device)
    return StdWorkflow(algo, Rastrigin(), device=device)


def count_decompositions(algo) -> list:
    """Wrap ``algo._decompose`` to count its calls; returns the counter (a
    one-element list)."""
    calls = [0]
    decompose = algo._decompose

    def counted(C):
        calls[0] += 1
        return decompose(C)

    algo._decompose = counted
    return calls


def cmaes_breakdown(torch, wf, state, reps: int = 8) -> dict:
    """Median host-clock ms of each stage of a CMA-ES generation, each stage
    synchronised on both sides: ask, Rastrigin, tell and a whole step
    without the decomposition (from a state whose next iteration does not
    decompose), and ``safe_eigh`` of the covariance."""
    from evox_tpu_torch.algorithms.so.es.common import safe_eigh

    algo, prob = wf.algorithm, wf.problem
    period = algo.decomp_per_iter
    if (state.algo.iteration + 1) % period == 0 and period > 1:
        state = wf.step(state)
    times = {name: [] for name in ("ask", "evaluate", "tell", "step", "eigh")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        cand, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, cand))
        if period > 1:
            timed("tell", lambda: algo.tell(astate, fit))
            timed("step", lambda: wf.step(state))
        timed("eigh", lambda: safe_eigh(state.algo.C, algo.cond_cap, max_dim=algo.eigh_max_dim))
    return {name: statistics.median(v) for name, v in times.items() if v}


def phase_cmaes_path(torch, seed: int, profile: bool) -> dict:
    """Main path 5: CMA-ES with dense covariance at d 1000 on Rastrigin."""
    from evox_tpu_torch.algorithms.so.es.common import safe_eigh

    wf = build_cmaes_path(torch)
    algo = wf.algorithm
    period = algo.decomp_per_iter
    gens = period * math.ceil(GENERATIONS / period)
    print(f"[cmaes path] d {algo.dim}, pop {algo.pop_size}, mu {algo.mu}, decomp_per_iter "
          f"{period}, {gens} timed generations", flush=True)
    decomps = count_decompositions(algo)
    state = wf.init(seed)
    mean0 = state.algo.mean.clone()
    state = wf.step(state)  # warm-up: iteration 1, no decomposition unless the period is 1
    # cuSOLVER's first eigh creates its handle and workspace (~0.25 s, once
    # a process): made here, on the warm-up state's C, and timed on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    safe_eigh(state.algo.C, algo.cond_cap, max_dim=algo.eigh_max_dim)
    torch.cuda.synchronize()
    eigh_first_ms = (time.perf_counter() - t0) * 1e3

    reset_launches()  # every count to 0 just before the run
    decomps[0] = 0
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} CMA-ES generations: {launches}, expected {want}")
    if decomps[0] != gens // period:
        raise AssertionError(f"{decomps[0]} decompositions in {gens} generations, expected "
                             f"{gens // period}")
    s = state.algo
    C = s.C
    asym = float((C - C.T).abs().max() / C.abs().max())
    if not (bool(torch.isfinite(C).all()) and asym <= 1e-5):
        raise AssertionError(f"the covariance is not finite and symmetric (asymmetry {asym})")
    moved = float((s.mean - mean0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the mean did not move (|delta| = {moved})")
    cand, _ = algo.ask(s)
    fit, _ = wf.problem.evaluate(state.prob, cand)
    if not (cand.shape == (algo.pop_size, algo.dim) and bool(torch.isfinite(fit).all())):
        raise AssertionError("non-finite fitness on the CMA-ES path")

    # one safe_eigh at d 1000: CUDA events, and the host's clock (eigh waits
    # for the host inside the call)
    eigh = lambda: safe_eigh(C, algo.cond_cap, max_dim=algo.eigh_max_dim)
    eigh_ms = _time_ms(eigh, 2, 10)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eigh()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    out = {
        "dim": algo.dim,
        "pop": algo.pop_size,
        "mu": algo.mu,
        "decomp_per_iter": period,
        "generations": gens,
        "decompositions": decomps[0],
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * algo.pop_size / wall,
        "sigma_last": float(s.sigma),
        "best_fitness_last": float(fit.min()),
        "mean_moved": moved,
        "covariance_asymmetry": asym,
        "eigh_ms": eigh_ms,
        "eigh_host_ms": statistics.median(host),
        "eigh_first_call_ms": eigh_first_ms,
        "breakdown_ms": cmaes_breakdown(torch, wf, state),
    }
    if profile:
        # one whole period, so the decompositions' share is the timed run's
        prof = profile_generations(torch, wf, state, period)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def phase_cmaes_card_vs_cpu(torch, seed: int) -> dict:
    """One CMA-ES generation at d 1000 on the card against the CPU: the state
    after one decomposition period on the CPU, moved to the card, the same
    draws, the same Rastrigin fitness (the CPU's), the same (B, D). The
    card's generation runs twice, with TF32 allowed and not: CMA-ES's
    products are full float32 either way, so the two are equal bit for bit."""
    wf_cpu = build_cmaes_path(torch, device="cpu")
    cpu = wf_cpu.algorithm
    card = build_cmaes_path(torch).algorithm
    state = cpu.init(seed)
    for _ in range(cpu.decomp_per_iter):  # ends on a decomposition: B and D are not I and 1
        cand, state = cpu.ask(state)
        state = cpu.tell(state, wf_cpu.problem.evaluate(None, cand)[0])
    z = cpu._draw(seed + 1)
    cpu._draw = lambda s: z
    card._draw = lambda s: z.cuda()
    # should the compared generation decompose, both take the state's (B, D)
    cpu._decompose = lambda C: (state.B, state.D)
    card._decompose = lambda C: (state.B.cuda(), state.D.cuda())
    cand, cpu_state = cpu.ask(state)
    fit = wf_cpu.problem.evaluate(None, cand)[0]
    want = cpu.tell(cpu_state, fit)
    card_state = state.replace(**{
        f: getattr(state, f).cuda() for f in ("mean", "sigma", "pc", "ps", "C", "B", "D", "z")})
    results = {}
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            _, st = card.ask(card_state)
            results[tf32] = card.tell(st, fit.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    fields = ("mean", "C", "ps", "pc", "sigma")
    compare_exact("CMA-ES generation on the card, TF32 allowed against not",
                  [getattr(results[True], f) for f in fields],
                  [getattr(results[False], f) for f in fields])
    got = results[False]
    # float32 products of length 1000 (B z, (z D) B^T) and 12 (the selected
    # steps), summed by cuBLAS and by the CPU's BLAS in other orders: n eps =
    # 6e-5 of a field's scale at worst over a 1000-term sum, ~4e-6 typical;
    # so 1e-4 relative, with an absolute floor of 1e-5 of the field's
    # largest entry for entries near 0
    out = {}
    for f in fields:
        ref = getattr(want, f)
        scale = float(ref.abs().max())
        out[f] = compare(f"CMA-ES generation at d {cpu.dim}, {f}, card against CPU",
                         getattr(got, f).cpu().reshape(-1), ref.reshape(-1), rtol=1e-4,
                         atol=1e-5 * scale)
    return out


# ----------------------------------------------------------- main path 6


def make_pgpe(dim: int, pop: int, device):
    """Main path 6's algorithm: PGPE with its defaults (ClipUp, center lr
    0.15, stdev 0.1) from a zero center."""
    import torch

    from evox_tpu_torch.algorithms.so.es import PGPE

    return PGPE(pop_size=pop, center_init=torch.zeros(dim), device=device)


def phase_pgpe_walker(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 6: the walker path with PGPE (ClipUp) in OpenES's place,
    driven and checked by ``phase_walker_path``; and the tell's one redraw
    of delta, timed."""
    from evox_tpu_torch.utils import ClipUp

    wf, make_problem, adapter = build_walker_path(torch, algorithm=make_pgpe)
    algo = wf.algorithm
    if not isinstance(algo.optimizer, ClipUp):
        raise AssertionError(f"PGPE's optimizer is {type(algo.optimizer).__name__}, not ClipUp")
    out = phase_walker_path(torch, wf, make_problem, adapter, gens, seed, profile)
    state = algo.init(seed)
    out["delta_redraw_ms"] = _time_ms(lambda: algo._delta(state), 1, 3)
    out["delta_bytes"] = 4 * (algo.pop_size // 2) * algo.dim
    return out


# ------------------------------------------------------ the ES family phase


def es_family_makers(torch, n: int, dim: int) -> dict:
    """The ES family phase's algorithms at pop ``n`` (ESMC ``n + 1``: the
    mean and n/2 antithetic pairs), from a center of 3.0 in every
    coordinate."""
    from evox_tpu_torch.algorithms.so import es

    c = torch.full((dim,), 3.0)
    return {
        "SepCMAES": lambda: es.SepCMAES(c, 1.0, pop_size=n),
        "IPOPCMAES": lambda: es.IPOPCMAES(c, 1.0, pop_size=n),
        "MAES": lambda: es.MAES(c, 1.0, pop_size=n),
        "LMMAES": lambda: es.LMMAES(c, 1.0, pop_size=n),
        "RMES": lambda: es.RMES(c, 1.0, pop_size=n),
        "XNES": lambda: es.XNES(c, 1.0, pop_size=n),
        "SeparableNES": lambda: es.SeparableNES(c, 1.0, pop_size=n),
        "SNES": lambda: es.SNES(c, 1.0, pop_size=n),
        "CR_FM_NES": lambda: es.CR_FM_NES(c, 1.0, pop_size=n),
        "ARS": lambda: es.ARS(c, n, learning_rate=0.1),
        "ASEBO": lambda: es.ASEBO(c, n, subspace_dims=3),
        "GuidedES": lambda: es.GuidedES(c, n, subspace_dims=2),
        "PersistentES": lambda: es.PersistentES(c, n, truncation_length=5),
        "NoiseReuseES": lambda: es.NoiseReuseES(c, n, truncation_length=5),
        "ESMC": lambda: es.ESMC(c, n + 1),
        "DES": lambda: es.DES(c, 1.0, pop_size=n),
        "AMaLGaM": lambda: es.AMaLGaM(c, 1.0, pop_size=n),
        "IndependentAMaLGaM": lambda: es.IndependentAMaLGaM(c, 1.0, pop_size=n),
        "LES": lambda: es.LES(c, 1.0, pop_size=n),  # its bundled meta-trained parameters
    }


def phase_ars_topk(torch, wf, before, state) -> dict:
    """ARS's last tell against the same tell on the plain route of
    ``partial_topk``, and B4 at ARS's shape timed beside ``torch.topk``."""
    from evox_tpu_torch.algorithms.so.es import ars as ars_module
    from evox_tpu_torch.kernels import topk as kt

    algo = wf.algorithm
    cand, astate = algo.ask(before.algo)  # the last generation again, from its seeds
    fit, _ = wf.problem.evaluate(before.prob, cand)
    fit = fit * wf.opt_direction[0]
    score = torch.minimum(fit[: algo.n_dirs], fit[algo.n_dirs :])
    n, k = score.shape[0], algo.top_k
    top = compare_exact(f"ARS's top-k (n={n}, k={k}) against the plain route",
                        kt.partial_topk(score, k), kt.partial_topk_reference(score, k))
    kernel_route = ars_module.partial_topk
    ars_module.partial_topk = lambda v, kk, device=None: kt.partial_topk_reference(v, kk)
    try:
        plain_state = algo.tell(astate, fit)
    finally:
        ars_module.partial_topk = kernel_route
    compare_exact("ARS's last center against a tell on the plain route",
                  [state.algo.center], [plain_state.center])
    b4 = lambda: kt.partial_topk(score, k)
    lib = lambda: torch.topk(score, k, largest=False)
    row = {"n": n, "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
           "device_us": device_us_per_call(torch, b4),
           "library_device_us": device_us_per_call(torch, lib),
           "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
           "plain_ms": _time_ms(lambda: kt.partial_topk_reference(score, k), 5, 50),
           "max_abs_err": top["max_abs_err"]}
    row["bound_ms"], row["bound_by"] = bound_ms(*topk_work(n, k))
    print(f"[ars topk] {json.dumps(row)}", flush=True)
    return row


def phase_es_family(torch, gens: int, seed: int) -> dict:
    """Every other algorithm of the ES family for a few generations on the
    card: Sphere, pop 1024 (ESMC 1025), d 100, an EvalMonitor on each; ARS's
    top-k checked and timed; and RestartCMAESDriver for two restarts."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import RestartCMAESDriver
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Sphere, sphere_func

    out = {}
    for name, make in es_family_makers(torch, ES_POP, ES_DIM).items():
        algo = make()
        mon = EvalMonitor()
        wf = StdWorkflow(algo, Sphere(), monitors=[mon])
        state = wf.step(wf.init(seed))
        best_warm = float(mon.get_best_fitness(state.monitors[0]))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens - 1)
        before = state
        state = wf.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        # the monitor's elite launches B4 once a generation, ARS's tell once more
        topk = 2 * gens if name == "ARS" else gens
        want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": topk,
                "fused_mlp_rollout": 0}
        if launches != want:
            raise AssertionError(f"{name}: {launches} in {gens} monitored generations, "
                                 f"expected {want}")
        best = float(mon.get_best_fitness(state.monitors[0]))
        if not (math.isfinite(best) and best <= best_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}")
        row = {"pop": algo.pop_size, "dim": ES_DIM, "generations": gens,
               "ms_per_generation": wall / gens * 1e3, "best_fitness_warmup": best_warm,
               "best_fitness": best, "launches": launches}
        if name == "ARS":
            row["tell_topk_launches"] = launches["partial_topk"] - gens
            row["topk"] = phase_ars_topk(torch, wf, before, state)
        print(f"[es family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row

    driver = RestartCMAESDriver(torch.full((ES_DIM,), 3.0), 1.0, sphere_func)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_x, best_f = driver.run(seed, max_restarts=RESTARTS, gens_per_run=RESTART_GENERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    base = driver.base_pop_size
    if driver.pop_sizes != [base * 2**i for i in range(RESTARTS)]:
        raise AssertionError(f"IPOP pop sizes {driver.pop_sizes}, base {base}")
    start = ES_DIM * 3.0**2
    again = float(sphere_func(best_x[None])[0])  # one row's sum: another order, ~1 ulp
    if not (math.isfinite(best_f) and best_f < start and best_x.device.type == driver.device.type
            and abs(again - best_f) <= 1e-5 * best_f):
        raise AssertionError(f"RestartCMAESDriver's best {best_f}: not a Sphere value below "
                             f"the start's {start}")
    out["RestartCMAESDriver"] = {"dim": ES_DIM, "pop_sizes": driver.pop_sizes,
                                 "generations_per_run": RESTART_GENERATIONS, "wall_s": wall,
                                 "best_fitness": best_f}
    print(f"[es family] RestartCMAESDriver: {json.dumps(out['RestartCMAESDriver'])}", flush=True)
    return out


# ------------------------------------------- main paths 7 and 8, MO family


def _time_host_ms(torch, fn) -> float:
    """Host-clock ms of one call of ``fn``, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mo_breakdown(torch, wf, state, extra: dict, reps: int = 5) -> dict:
    """Median host-clock ms of each stage of one generation of an MO path,
    each synchronised: ask, evaluate, tell, and the stages of ``extra``
    (name -> fn(astate, fitness))."""
    algo, prob = wf.algorithm, wf.problem
    times = {name: [] for name in ("ask", "evaluate", "tell", *extra)}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        off, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, off))
        timed("tell", lambda: algo.tell(astate, fit))
        for name, fn in extra.items():
            timed(name, lambda fn=fn: fn(astate, fit))
    return {name: statistics.median(v) for name, v in times.items()}


def run_mo_path(torch, wf, gens: int, seed: int, want_launches: dict) -> tuple:
    """The init step, one warm-up generation, then ``gens`` timed
    generations with every launch counter set to 0 just before and read
    just after. Checks the launches, and, once after the run, fitness that
    is finite (or an empty niche's +inf) and a population within the
    bounds; returns ``(state, wall_s, launches)``."""
    algo = wf.algorithm
    state = wf.step(wf.init(seed))  # the init step: the parents evaluated
    state = wf.step(state)  # warm-up generation
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0,
            **want_launches}
    name = type(algo).__name__
    if launches != want:
        raise AssertionError(f"{name}: launches in {gens} generations {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"{name}: generation {state.generation} != {gens + 2}")
    pop, fit = state.algo.population, state.algo.fitness
    # RVEA's, RVEAa's and LMOCSO's empty niches hold +inf rows
    finite = torch.isfinite(fit).all(dim=1)
    if not (finite.any() and (fit[~finite] == float("inf")).all() and (pop >= algo.lb).all()
            and (pop <= algo.ub).all()):
        raise AssertionError(f"{name}: the population leaves the bounds or its fitness is neither "
                             "finite nor an empty niche's")
    return state, wall, launches


def mo_quality(torch, wf, state) -> dict:
    """IGD against the problem's true front, and the exact 3-D hypervolume
    of the final population at ``HV_REF`` (outside the timed window)."""
    from evox_tpu_torch.metrics import hypervolume_3d, igd

    fit = state.algo.fitness
    # empty niches' +inf rows count as far away, as tests/test_mo_algorithms.py counts them
    fit = torch.where(torch.isfinite(fit).all(dim=1, keepdim=True), fit, 1e6)
    value = float(igd(fit, wf.problem.pf()))
    ref = torch.tensor(HV_REF, device=fit.device)
    hv_ms = _time_host_ms(torch, lambda: hypervolume_3d(fit, ref))
    hv = float(hypervolume_3d(fit, ref))
    if not (math.isfinite(value) and 0.0 <= hv <= math.prod(HV_REF)):
        raise AssertionError(f"IGD {value}, hypervolume {hv}: not a measure of a front")
    return {"igd": value, "hypervolume": hv, "hypervolume_ref": list(HV_REF),
            "hypervolume_ms": hv_ms}


def profile_path(torch, wf, state, wall: float, gens: int, prof_gens: int = 5) -> dict:
    prof = profile_generations(torch, wf, state, prof_gens)
    prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
    return prof


def phase_moead_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 7: ``StdWorkflow(MOEAD(zeros(12), ones(12), n_objs=3,
    pop_size=10000, aggregate_op="pbi"), DTLZ2(d=12, m=3))``: 9870
    subproblems, T 20, max_replace 4, no kernel. Also the constructor's
    neighbour table timed on the card and built on the CPU (equal element
    for element), IGD and the hypervolume, and one tell on the card against
    the same tell on the CPU."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import MOEAD
    from evox_tpu_torch.algorithms.mo.moead import neighbor_table
    from evox_tpu_torch.problems.numerical import DTLZ2

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    algo = MOEAD(lb, ub, n_objs=MO_M, pop_size=MO_POP, aggregate_op="pbi")
    torch.cuda.synchronize()
    build = {"constructor_s": time.perf_counter() - t0}
    build["neighbor_table_ms"] = statistics.median(
        _time_host_ms(torch, lambda: neighbor_table(algo.weights, algo.T)) for _ in range(3))
    t0 = time.perf_counter()
    cpu_algo = MOEAD(lb, ub, n_objs=MO_M, pop_size=MO_POP, aggregate_op="pbi", device="cpu")
    build["cpu_constructor_s"] = time.perf_counter() - t0
    if (algo.pop_size, algo.T, algo.nr) != (MO_SUBPROBLEMS, 20, 4):
        raise AssertionError(f"MOEA/D: {algo.pop_size} subproblems, T {algo.T}, nr {algo.nr}")
    build["table"] = compare_exact(f"MOEA/D neighbour table ({algo.pop_size}, 20), built on the card against "
                                   "built on the CPU", [algo.neighbors.cpu()], [cpu_algo.neighbors])

    wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {})
    out = {"pop": algo.pop_size, "dim": MOEAD_D, "T": algo.T, "generations": gens,
           "launches": launches, "wall_s": wall, "ms_per_generation": wall / gens * 1e3,
           "generations_per_s": gens / wall, "build": build,
           "breakdown_ms": mo_breakdown(torch, wf, state, {}), **mo_quality(torch, wf, state)}

    # one tell on the card against the same tell on the CPU
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    on_card = algo.tell(astate, fit)
    cpu_state = astate.replace(**{f: getattr(astate, f).cpu() for f in
                                  ("population", "fitness", "ideal", "offspring")})
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    ideal = torch.minimum(astate.ideal, torch.amin(fit, dim=0))
    rep_card, win_card = algo.replacement(astate.fitness, ideal, fit)
    rep_cpu, win_cpu = cpu_algo.replacement(cpu_state.fitness, ideal.cpu(), fit.cpu())
    differ = (rep_card.cpu() != rep_cpu) | (rep_cpu & (win_card.cpu() != win_cpu))
    tell = {"replaced": int(rep_cpu.sum()), "decisions_differ": int(differ.sum())}
    if tell["decisions_differ"]:
        # the aggregation values that decided each differing slot, both sides
        off_c, inc_c = (v.cpu() for v in algo.aggregation_values(astate.fitness, ideal, fit))
        off_h, inc_h = cpu_algo.aggregation_values(cpu_state.fitness, ideal.cpu(), fit.cpu())
        nbr = cpu_algo.neighbors
        for s in torch.nonzero(differ)[:20, 0].tolist():
            i, j = torch.nonzero(nbr == s, as_tuple=True)
            print(f"[moead tell] slot {s}: card off {off_c[i, j].tolist()} inc {inc_c[i, j].tolist()}"
                  f"; cpu off {off_h[i, j].tolist()} inc {inc_h[i, j].tolist()}", flush=True)
        # PBI over m = 3 in index order on both, the root correctly rounded:
        # equal by construction; 1e-6 would allow an ulp or two
        tell["values"] = compare("MOEA/D aggregation values, card against CPU",
                                 torch.cat([off_c, inc_c]), torch.cat([off_h, inc_h]),
                                 rtol=1e-6, atol=0.0)
    same = ~differ
    tell.update(compare_exact(
        "MOEA/D tell on the card against the CPU (population and fitness where the decisions "
        "agree, ideal)", [on_card.population.cpu()[same], on_card.fitness.cpu()[same],
                          on_card.ideal.cpu()],
        [on_cpu.population[same], on_cpu.fitness[same], on_cpu.ideal]))
    out["tell_vs_cpu"] = tell
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def phase_nsga3_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 8: ``StdWorkflow(NSGA3(zeros(7), ones(7), n_objs=3,
    pop_size=10000), DTLZ1(d=7, m=3))``: 9870 reference points, merged n
    19740, one ``packed_dominance`` launch a generation. Also the fronts
    peeled a generation, B3 at n 19740 against its plain version, the sort
    to the cut against the full peel, the closed-form niching against the
    sequential loop (timed once), IGD and the hypervolume, and one
    selection on the card against the CPU's plain route."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA3
    from evox_tpu_torch.algorithms.mo import nsga3 as mod
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.operators.selection import non_dominated_sort
    from evox_tpu_torch.problems.numerical import DTLZ1

    algo = NSGA3(torch.zeros(NSGA3_D), torch.ones(NSGA3_D), n_objs=MO_M, pop_size=MO_POP)
    k = algo.pop_size
    fronts = []  # each selection's fronts peeled, kept on the device
    select_mask = algo.select_mask

    def recording_select_mask(fit):
        selected, rank = select_mask(fit)
        # no host read: unranked rows (rank n) count as -1
        fronts.append(torch.where(rank < fit.shape[0], rank, -1).amax() + 1)
        return selected, rank

    algo.select_mask = recording_select_mask
    wf = StdWorkflow(algo, DTLZ1(d=NSGA3_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": gens})
    algo.select_mask = select_mask
    out = {"pop": k, "dim": NSGA3_D, "merged_n": 2 * k, "generations": gens, "launches": launches,
           "wall_s": wall, "ms_per_generation": wall / gens * 1e3, "generations_per_s": gens / wall,
           "fronts_peeled": [int(f) for f in fronts[-gens:]], **mo_quality(torch, wf, state)}

    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n = merged.shape[0]

    def niching_inputs(f):
        return mod.niching_inputs(f, algo.refs.to(f.device), k)[1]

    args = niching_inputs(merged)
    merged_of = lambda a, f: torch.cat([a.fitness, f])
    extra = {
        "packed_dominance": lambda a, f: kd.packed_dominance(merged_of(a, f)),
        "sort_to_cut": lambda a, f: non_dominated_sort(merged_of(a, f), until=k),
        "sort_full_peel": lambda a, f: non_dominated_sort(merged_of(a, f)),
        "normalize_associate": lambda a, f: mod.associate(mod.normalize(merged_of(a, f)), algo.refs),
        "niche_closed_form": lambda a, f: mod.niche(*args),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra)
    out["breakdown_ms"]["niche_sequential_once"] = _time_host_ms(torch, lambda: mod.niche_sequential(*args))
    out["need"], out["candidates"] = int(args[5]), int(args[1].sum())
    if not torch.equal(mod.niche_sequential(*args), mod.niche(*args)):
        raise AssertionError("NSGA-III: the closed-form niching differs from the loop on the card")

    # B3 at the path's merged fitness, against its plain version
    got = kd.packed_dominance(merged, device=merged.device)
    want = kd.packed_dominance_reference(merged)
    b3 = compare_exact(f"packed_dominance, NSGA-III merged fitness n={n} m={MO_M}", got, want)
    b3["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=merged.device), 3, 20)
    b3["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(n, MO_M))
    out["packed_dominance"] = b3

    # one selection on the card against the CPU's plain route
    cpu_algo = NSGA3(algo.lb.cpu(), algo.ub.cpu(), n_objs=MO_M, pop_size=MO_POP, device="cpu")
    if not torch.equal(cpu_algo.refs, algo.refs.cpu()):
        raise AssertionError("NSGA-III: the reference directions differ between the card and the CPU")
    sel_card, rank_card = algo.select_mask(merged)
    t0 = time.perf_counter()
    sel_cpu, rank_cpu = cpu_algo.select_mask(merged.cpu())
    cpu_s = time.perf_counter() - t0
    differ = sel_card.cpu() != sel_cpu
    if differ.any() or not torch.equal(rank_card.cpu(), rank_cpu):
        # the near-ties that decided each difference: association and distance
        c_args, h_args = niching_inputs(merged), niching_inputs(merged.cpu())
        for i in torch.nonzero(differ)[:20, 0].tolist():
            print(f"[nsga3 select] row {i}: card pi {int(c_args[2][i])} dist {float(c_args[3][i])!r}"
                  f"; cpu pi {int(h_args[2][i])} dist {float(h_args[3][i])!r}", flush=True)
    out["select_vs_cpu"] = compare_exact(
        "NSGA-III selection on the card against the CPU (survivor mask, ranks)",
        [sel_card.cpu(), rank_card.cpu()], [sel_cpu, rank_cpu])
    out["select_vs_cpu"]["cpu_select_s"] = cpu_s
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def mo_family_makers(torch) -> dict:
    """The family phase's algorithms at pop ``MO_FAMILY_POP`` requested, each
    with the B3 launches it makes a generation."""
    from evox_tpu_torch.algorithms import mo

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)

    def make(cls):
        return lambda: cls(lb, ub, n_objs=MO_M, pop_size=MO_FAMILY_POP)

    return {
        "MOEADDRA": (make(mo.MOEADDRA), 0),
        "MOEADM2M": (make(mo.MOEADM2M), 1),  # the full sort of its tell
        "EAGMOEAD": (make(mo.EAGMOEAD), 1),  # the archive's selection
        "RVEA": (make(mo.RVEA), 0),
        "RVEAa": (make(mo.RVEAa), 0),
        "TDEA": (make(mo.TDEA), 1),  # the sort to the cut of its selection
        "LMOCSO": (make(mo.LMOCSO), 0),
    }


def phase_mo_family(torch, gens: int, seed: int) -> dict:
    """The rest of the decomposition and reference-vector family, ``gens``
    generations each on DTLZ2(d=12, m=3) at pop 1000 requested: ms a
    generation, IGD after the run, launches checked."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import DTLZ2

    out = {}
    for name, (make, b3) in mo_family_makers(torch).items():
        algo = make()
        wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
        state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": b3 * gens})
        row = {"pop": algo.pop_size, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "launches": launches, **mo_quality(torch, wf, state)}
        if b3:
            row["n"] = 2 * algo.pop_size  # B3's input: parents and offspring
        print(f"[mo family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_dtlz(torch, seed: int) -> dict:
    """DTLZ1-7 evaluated on the card against the CPU at pop 9870 (m 3, each
    at its default d), and DTLZ7's ``pf()``, which sorts on B3, against the
    CPU's."""
    from evox_tpu_torch.operators.sampling import UniformSampling
    from evox_tpu_torch.problems import numerical

    out = {}
    g = torch.Generator().manual_seed(seed)
    for i in range(1, 8):
        prob = getattr(numerical, f"DTLZ{i}")(m=MO_M)
        pop = torch.rand((MO_SUBPROBLEMS, prob.d), generator=g)
        got, _ = prob.evaluate(None, pop.cuda())
        want, _ = prob.evaluate(None, pop)
        # the card's cosf/sinf/powf and the CPU's differ by an ulp or two;
        # DTLZ1's and DTLZ3's g scale a sum of cosines by 100
        out[f"DTLZ{i}"] = compare(f"DTLZ{i} (m 3, d {prob.d}, pop {MO_SUBPROBLEMS}) on the card "
                                  "against the CPU",
                                  got.cpu(), want, rtol=1e-5, atol=1e-5)
    card, cpu = numerical.DTLZ7(m=MO_M), numerical.DTLZ7(m=MO_M, device="cpu")
    torch.cuda.synchronize()
    reset_launches()
    pf = card.pf()
    torch.cuda.synchronize()
    launches = read_launches()["packed_dominance"]
    if launches != 1:
        raise AssertionError(f"DTLZ7.pf() launched packed_dominance {launches} times, expected 1")
    pf_cpu = cpu.pf()
    if pf.shape != pf_cpu.shape:
        raise AssertionError(f"DTLZ7.pf(): {tuple(pf.shape)} on the card, {tuple(pf_cpu.shape)} on the CPU")
    out["DTLZ7_pf"] = compare("DTLZ7.pf() on the card against the CPU", pf.cpu(), pf_cpu,
                              rtol=1e-6, atol=1e-6)
    out["DTLZ7_pf"].update({"launches": launches,
                            "n": UniformSampling(card.ref_num * 10, MO_M - 1, device="cpu")()[1]})
    return out


# ------------------------------------------- main path 9, DE family, CEC 2022


def build_shade_path(torch, pop: int = SHADE_POP, dim: int = SHADE_DIM, device=None):
    """Main path 9 as a user builds it: SHADE on the port's Ackley at path
    4's shape (``bench.py:134-185``'s workload). ``pop``, ``dim`` and
    ``device`` exist for a rehearsal on the CPU at a small size."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.de import SHADE
    from evox_tpu_torch.problems.numerical import Ackley

    bound = torch.full((dim,), SHADE_BOUND)
    algo = SHADE(lb=-bound, ub=bound, pop_size=pop, memory_size=SHADE_MEMORY, device=device)
    return StdWorkflow(algo, Ackley(), device=device)


def state_to(state, device):
    """A copy of an algorithm state with every tensor (nested states too) on
    ``device``."""
    import dataclasses

    import torch

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if dataclasses.is_dataclass(v):
            return v.replace(**{f.name: move(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v

    return move(state)


def topk_row(torch, v, k: int, name: str) -> dict:
    """``partial_topk`` on ``v`` held against its plain version, and timed
    beside ``torch.topk`` (CUDA events, device time, host time) and its
    bound."""
    from evox_tpu_torch.kernels import topk as kt

    check = compare_exact(f"{name} (n={v.shape[0]}, k={k}) against the plain route",
                          kt.partial_topk(v, k), kt.partial_topk_reference(v, k))
    b4 = lambda: kt.partial_topk(v, k)
    lib = lambda: torch.topk(v, k, largest=False)
    row = {"n": v.shape[0], "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
           "device_us": device_us_per_call(torch, b4),
           "library_device_us": device_us_per_call(torch, lib),
           "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
           "plain_ms": _time_ms(lambda: kt.partial_topk_reference(v, k), 5, 50),
           "max_abs_err": check["max_abs_err"]}
    row["bound_ms"], row["bound_by"] = bound_ms(*topk_work(v.shape[0], k))
    print(f"[{name}] {json.dumps(row)}", flush=True)
    return row


def phase_shade_path(torch, gens: int, seed: int, profile: bool) -> tuple:
    """Main path 9: SHADE(±32, d 1024, pop 4096, memory 100) on Ackley —
    the init step, one warm-up generation, then ``gens`` timed generations
    with every count set to 0 just before and read just after: one
    ``partial_topk`` launch a generation (the pbest cut) and no other. Then
    the cut on the card against a stable argsort, B4 at (4096, k) against
    its plain version and ``torch.topk``, the split, and the profile.
    Returns ``(results, workflow, final state)``."""
    from evox_tpu_torch.algorithms.so.de.common import pbest_cut, sort_key

    wf = build_shade_path(torch)
    algo = wf.algorithm
    state = wf.step(wf.step(wf.init(seed)))  # the init step, then a warm-up generation
    best_warm = float(state.algo.fitness.min())
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": gens, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} SHADE generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    _check_swarm(torch, "SHADE path", algo, state.algo.population)
    fit = state.algo.fitness
    best = float(fit.min())
    if not (torch.isfinite(fit).all() and best <= best_warm):
        raise AssertionError(f"SHADE path: fitness not finite or the best rose ({best_warm} -> {best})")
    k = algo.pbest_k
    stable = torch.argsort(fit, stable=True)[:k]
    cut = compare_exact(f"SHADE's pbest cut (n={algo.pop_size}, k={k}) against a stable argsort",
                        [pbest_cut(fit, k)], [stable])
    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "dim": algo.dim,
        "memory_size": algo.H,
        "pbest_k": k,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * algo.pop_size / wall,
        "best_fitness_warmup": best_warm,
        "best_fitness": best,
        "archive_size": int(state.algo.archive_size),
        "mem_pos": int(state.algo.mem_pos),
        "pbest_cut_vs_argsort": cut,
        "topk": topk_row(torch, sort_key(fit), k, "shade topk"),
        "breakdown_ms": mo_breakdown(torch, wf, state, {}),
    }
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out, wf, state


def phase_shade_card_vs_cpu(torch, wf, state, seed: int) -> dict:
    """One SHADE generation on the card against the same generation on the
    CPU, from path 9's last state, with the same draws (made on the CPU and
    moved) and the same fitness handed to both tells (Ackley of the CPU's
    trials, so its transcendental last bits decide no selection)."""
    from evox_tpu_torch.algorithms.so.de import SHADE
    from evox_tpu_torch.problems.numerical import ackley_func

    card = wf.algorithm
    cpu = SHADE(lb=card.lb.cpu(), ub=card.ub.cpu(), pop_size=card.pop_size, memory_size=card.H,
                device="cpu")
    card_state = state.algo
    cpu_state = state_to(card_state, "cpu")
    draws = cpu._draw(seed + 1)
    cpu._draw = lambda s: draws
    card._draw = lambda s: {name: d.cuda() for name, d in draws.items()}
    try:
        cand_card, after_card = card.ask(card_state)
        cand_cpu, after_cpu = cpu.ask(cpu_state)
        pbest = compare_exact("SHADE pbest rows, card against CPU",
                              [card.pbest_indices(card_state.fitness, draws["p"].cuda(),
                                                  draws["u_pbest"].cuda()).cpu()],
                              [cpu.pbest_indices(cpu_state.fitness, draws["p"], draws["u_pbest"])])
        trials = compare_exact("SHADE trials, card against CPU", [cand_card.cpu()], [cand_cpu])
        fit = ackley_func(cand_cpu)
        got = card.tell(after_card, fit.cuda())
        want = cpu.tell(after_cpu, fit)
    finally:
        del card._draw
    out = {"pbest": pbest, "trials": trials, "replaced": int(want.attrib.success.sum()),
           "archive_size": int(want.archive_size), "mem_pos": int(want.mem_pos)}
    out["state"] = compare_exact(
        "SHADE tell, card against CPU (population, fitness, archive, archive_size, mem_pos, F, CR, "
        "attribution)",
        [got.population.cpu(), got.fitness.cpu(), got.archive.cpu(), got.archive_size.cpu(),
         got.mem_pos.cpu(), got.F.cpu(), got.CR.cpu(), got.attrib.success.cpu(),
         got.attrib.improvement.cpu()],
        [want.population, want.fitness, want.archive, want.archive_size, want.mem_pos, want.F,
         want.CR, want.attrib.success, want.attrib.improvement])
    # M_F and M_CR take weighted sums over the 4096 candidates, which the
    # card adds in another order than the CPU: n eps ~ 2.4e-4 relative at
    # worst for positive terms, ~1e-6 in practice; 1e-4 relative
    out["memory"] = compare("SHADE memories M_F and M_CR, card against CPU",
                            torch.cat([got.M_F, got.M_CR]).cpu(), torch.cat([want.M_F, want.M_CR]),
                            rtol=1e-4, atol=0.0)
    return out


def de_family_makers(torch) -> dict:
    """The DE family phase's algorithms (pop 1024, d 100, ±10), each with
    its B4 launches a generation and its evaluations a generation."""
    from evox_tpu_torch.algorithms.so import de

    lb, ub = torch.full((DE_DIM,), -10.0), torch.full((DE_DIM,), 10.0)
    n = DE_POP
    return {
        "DE (rand/1)": (lambda: de.DE(lb, ub, n), 0, n),
        "DE (best/2)": (lambda: de.DE(lb, ub, n, base_vector="best", num_difference_vectors=2), 0, n),
        "ODE": (lambda: de.ODE(lb, ub, n), 0, n),
        "CoDE": (lambda: de.CoDE(lb, ub, n), 0, 3 * n),  # three trials a parent
        "SaDE": (lambda: de.SaDE(lb, ub, n), 0, n),
        "JaDE": (lambda: de.JaDE(lb, ub, n), 1, n),  # the pbest cut
        "SHADE": (lambda: de.SHADE(lb, ub, n), 1, n),
    }


def phase_de_family(torch, gens: int, seed: int) -> dict:
    """The DE family for a few generations each on the card: Sphere, pop
    1024, d 100; launches counted as on a main path (JaDE's and SHADE's
    pbest cut: one B4 launch a generation), ms a generation and the best
    fitness; JaDE's cut (n 1024, k 51) held against the plain route and
    timed beside ``torch.topk``."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.de.common import sort_key
    from evox_tpu_torch.problems.numerical import Sphere

    out = {}
    for name, (make, b4, evals) in de_family_makers(torch).items():
        algo = make()
        wf = StdWorkflow(algo, Sphere())
        state = wf.step(wf.init(seed))  # the init step: the population evaluated
        best_warm, mean_warm = float(state.algo.fitness.min()), float(state.algo.fitness.mean())
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": b4 * gens,
                "fused_mlp_rollout": 0}
        if launches != want:
            raise AssertionError(f"{name}: {launches} in {gens} generations, expected {want}")
        # greedy slot selection: the best cannot rise, and any success lowers
        # the mean (the best slot itself need not improve in a few generations)
        best, mean = float(state.algo.fitness.min()), float(state.algo.fitness.mean())
        if not (math.isfinite(mean) and best <= best_warm and mean < mean_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}, mean {mean_warm} "
                                 f"-> {mean}")
        _check_swarm(torch, name, algo, state.algo.population)
        row = {"pop": algo.pop_size, "dim": DE_DIM, "generations": gens,
               "evals_per_generation": evals, "ms_per_generation": wall / gens * 1e3,
               "best_fitness_warmup": best_warm, "best_fitness": best, "mean_fitness_warmup": mean_warm,
               "mean_fitness": mean, "launches": launches}
        if name == "JaDE":
            row["topk"] = topk_row(torch, sort_key(state.algo.fitness), algo.p_num, "jade topk")
        print(f"[de family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_cec2022(torch, seed: int) -> dict:
    """CEC 2022 F1-F12 at every dimension the suite defines (F6-F8 at 10
    and 20), on the card against the CPU at 1024 points in the box; each
    member's optimum (the shift vector) on the card."""
    from evox_tpu_torch.problems.numerical import cec2022

    g = torch.Generator().manual_seed(seed)
    out = {}
    for f in range(1, 13):
        card = cec2022.CEC2022TestSuite.create(f)
        cpu = cec2022.CEC2022TestSuite.create(f, device="cpu")
        for d in cec2022.SUPPORTED_DIMS:
            if d not in cec2022.HYBRID_DIMS and f in (6, 7, 8):
                continue
            x = torch.rand((CEC_ROWS, d), generator=g) * 200.0 - 100.0
            x[0] = cpu.shift[:d] if cpu.shift.ndim == 1 else cpu.shift[0, :d]
            got, _ = card.evaluate(None, x.cuda())
            want, _ = cpu.evaluate(None, x)
            # the card's and the CPU's sin, cos, exp and pow differ by an ulp
            # or two and the rotations' products add in other orders; a
            # Schwefel part keeps a few ulps of its 418.98 k constant (4.9e-4
            # at d 20) near the optimum (tests/test_torch_cec2022.py)
            schwefel = f in (7, 8, 10, 11, 12)
            row = compare(f"CEC2022 F{f} (d {d}, {CEC_ROWS} points) on the card against the CPU",
                          got.cpu(), want, rtol=1e-4, atol=4e-3 if schwefel else 1e-6)
            opt = float(got[0])
            # 0, or the float32 residue of a Schwefel or Ackley constant
            if not (opt == 0.0 or (f in (7, 8, 10) and 0.0 < opt <= 4e-3)):
                raise AssertionError(f"CEC2022 F{f} (d {d}) at its optimum: {opt}")
            row["at_optimum"] = opt
            out[f"F{f}_d{d}"] = row
    return out


# ----------------------- main paths 10 and 11, the indicator and knee family, MaF


def gde3_pre_selection(fit_parent, fit_trial):
    """GDE3's ``+inf`` branches: (parents its trial dominates, trials their
    parent dominates), as ``(n,)`` bool."""
    from evox_tpu_torch.algorithms.mo.gde3 import pairwise_dominates

    return pairwise_dominates(fit_trial, fit_parent), pairwise_dominates(fit_parent, fit_trial)


def phase_gde3_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 10: ``StdWorkflow(GDE3(*LSMOP1(d=300, m=3).bounds(),
    n_objs=3, pop_size=10000, F=0.5, CR=0.3), LSMOP1(d=300, m=3))`` (path
    2's shape): one ``packed_dominance`` launch a generation at n 20000 in
    ``non_dominate``. Also the split, B3 at the path's merged fitness
    against its plain version, IGD and the hypervolume, and one tell on the
    card against the CPU's plain routes on a told fitness that takes both
    ``+inf`` branches."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import GDE3
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.operators.selection import non_dominate, non_dominated_sort
    from evox_tpu_torch.problems.numerical import LSMOP1

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M)
    algo = GDE3(*prob.bounds(), n_objs=LSMOP_M, pop_size=NSGA2_POP, F=GDE3_F, CR=GDE3_CR)
    wf = StdWorkflow(algo, prob)
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": gens})
    k = algo.pop_size
    out = {"pop": k, "dim": LSMOP_D, "merged_n": 2 * k, "F": algo.F, "CR": algo.CR,
           "generations": gens, "launches": launches, "wall_s": wall,
           "ms_per_generation": wall / gens * 1e3, "generations_per_s": gens / wall,
           **mo_quality(torch, wf, state)}

    def merged_of(a, f):
        par_inf, tri_inf = gde3_pre_selection(a.fitness, f)
        return torch.cat([torch.where(par_inf[:, None], torch.inf, a.fitness),
                          torch.where(tri_inf[:, None], torch.inf, f)])

    extra = {
        "pre_selection": merged_of,
        "packed_dominance": lambda a, f: kd.packed_dominance(merged_of(a, f)),
        "sort_to_cut": lambda a, f: non_dominated_sort(merged_of(a, f), until=k),
        "non_dominate": lambda a, f: non_dominate(torch.cat([a.population, a.offspring]),
                                                  merged_of(a, f), k),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra)

    # one tell on the card against the CPU, on a told fitness with both
    # +inf branches: trials that dominate their parents, trials that their
    # parents dominate
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    fit = fit.clone()
    fit[:GDE3_FORCED] = astate.fitness[:GDE3_FORCED] - 0.01
    fit[GDE3_FORCED:2 * GDE3_FORCED] = astate.fitness[GDE3_FORCED:2 * GDE3_FORCED] + 0.01
    par_inf, tri_inf = gde3_pre_selection(astate.fitness, fit)
    branches = {"parents_to_inf": int(par_inf.sum()), "trials_to_inf": int(tri_inf.sum())}
    if min(branches.values()) < GDE3_FORCED:
        raise AssertionError(f"GDE3 tell: the +inf branches were not both taken: {branches}")
    merged = merged_of(astate, fit)
    on_card = algo.tell(astate, fit)
    cpu_algo = GDE3(algo.lb.cpu(), algo.ub.cpu(), n_objs=LSMOP_M, pop_size=k, F=GDE3_F, CR=GDE3_CR,
                    device="cpu")
    cpu_state = state_to(astate, "cpu")
    t0 = time.perf_counter()
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    tell = compare_exact("GDE3 tell on the card against the CPU's plain routes (population and "
                         "fitness, in order)", [on_card.population.cpu(), on_card.fitness.cpu()],
                         [on_cpu.population, on_cpu.fitness])
    tell.update(branches, cpu_tell_s=time.perf_counter() - t0,
                inf_in_merged=int(torch.isinf(merged).any(dim=1).sum()))
    out["tell_vs_cpu"] = tell

    # B3 at the path's merged fitness (+inf rows included), against its plain version
    n = merged.shape[0]
    b3 = compare_exact(f"packed_dominance, GDE3 merged fitness n={n} m={LSMOP_M}",
                       kd.packed_dominance(merged, device=merged.device),
                       kd.packed_dominance_reference(merged))
    b3["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=merged.device), 3, 20)
    b3["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(n, LSMOP_M))
    out["packed_dominance"] = b3
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def removal_launches(torch, expo, removals: int) -> float:
    """CUDA kernels a removal of IBEA's loop launches, counted by the
    profiler over ``removals`` removals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from evox_tpu_torch.algorithms.mo.ibea import worst_removal

    keep = expo.shape[0] - removals
    worst_removal(expo, keep)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        worst_removal(expo, keep)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    # the loop's setup (the scores' halving sum, the final sort) launches
    # a fixed number: take the count at one removal off
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        worst_removal(expo, expo.shape[0] - 1)
        torch.cuda.synchronize()
    setup = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return (kernels - setup) / (removals - 1)


def phase_ibea_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 11: ``StdWorkflow(IBEA(zeros(12), ones(12), n_objs=3,
    pop_size=10000, kappa=0.05), DTLZ2(d=12, m=3))``: merged n 20000, a
    (20000, 20000) float32 indicator matrix and 10000 sequential removals a
    generation, no
    kernel of the port. Also the split (the matrix, the removal loop), the
    launches a removal makes and its host time, IGD and the hypervolume,
    and one selection on the card held against the same loop step by step
    on the card (survivors equal) and against the CPU (terms within the
    tests' tolerance, survivors and the removal order equal)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import IBEA
    from evox_tpu_torch.algorithms.mo import ibea as mod
    from evox_tpu_torch.problems.numerical import DTLZ2

    torch.cuda.reset_peak_memory_stats()  # the phase's own peak, not an earlier path's
    algo = IBEA(torch.zeros(MOEAD_D), torch.ones(MOEAD_D), n_objs=MO_M, pop_size=MO_POP,
                kappa=IBEA_KAPPA)
    wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {})
    k = algo.pop_size
    out = {"pop": k, "dim": MOEAD_D, "merged_n": 2 * k, "kappa": algo.kappa, "generations": gens,
           "launches": launches, "wall_s": wall, "ms_per_generation": wall / gens * 1e3,
           "generations_per_s": gens / wall, **mo_quality(torch, wf, state)}

    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n = merged.shape[0]
    expo = mod.indicator_terms(merged, algo.kappa)
    extra = {
        "indicator_terms": lambda a, f: mod.indicator_terms(torch.cat([a.fitness, f]), algo.kappa),
        "removal_loop": lambda a, f: mod.worst_removal(expo, k),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra, reps=3)
    out["removals"] = n - k
    out["removal_us"] = out["breakdown_ms"]["removal_loop"] * 1e3 / (n - k)
    out["launches_per_removal"] = removal_launches(torch, expo.clone(), 200)
    out["expo_bytes"] = expo.numel() * expo.element_size()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    # the fast loop against the step-by-step one, on the card
    fast = mod.worst_removal(expo, k)
    t0 = time.perf_counter()
    stepwise, order = mod.worst_removal_stepwise(expo, k)
    torch.cuda.synchronize()
    out["stepwise_loop_s"] = time.perf_counter() - t0
    out["select_vs_stepwise"] = compare_exact(
        f"IBEA select (n {n}, keep {k}), the fast loop against the step-by-step one on the card",
        [fast], [stepwise])

    # against the CPU: the terms within the tests' score tolerance, then the
    # survivors and the removal order
    t0 = time.perf_counter()
    expo_cpu = mod.indicator_terms(merged.cpu(), algo.kappa)
    stepwise_cpu, order_cpu = mod.worst_removal_stepwise(expo_cpu, k)
    out["cpu_select_s"] = time.perf_counter() - t0
    # tests/test_torch_mo_indicator.py's SCORE_RTOL: the terms are rounded
    # once from float64 on both, so they should agree to the bit
    terms = compare("IBEA terms -exp(-I/(c kappa)), card against CPU", expo.cpu(), expo_cpu,
                    rtol=1e-5, atol=0.0)
    terms["bit_equal"] = bool(torch.equal(expo.cpu(), expo_cpu))
    out["select_vs_cpu"] = compare_exact(
        "IBEA select, card against CPU (survivors, removal order)",
        [stepwise.cpu(), order.cpu()], [stepwise_cpu, order_cpu])
    out["select_vs_cpu"]["terms"] = terms
    del expo, expo_cpu
    if profile:
        # 40000 launches a generation: two generations under the profiler
        out["profile"] = profile_path(torch, wf, state, wall, gens, prof_gens=2)
    return out


def indicator_family_makers(torch, g: int) -> dict:
    """The family phase's algorithms at pop ``MO_FAMILY_POP``, each with its
    ``packed_dominance`` launches in ``g`` timed generations (which start on
    an even BCE-IBEA generation)."""
    from evox_tpu_torch.algorithms import mo

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)

    def make(cls):
        return lambda: cls(lb, ub, n_objs=MO_M, pop_size=MO_FAMILY_POP)

    return {
        "IBEA": (make(mo.IBEA), 0),
        "SRA": (make(mo.SRA), 0),
        "BCEIBEA": (make(mo.BCEIBEA), (g + 1) // 2),  # the PC selection, even generations
        "SPEA2": (make(mo.SPEA2), 0),
        "HypE": (make(mo.HypE), g),  # the full sort of its tell
        "KnEA": (make(mo.KnEA), g),  # the full sort of its tell
        "BiGE": (make(mo.BiGE), 3 * g),  # the mating's bi-goals, the merged and the cut's bi-goals
    }


def family_loops(torch, algo, astate, fit) -> dict:
    """Each sequential loop of the family's selections on one generation's
    merged rows, alone: name -> fn()."""
    from evox_tpu_torch.algorithms.mo import bce_ibea, ibea, knea, spea2, sra
    from evox_tpu_torch.operators.selection import non_dominated_sort

    name = type(algo).__name__
    k = algo.pop_size
    if name in ("IBEA", "BCEIBEA"):
        merged = torch.cat([astate.npc_fit if name == "BCEIBEA" else astate.fitness, fit])
        expo = ibea.indicator_terms(merged, algo.kappa)
        loops = {"removal_loop": lambda: ibea.worst_removal(expo, k)}
        if name == "BCEIBEA" and astate.counter % 2 == 0:
            pc_fit = torch.cat([astate.fitness, fit, astate.new_pc_fit])
            mask = non_dominated_sort(pc_fit, until=1) == 0
            n_nd = mask.sum().to(torch.int32)
            removals = int(n_nd) - k
            if removals > 0:
                loops["pc_thinning"] = lambda: bce_ibea.pc_thinning(pc_fit, mask, n_nd, removals)
        return loops
    merged = torch.cat([astate.fitness, fit])
    if name == "SRA":
        i_eps, sde = sra.sra_indicators(merged)
        d = astate.select_draws
        return {"sweeps": lambda: sra.stochastic_ranking(i_eps, sde, d["perm"], d["u_sweeps"], d["pc"])}
    if name == "SPEA2":
        dist = spea2.masked_dist(merged)
        nd = spea2.spea2_fitness(merged, dist) < 1.0
        removals = int(nd.sum()) - k
        return {"truncation": lambda: spea2.truncate(dist, nd, removals)} if removals > 0 else {}
    if name == "KnEA":
        order, rank, last, sizes = algo.sorted_fronts(merged)
        fit_sel = torch.where((rank <= last)[:, None], merged[order], torch.nan)
        return {"knee_loop": lambda: algo.find_knees(fit_sel, rank, sizes, astate.r, astate.t)}
    return {}


def phase_indicator_family(torch, gens: int, seed: int) -> dict:
    """IBEA, SRA, BCE-IBEA, SPEA2, HypE, KnEA and BiGE, ``gens`` generations
    each on DTLZ2(d=12, m=3) at pop 1000: ms a generation, the split, each
    sequential loop of the selection alone, IGD; launches checked."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import DTLZ2

    out = {}
    for name, (make, b3) in indicator_family_makers(torch, gens).items():
        algo = make()
        wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
        state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": b3})
        row = {"pop": algo.pop_size, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "launches": launches, **mo_quality(torch, wf, state)}
        off, astate = algo.ask(state.algo)
        fit, _ = wf.problem.evaluate(state.prob, off)
        row["loops_ms"] = {loop: statistics.median(_time_host_ms(torch, fn) for _ in range(3))
                           for loop, fn in family_loops(torch, algo, astate, fit).items()}
        row["breakdown_ms"] = mo_breakdown(torch, wf, state, {}, reps=3)
        print(f"[indicator family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_maf(torch, seed: int) -> dict:
    """MaF1-15 at m 3 and 5, each at its default d, evaluated on the card
    against the CPU at pop 10000 in its own box; MaF11's ``pf()``, which
    filters its points on B3, against the CPU's at m 3 and 5."""
    from evox_tpu_torch.problems.numerical import maf

    out = {}
    g = torch.Generator().manual_seed(seed)
    for m in (3, 5):
        for i in range(1, 16):
            card = getattr(maf, f"MaF{i}")(m=m)
            cpu = getattr(maf, f"MaF{i}")(m=m, device="cpu")
            lb, ub = cpu.bounds()
            pop = torch.rand((MAF_POP, cpu.d), generator=g) * (ub - lb) + lb
            got, _ = card.evaluate(None, pop.cuda())
            want, _ = cpu.evaluate(None, pop)
            # the card's and the CPU's cos, sin and pow differ by an ulp or
            # two; where a factor nearly cancels (MaF4's and MaF15's 1 - a
            # front of cosines, scaled by 1 + g up to ~1e5) that ulp is of the
            # row's scale, not of the value: 1e-4 relative, 1e-6 of the
            # row's largest |objective| (at least 1) absolute. MaF12's
            # s_decept (slope 1/B = 1000) and s_multi (slope (4A + 2) pi ~
            # 383) magnify an ulp of their input up to a thousandfold: 1e-4
            # of the row's scale there
            scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
            out[f"MaF{i}_m{m}"] = compare(f"MaF{i} (m {m}, d {cpu.d}, pop {MAF_POP}) on the card "
                                          "against the CPU, over each row's scale",
                                          got.cpu() / scale, want / scale, rtol=1e-4,
                                          atol=1e-4 if i == 12 else 1e-6)
        card, cpu = maf.MaF11(m=m), maf.MaF11(m=m, device="cpu")
        torch.cuda.synchronize()
        reset_launches()
        pf = card.pf()
        torch.cuda.synchronize()
        launches = read_launches()["packed_dominance"]
        if launches != 1:
            raise AssertionError(f"MaF11.pf() (m {m}) launched packed_dominance {launches} times")
        pf_cpu = cpu.pf()
        if pf.shape != pf_cpu.shape:
            raise AssertionError(f"MaF11.pf() (m {m}): {tuple(pf.shape)} on the card, "
                                 f"{tuple(pf_cpu.shape)} on the CPU")
        row = compare(f"MaF11.pf() (m {m}) on the card against the CPU", pf.cpu(), pf_cpu,
                      rtol=1e-6, atol=2e-6)
        row.update({"launches": launches, "n": cpu._uniform_pts().shape[0], "front": pf.shape[0]})
        out[f"MaF11_pf_m{m}"] = row
    return out


def monitor_callers(name: str, paths: dict) -> list:
    """Each call site of B3 or B4 on the main paths, with its shape and its
    launches in that path's run."""
    if name == "packed_dominance":
        arch = paths["monitor_archive"]
        nsga3 = paths["nsga3"]
        family = paths["mo_family"]
        gde3, ind, maf = paths["gde3"], paths["indicator_family"], paths["maf"]
        b3 = {key: nsga3["packed_dominance"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                              "max_abs_err")}
        return [{"caller": "non_dominated_sort in NSGA-II's tell (path 2)", "n": 2 * NSGA2_POP,
                 "m": LSMOP_M, "launches": paths["nsga2"]["launches"][name]},
                {"caller": "EvalMonitor Pareto archive (two updates)", "n": arch["n"], "m": arch["m"],
                 "launches": arch["launches"][name], "ms_per_update": arch["ms_per_update"],
                 **arch["packed_dominance"]},
                {"caller": "non_dominated_sort(until=k) in NSGA-III's select (path 8)",
                 "n": nsga3["merged_n"], "m": MO_M, "launches": nsga3["launches"][name], **b3},
                *({"caller": f"{algo}'s tell (the MO family phase)", "n": family[algo]["n"], "m": MO_M,
                   "launches": family[algo]["launches"][name]}
                  for algo in ("MOEADM2M", "TDEA", "EAGMOEAD")),
                {"caller": "DTLZ7.pf() (the DTLZ phase)", "n": paths["dtlz"]["DTLZ7_pf"]["n"],
                 "m": MO_M, "launches": paths["dtlz"]["DTLZ7_pf"]["launches"]},
                {"caller": "non_dominate in GDE3's tell (path 10)", "n": gde3["merged_n"], "m": LSMOP_M,
                 "launches": gde3["launches"][name],
                 **{key: gde3["packed_dominance"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                                   "bound_by", "max_abs_err")}},
                *({"caller": caller, "n": n, "m": m, "launches": ind[algo]["launches"][name]}
                  for algo, caller, n, m in (
                      ("HypE", "HypE's tell (the indicator family phase)", 2 * MO_FAMILY_POP, MO_M),
                      ("KnEA", "KnEA's tell (the indicator family phase)", 2 * MO_FAMILY_POP, MO_M),
                      ("BiGE", "BiGE's mating bi-goals, merged objectives and cut front's "
                               "bi-goals (the indicator family phase)",
                       [MO_FAMILY_POP, 2 * MO_FAMILY_POP, 2 * MO_FAMILY_POP], [2, MO_M, 2]),
                      ("BCEIBEA", "BCE-IBEA's PC selection, until=1, even generations (the "
                                  "indicator family phase)", 3 * MO_FAMILY_POP, MO_M))),
                *({"caller": f"MaF11.pf() at m {m} (the MaF phase)", "n": maf[f"MaF11_pf_m{m}"]["n"],
                   "m": m, "launches": maf[f"MaF11_pf_m{m}"]["launches"]} for m in (3, 5))]
    mon = paths["cso_monitored"]
    ars = paths["es_family"]["ARS"]
    shade = paths["shade"]
    jade = paths["de_family"]["JaDE"]
    return [{"caller": "rank_crowding_truncate in NSGA-II's tell (path 2)", "n": 2 * NSGA2_POP,
             "k": NSGA2_POP, "launches": paths["nsga2"]["launches"][name]},
            {"caller": "EvalMonitor elite (path 4, monitored run)",
             "n": CSO_POP // 2 + MONITOR_TOPK, "k": MONITOR_TOPK,
             "launches": mon["launches"][name], "shapes": mon["topk_at_monitor_shapes"]},
            {"caller": "ARS's tell (the ES family phase)", "n": ars["topk"]["n"],
             "k": ars["topk"]["k"], "launches": ars["tell_topk_launches"], "shapes": [ars["topk"]]},
            {"caller": "SHADE's pbest cut in its ask (path 9)", "n": shade["topk"]["n"],
             "k": shade["topk"]["k"], "launches": shade["launches"][name], "shapes": [shade["topk"]]},
            {"caller": "JaDE's pbest cut in its ask (the DE family phase)", "n": jade["topk"]["n"],
             "k": jade["topk"]["k"], "launches": jade["launches"][name], "shapes": [jade["topk"]]}]


def kernel_entries(kernels: dict, paths: dict) -> list:
    """The ``kernels`` line: one entry per kernel of the main paths."""
    pend = kernels["pendulum"]
    entries = [{
        "name": "fused_rollout",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/rollout.cu",
        "replaces": "evox_tpu/kernels/rollout.py:468",
        "launches": paths["pendulum"]["launches"],
        "max_abs_err": pend["max_abs_err"],
        "ms": pend["ms"],
        "plain_ms": pend["plain_ms"],
        "bound_ms": pend["bound_ms"],
        "bound_by": pend["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "block": pend["block"],
    }]
    for name, source, replaces in (
        ("packed_dominance", "dominance.cu", "evox_tpu/kernels/dominance.py:222"),
        ("partial_topk", "topk.cu", "evox_tpu/kernels/topk.py:185"),
    ):
        k = kernels[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"evox_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": paths["nsga2"]["launches"][name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # partial_topk: torch.topk(v, k, largest=False), the same
            # values with an unspecified tie order; packed_dominance: no
            # single PyTorch call computes it
            "library_ms": k.get("library_ms"),
            **({"block": k["block"]} if "block" in k else {}),
            **{key: k[key] for key in ("empty_launch_ms", "ms_1e6", "library_ms_1e6") if key in k},
            "callers": monitor_callers(name, paths),
        })
    w = kernels["walker"]
    entries.append({
        "name": "fused_mlp_rollout",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/rollout_mlp.cu",
        "replaces": "evox_tpu/kernels/rollout_mlp.py:569",
        "launches": paths["walker"]["launches"],
        "max_abs_err": w["max_abs_err"],
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "copy_only_ms": w["copy_only_ms"],
        "block": w["block"],
        "callers": [{"caller": "PolicyRolloutProblem under OpenES (path 3)",
                     "launches": paths["walker"]["launches"]},
                    {"caller": "PolicyRolloutProblem under PGPE with ClipUp (path 6)",
                     "launches": paths["pgpe_walker"]["launches"]}],
    })
    return entries


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

    # 2. kernels against plain, on the main paths' inputs and on stress inputs
    wf, make_problem = build_main_path(torch, SEED)
    kernels = phase_kernels(torch, kr, wf, SEED)
    wf2 = build_nsga2_path(torch)
    kernels.update(phase_nsga2_kernels(torch, wf2, SEED))
    wf3, make_walker_problem, adapter = build_walker_path(torch)
    kernels.update(phase_walker_kernels(torch, wf3, adapter, SEED))

    # 3.-5. the main paths
    paths = {}
    paths["pendulum"] = phase_main_path(torch, kr, wf, make_problem, GENERATIONS, SEED,
                                        args.profile)
    print(f"[main path] {json.dumps(paths['pendulum'])}", flush=True)
    del wf
    paths["nsga2"] = phase_nsga2_path(torch, wf2, GENERATIONS, SEED, args.profile)
    print(f"[nsga2 path] {json.dumps(paths['nsga2'])}", flush=True)
    paths["monitor_archive"] = phase_monitor_archive(torch, wf2, SEED)
    print(f"[monitor archive] {json.dumps(paths['monitor_archive'])}", flush=True)
    del wf2
    paths["walker"] = phase_walker_path(torch, wf3, make_walker_problem, adapter,
                                        GENERATIONS, SEED, args.profile)
    print(f"[walker path] {json.dumps(paths['walker'])}", flush=True)
    del wf3, adapter, make_walker_problem
    torch.cuda.empty_cache()
    # 6. main path 4 (CSO on Ackley), its monitored run, one generation
    # against the CPU, and the rest of the PSO family
    paths["cso"] = phase_cso_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[cso path] {json.dumps(paths['cso'])}", flush=True)
    paths["cso_monitored"] = phase_cso_monitored(torch, GENERATIONS, SEED)
    print(f"[cso monitored] {json.dumps(paths['cso_monitored'])}", flush=True)
    paths["cso_card_vs_cpu"] = phase_cso_card_vs_cpu(torch, SEED)
    paths["pso_family"] = phase_pso_family(torch, PSO_GENERATIONS, SEED)
    # 7. main path 5 (CMA-ES, dense covariance, d 1000) and one of its
    # generations against the CPU; main path 6 (PGPE on the walker); the
    # rest of the ES family
    paths["cmaes"] = phase_cmaes_path(torch, SEED, args.profile)
    print(f"[cmaes path] {json.dumps(paths['cmaes'])}", flush=True)
    paths["cmaes_card_vs_cpu"] = phase_cmaes_card_vs_cpu(torch, SEED)
    paths["pgpe_walker"] = phase_pgpe_walker(torch, GENERATIONS, SEED, args.profile)
    print(f"[pgpe walker path] {json.dumps(paths['pgpe_walker'])}", flush=True)
    torch.cuda.empty_cache()
    paths["es_family"] = phase_es_family(torch, ES_GENERATIONS, SEED)
    # 8. main paths 7 (MOEA/D on DTLZ2) and 8 (NSGA-III on DTLZ1), the rest
    # of their family, and DTLZ on the card against the CPU
    torch.cuda.empty_cache()
    paths["moead"] = phase_moead_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[moead path] {json.dumps(paths['moead'])}", flush=True)
    paths["nsga3"] = phase_nsga3_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[nsga3 path] {json.dumps(paths['nsga3'])}", flush=True)
    torch.cuda.empty_cache()
    paths["mo_family"] = phase_mo_family(torch, MO_GENERATIONS, SEED)
    paths["dtlz"] = phase_dtlz(torch, SEED)
    # 9. main path 9 (SHADE on Ackley) and one of its generations against the
    # CPU, the DE family, and CEC 2022 on the card against the CPU
    paths["shade"], wf9, state9 = phase_shade_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[shade path] {json.dumps(paths['shade'])}", flush=True)
    paths["shade_card_vs_cpu"] = phase_shade_card_vs_cpu(torch, wf9, state9, SEED)
    del wf9, state9
    paths["de_family"] = phase_de_family(torch, DE_GENERATIONS, SEED)
    paths["cec2022"] = phase_cec2022(torch, SEED)
    # 10. main paths 10 (GDE3 on LSMOP1) and 11 (IBEA on DTLZ2), the
    # indicator and knee family, and MaF on the card against the CPU
    torch.cuda.empty_cache()
    paths["gde3"] = phase_gde3_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[gde3 path] {json.dumps(paths['gde3'])}", flush=True)
    torch.cuda.empty_cache()
    paths["ibea"] = phase_ibea_path(torch, IBEA_GENERATIONS, SEED, args.profile)
    print(f"[ibea path] {json.dumps(paths['ibea'])}", flush=True)
    torch.cuda.empty_cache()
    paths["indicator_family"] = phase_indicator_family(torch, MO_GENERATIONS, SEED)
    paths["maf"] = phase_maf(torch, SEED)
    if "jax" in sys.modules or any(
        k == "evox_tpu" or k.startswith("evox_tpu.") for k in sys.modules
    ):
        raise AssertionError("the port pulled in jax or the JAX package")

    line = {"kernels": kernel_entries(kernels, paths)}
    result = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "kernels": kernels,
        "main_path": paths["pendulum"],
        "nsga2_path": paths["nsga2"],
        "walker_path": paths["walker"],
        "cso_path": paths["cso"],
        "cso_monitored": paths["cso_monitored"],
        "cso_card_vs_cpu": paths["cso_card_vs_cpu"],
        "pso_family": paths["pso_family"],
        "monitor_archive": paths["monitor_archive"],
        "cmaes_path": paths["cmaes"],
        "cmaes_card_vs_cpu": paths["cmaes_card_vs_cpu"],
        "pgpe_walker_path": paths["pgpe_walker"],
        "es_family": paths["es_family"],
        "moead_path": paths["moead"],
        "nsga3_path": paths["nsga3"],
        "mo_family": paths["mo_family"],
        "dtlz": paths["dtlz"],
        "shade_path": paths["shade"],
        "shade_card_vs_cpu": paths["shade_card_vs_cpu"],
        "de_family": paths["de_family"],
        "cec2022": paths["cec2022"],
        "gde3_path": paths["gde3"],
        "ibea_path": paths["ibea"],
        "indicator_family": paths["indicator_family"],
        "maf": paths["maf"],
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(smi, flush=True)  # the card's name and power limit again, near the verdict
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
