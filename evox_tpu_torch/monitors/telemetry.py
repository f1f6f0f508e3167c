"""TelemetryMonitor — run telemetry held on the device; the port of
``evox_tpu/monitors/telemetry.py``.

Every accumulator is a tensor in the monitor's state, updated in
``post_eval`` with no host read, so a generation's telemetry queues on the
card with the rest of the generation. Tracked per generation in a
fixed-capacity ring: best and (finite-masked) mean fitness and the
population's diversity (mean per-dimension std of the candidates).
Tracked cumulatively: NaN and Inf element counts of candidates and
fitness, generations since the best improved, the generation of the last
improvement, generation and evaluation counts; in ``post_step``, a
``GuardedAlgorithm``'s restarts and trigger, and a screening
``SurrogateWorkflow``'s true evaluations and fallback generations. The
getters and :meth:`TelemetryMonitor.report` read the state on the host.

``report`` is strict JSON through ``core/instrument.sanitize_json``;
``core/instrument.run_report`` merges it with the host's timings, and
``write_chrome_trace`` draws ``counter_tracks`` as counter tracks.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.instrument import sanitize_json
from ..core.monitor import Monitor
from ..core.struct import PyTreeNode, named_leaves
from ..utils.common import halving_sum, sqrt_rn, tree_flatten
from .common import ring_slots, ring_write


class TelemetryState(PyTreeNode):
    # cumulative counters, () int32
    generations: torch.Tensor
    evals: torch.Tensor
    nan_candidates: torch.Tensor
    inf_candidates: torch.Tensor
    nan_fitness: torch.Tensor
    inf_fitness: torch.Tensor
    # best so far, in the minimisation convention: () or (m,)
    best_key: torch.Tensor
    best_generation: torch.Tensor  # () 1-based generation of the last improvement
    stagnation: torch.Tensor  # () generations since the best improved
    # per-generation rings, slot (generation - 1) % capacity, user direction
    ring_best: torch.Tensor  # (K,) or (K, m)
    ring_mean: torch.Tensor  # (K,) or (K, m)
    ring_diversity: torch.Tensor  # (K,)
    # a GuardedAlgorithm's restarts and latest trigger (post_step)
    restarts: torch.Tensor
    last_trigger: torch.Tensor
    # a screening SurrogateWorkflow's true evaluations and triggered
    # fallback generations (post_step); zeros for every other workflow
    sur_true_evals: torch.Tensor = None
    sur_fallback_gens: torch.Tensor = None


def _float_leaves(tree: Any) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor) and x.is_floating_point()]


def _column_sums(blocks: list) -> list:
    """The sum over the rows of each 2-D block, as ``halving_sum`` gives it:
    blocks with as many rows share one ``halving_sum`` side by side
    (``log2(rows)`` launches for all of them; each column adds as it would
    alone)."""
    out = [None] * len(blocks)
    for rows in sorted({b.shape[0] for b in blocks}):
        idx = [i for i, b in enumerate(blocks) if b.shape[0] == rows]
        sums = halving_sum(torch.cat([blocks[i] for i in idx], dim=1))
        for i, total in zip(idx, torch.split(sums, [blocks[i].shape[1] for i in idx])):
            out[i] = total
    return out


class TelemetryMonitor(Monitor):
    """On-device run telemetry.

    Args:
        capacity: ring size: the last ``capacity`` generations' best and
            mean fitness and diversity stay on the device.
        num_objectives: fitness arity; ``m > 1`` tracks the per-objective
            ideal point and means (rings ``(capacity, m)``).
        device: where the state lives; ``None`` means ``"cuda"``.

    Fitness is reported in the user's direction; improvement and
    stagnation use the minimisation key internally. Counters are int32.
    """

    def __init__(self, capacity: int = 128, num_objectives: int = 1, device: DeviceLike = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if num_objectives < 1:
            raise ValueError(f"num_objectives must be >= 1, got {num_objectives}")
        self.capacity = capacity
        self.num_objectives = num_objectives
        self.device = resolve_device(device)
        self.opt_direction = torch.ones((1,), device=self.device)

    def hooks(self):
        return ("post_eval", "post_step")

    def init(self, seed: Optional[int] = None) -> TelemetryState:
        K, m, dev = self.capacity, self.num_objectives, self.device
        stat_shape = () if m == 1 else (m,)
        ring_shape = (K,) if m == 1 else (K, m)
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        inf = lambda shape: torch.full(shape, float("inf"), device=dev)
        return TelemetryState(
            generations=i32(), evals=i32(), nan_candidates=i32(), inf_candidates=i32(),
            nan_fitness=i32(), inf_fitness=i32(), best_key=inf(stat_shape),
            best_generation=i32(), stagnation=i32(), ring_best=inf(ring_shape),
            ring_mean=inf(ring_shape), ring_diversity=inf((K,)), restarts=i32(),
            last_trigger=i32(), sur_true_evals=i32(), sur_fallback_gens=i32(),
        )

    # ------------------------------------------------------------------ hook
    def post_eval(self, mstate: TelemetryState, cand: Any, fitness: torch.Tensor) -> TelemetryState:
        m = self.num_objectives
        if m == 1 and fitness.ndim != 1:
            raise ValueError(
                f"TelemetryMonitor(num_objectives=1) got fitness of shape "
                f"{tuple(fitness.shape)}; pass num_objectives={fitness.shape[-1]} "
                "for multi-objective runs"
            )
        if m > 1 and (fitness.ndim != 2 or fitness.shape[-1] != m):
            raise ValueError(
                f"TelemetryMonitor(num_objectives={m}) got fitness of shape "
                f"{tuple(fitness.shape)}"
            )
        fitness = fitness.to(torch.float32)
        leaves = _float_leaves(cand)

        def count(pred, xs):
            total = torch.zeros((), dtype=torch.int32, device=fitness.device)
            for x in xs:
                total = total + pred(x).sum(dtype=torch.int32)
            return total

        direction = self.opt_direction[0] if m == 1 else self.opt_direction
        key_fit = fitness * direction
        finite = torch.isfinite(key_fit)
        gen_best_key = torch.where(finite, key_fit, float("inf")).amin(0)

        # Every sum over the population is a halving_sum, one fixed order: a
        # member's ring under member_call rounds as its solo run's does, on
        # the card and on the CPU. The sums of one pass share their
        # halving_sum (_column_sums).
        zero = torch.zeros((), device=fitness.device)
        flats = [x.to(torch.float32).reshape(x.shape[0], -1) for x in leaves]
        oks = [torch.isfinite(f) for f in flats]
        fin2 = finite.reshape(finite.shape[0], -1)
        k = len(flats)
        sums = _column_sums([ok.to(torch.float32) for ok in oks]
                            + [torch.where(ok, f, zero) for ok, f in zip(oks, flats)]
                            + [fin2.to(torch.float32),
                               torch.where(fin2, fitness.reshape(fin2.shape), zero)])
        n_finite = sums[2 * k].reshape(fitness.shape[1:])
        gen_mean = sums[2 * k + 1].reshape(fitness.shape[1:]) / torch.clamp(n_finite, min=1.0)

        # diversity: mean per-dimension std over the batch, finite-masked
        ns = [torch.clamp(n, min=1.0) for n in sums[:k]]
        means = [total / n for total, n in zip(sums[k:2 * k], ns)]
        var = _column_sums([torch.where(ok, (f - mu) ** 2, zero)
                            for ok, f, mu in zip(oks, flats, means)])
        std_sum = torch.zeros((), device=fitness.device)
        for v, n in zip(var, ns):
            std_sum = std_sum + halving_sum(sqrt_rn(v / n))
        diversity = std_sum / max(sum(f.shape[1] for f in flats), 1)

        improved = (gen_best_key < mstate.best_key).any()
        generations = mstate.generations + 1
        upd = lambda buf, row: ring_write(buf, row, mstate.generations)
        return mstate.replace(
            generations=generations,
            evals=mstate.evals + fitness.shape[0],
            nan_candidates=mstate.nan_candidates + count(torch.isnan, leaves),
            inf_candidates=mstate.inf_candidates + count(torch.isinf, leaves),
            nan_fitness=mstate.nan_fitness + count(torch.isnan, [fitness]),
            inf_fitness=mstate.inf_fitness + count(torch.isinf, [fitness]),
            best_key=torch.minimum(mstate.best_key, gen_best_key),
            best_generation=torch.where(improved, generations, mstate.best_generation),
            stagnation=torch.where(improved, 0, mstate.stagnation + 1).to(torch.int32),
            ring_best=upd(mstate.ring_best, gen_best_key * direction),
            ring_mean=upd(mstate.ring_mean, gen_mean),
            ring_diversity=upd(mstate.ring_diversity, diversity),
        )

    def post_step(self, mstate: TelemetryState, wf_state: Any) -> TelemetryState:
        """Mirror a GuardedAlgorithm's restarts and trigger, and a screening
        SurrogateWorkflow's true evaluations and fallback generations."""
        i32 = lambda v: torch.as_tensor(v, device=mstate.restarts.device).to(torch.int32)
        astate = getattr(wf_state, "algo", None)
        if hasattr(astate, "restarts") and hasattr(astate, "last_trigger"):
            mstate = mstate.replace(restarts=i32(astate.restarts),
                                    last_trigger=i32(astate.last_trigger))
        sur = getattr(wf_state, "sur", None)
        if hasattr(sur, "true_evals") and hasattr(sur, "fallback_gens"):
            mstate = mstate.replace(sur_true_evals=i32(sur.true_evals),
                                    sur_fallback_gens=i32(sur.fallback_gens))
        return mstate

    # --------------------------------------------------------------- getters
    def get_best_fitness(self, mstate: TelemetryState) -> torch.Tensor:
        """Best so far (one objective) or the ideal point, user direction."""
        direction = self.opt_direction[0] if self.num_objectives == 1 else self.opt_direction
        return mstate.best_key * direction

    def get_trajectory(self, mstate: TelemetryState) -> dict:
        """The last ``min(generations, capacity)`` generations, oldest first
        (a host read)."""
        count = int(mstate.generations)
        slots = ring_slots(count, self.capacity)
        best = mstate.ring_best.cpu().numpy()
        mean = mstate.ring_mean.cpu().numpy()
        div = mstate.ring_diversity.cpu().numpy()
        return {
            "generation": list(range(count - len(slots) + 1, count + 1)),
            "best": [best[s].tolist() for s in slots],
            "mean": [mean[s].tolist() for s in slots],
            "diversity": [float(div[s]) for s in slots],
        }

    def counter_tracks(self, mstate: TelemetryState) -> dict:
        """``{track: [(generation, value), ...]}`` for a trace exporter: the
        rings' generations, and stagnation, restarts and NaN fitness
        elements as one sample at the last generation."""
        traj = self.get_trajectory(mstate)
        gens = traj["generation"]
        tracks: dict = {}
        if self.num_objectives == 1:
            tracks["telemetry/best_fitness"] = list(zip(gens, traj["best"]))
            tracks["telemetry/mean_fitness"] = list(zip(gens, traj["mean"]))
        else:
            for j in range(self.num_objectives):
                tracks[f"telemetry/best_obj{j}"] = [(g, row[j]) for g, row in zip(gens, traj["best"])]
        tracks["telemetry/diversity"] = list(zip(gens, traj["diversity"]))
        last = int(mstate.generations)
        for name in ("stagnation", "restarts", "nan_fitness"):
            tracks[f"telemetry/{name}"] = [(last, int(getattr(mstate, name)))]
        return tracks

    # the integer counters: exact event counts, the same bits on any layout
    STABLE_SURFACE = (
        "generations", "evals", "nan_candidates", "inf_candidates", "nan_fitness", "inf_fitness",
        "best_generation", "stagnation", "restarts", "last_trigger", "sur_true_evals",
        "sur_fallback_gens",
    )

    def fingerprint(self, mstate: TelemetryState, stable: bool = False) -> str:
        """A host-side witness of the state's bits: SHA-256 over every
        field's path and exact bytes (the JAX package's form: equal states
        give equal hex in both packages), or with ``stable=True`` the
        attest digest of the integer counters alone."""
        if stable:
            from ..core.attest import digest_hex, host_state_digest

            return digest_hex(host_state_digest({n: getattr(mstate, n) for n in self.STABLE_SURFACE}))
        h = hashlib.sha256()
        for path, leaf in named_leaves(mstate):
            h.update(path.encode())
            h.update(np.ascontiguousarray(leaf.detach().cpu().numpy()).tobytes())
        return h.hexdigest()

    def report(self, mstate: TelemetryState) -> dict:
        """Every counter and the ring trajectory as strict JSON (non-finite
        values as ``None``)."""
        best = self.get_best_fitness(mstate).cpu().numpy()
        return sanitize_json({
            "generations": int(mstate.generations),
            "evals": int(mstate.evals),
            "best_fitness": best.tolist(),
            "best_generation": int(mstate.best_generation),
            "stagnation": int(mstate.stagnation),
            "nan_candidates": int(mstate.nan_candidates),
            "inf_candidates": int(mstate.inf_candidates),
            "nan_fitness": int(mstate.nan_fitness),
            "inf_fitness": int(mstate.inf_fitness),
            "restarts": int(mstate.restarts),
            "last_trigger": int(mstate.last_trigger),
            "sur_true_evals": int(mstate.sur_true_evals),
            "sur_fallback_gens": int(mstate.sur_fallback_gens),
            "capacity": self.capacity,
            "num_objectives": self.num_objectives,
            "trajectory": self.get_trajectory(mstate),
        })
