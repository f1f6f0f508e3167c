"""LineageMonitor — search-dynamics rings on the device: per-slot lineage,
operator attribution and convergence forensics; the port of
``evox_tpu/monitors/lineage.py``.

It answers which slot the current best descended from, which operator
earned each improvement, and why a run stalled. Everything is the ring
discipline of ``utils/ring.py``: fixed-shape ``(K, ...)`` buffers written
at ``count % K`` on the device, read back only by the getters.

Per generation it records:

- the **parent-index map** ``(K, width)``: which slot each survivor
  descended from. Algorithms that publish ``core/attribution.py``'s
  contract (the DE family) supply it exactly; everything else is tagged
  at the selection boundary (parent = slot identity).
- a per-candidate **operator tag** ``(K, width)`` from ``OP_NAMES``, and
  a cumulative per-operator credit ledger: attempts, successes,
  improvement mass.
- per-slot **age** (generations since the last improvement) and
  **improvement counters**.
- the per-generation **best-so-far delta** and best slot and fitness.
- an **epoch counter**: a ``GuardedAlgorithm``'s ``restarts`` counter is
  mirrored, and external callers may call :meth:`bump_epoch`; every ring
  row records its epoch, so :meth:`LineageMonitor.best_ancestry` never
  walks an edge across a restart.
- multi-objective runs (``num_objectives > 1``) also get **front-size**
  and **churn** rings: the rank-0 front of each generation's batch
  (``non_dominated_sort(until=1)``: one launch of the dominance kernel a
  generation on the card) and ``masked_igd`` between consecutive fronts.

The generation counter and the manual epoch count are host integers (the
host decides when a generation is recorded); every other field is a
tensor on the monitor's device, written with no host read. Not attaching
the monitor is an exact no-op on every other state of the workflow.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.attribution import (
    N_OPS,
    OP_INIT,
    OP_NAMES,
    Attribution,
    find_attribution,
    improvement_mass,
    op_credit,
    success_mask,
)
from ..core.device import DeviceLike, resolve_device
from ..core.instrument import sanitize_json
from ..core.monitor import Monitor
from ..core.struct import PyTreeNode, named_leaves
from ..metrics.igd import masked_igd
from ..utils.ring import ring_slots, ring_write

__all__ = ["LineageMonitor", "LineageState"]


class LineageState(PyTreeNode):
    count: int  # generations recorded
    epoch_extra: int  # manual bump_epoch count
    restarts_seen: torch.Tensor  # () int32, a guardrail's restarts mirrored
    best_key: torch.Tensor  # () float32, best so far in the minimising key
    # the per-operator credit ledger, cumulative
    ledger_attempts: torch.Tensor  # (N_OPS,) int32
    ledger_success: torch.Tensor  # (N_OPS,) int32
    ledger_improvement: torch.Tensor  # (N_OPS,) float32
    # width-dependent buffers, made by the first post_eval (its batch's
    # slot count is the width)
    cur_fit: Optional[torch.Tensor] = None  # (w,)
    prev_fit: Optional[torch.Tensor] = None  # (w,)
    age: Optional[torch.Tensor] = None  # (w,) int32
    improvements: Optional[torch.Tensor] = None  # (w,) int32
    ring_parent: Optional[torch.Tensor] = None  # (K, w) int32
    ring_op: Optional[torch.Tensor] = None  # (K, w) int32
    ring_best_slot: Optional[torch.Tensor] = None  # (K,) int32
    ring_best_fit: Optional[torch.Tensor] = None  # (K,) float32
    ring_delta: Optional[torch.Tensor] = None  # (K,) float32
    ring_epoch: Optional[torch.Tensor] = None  # (K,) int32
    # multi-objective extras
    cur_front: Optional[torch.Tensor] = None  # (w, m)
    cur_front_mask: Optional[torch.Tensor] = None  # (w,)
    prev_front: Optional[torch.Tensor] = None  # (w, m)
    prev_front_mask: Optional[torch.Tensor] = None  # (w,)
    ring_front_size: Optional[torch.Tensor] = None  # (K,) int32
    ring_churn: Optional[torch.Tensor] = None  # (K,) float32


class LineageMonitor(Monitor):
    """Lineage rings and the operator-attribution ledger, on the device.

    Args:
        history_capacity: ring size K: the last K generations' parent
            maps, operator tags, best slot, fitness, delta and epoch.
        num_objectives: fitness arity. ``m > 1`` adds the front-size and
            churn rings (a dominance pass over the batch and a ``(w, w)``
            distance matrix a generation: 400 MB at w = 10000).
        default_op: the ``OP_NAMES`` entry that tags candidates of
            algorithms without the attribution contract (``"sample"``,
            ``"velocity"``, ``"crossover"``, ``"mutation"``).
        device: where the state lives; ``None`` means ``"cuda"``.

    Fitness quantities are kept in the minimising key; the reports turn
    single-objective values back into the user's direction.
    """

    def __init__(self, history_capacity: int = 64, num_objectives: int = 1,
                 default_op: str = "sample", device: DeviceLike = None):
        if history_capacity < 1:
            raise ValueError(f"history_capacity must be >= 1, got {history_capacity}")
        if num_objectives < 1:
            raise ValueError(f"num_objectives must be >= 1, got {num_objectives}")
        if default_op not in OP_NAMES:
            raise ValueError(
                f"default_op {default_op!r} is not in the attribution vocabulary {OP_NAMES}")
        self.capacity = history_capacity
        self.num_objectives = num_objectives
        self.default_op = OP_NAMES.index(default_op)
        self.device = resolve_device(device)
        self.opt_direction = torch.ones((1,), device=self.device)

    def hooks(self):
        return ("post_eval", "post_step")

    def init(self, seed: Optional[int] = None) -> LineageState:
        dev = self.device
        return LineageState(
            count=0,
            epoch_extra=0,
            restarts_seen=torch.zeros((), dtype=torch.int32, device=dev),
            best_key=torch.full((), float("inf"), device=dev),
            ledger_attempts=torch.zeros((N_OPS,), dtype=torch.int32, device=dev),
            ledger_success=torch.zeros((N_OPS,), dtype=torch.int32, device=dev),
            ledger_improvement=torch.zeros((N_OPS,), device=dev),
        )

    # ----------------------------------------------------------- internals
    def _scalar_key(self, fitness: torch.Tensor) -> torch.Tensor:
        """Per-candidate minimising key: one objective flipped to the
        internal direction; several, their mean (only to pick a
        representative best slot and delta; the front rings carry the
        front's quality)."""
        if self.num_objectives == 1:
            return (fitness * self.opt_direction[0]).to(torch.float32)
        return torch.mean(fitness * self.opt_direction, dim=-1).to(torch.float32)

    def _fold_width(self, key_fit: torch.Tensor, width: int) -> torch.Tensor:
        """Fold a batch wider than the slots onto them (CoDE's ``3 * pop``
        trials, laid out ``(3, pop)``: a slot's best trial competes there);
        a narrower batch pads with inf."""
        w = key_fit.shape[0]
        if w == width:
            return key_fit
        if w % width == 0:
            return key_fit.reshape(-1, width).amin(dim=0)
        if w < width:
            return torch.nn.functional.pad(key_fit, (0, width - w), value=float("inf"))
        raise ValueError(
            f"lineage ring was sized by the first generation (width {width}); cannot fold a "
            f"batch of {w} (not a multiple). Evaluate the widest batch first or use a fresh "
            "monitor.")

    # ---------------------------------------------------------------- hooks
    def post_eval(self, mstate: LineageState, cand: Any, fitness: torch.Tensor) -> LineageState:
        m = self.num_objectives
        if m == 1 and fitness.ndim != 1:
            raise ValueError(
                f"LineageMonitor(num_objectives=1) got fitness of shape {tuple(fitness.shape)}; "
                f"pass num_objectives={fitness.shape[-1]} for multi-objective runs")
        if m > 1 and (fitness.ndim != 2 or fitness.shape[-1] != m):
            raise ValueError(
                f"LineageMonitor(num_objectives={m}) got fitness of shape {tuple(fitness.shape)}")
        key_fit = self._scalar_key(fitness)
        K, dev = self.capacity, key_fit.device
        if mstate.cur_fit is None:
            # the first batch sizes the slot axis
            width = key_fit.shape[0]
            mstate = mstate.replace(
                cur_fit=key_fit,
                prev_fit=torch.full((width,), float("inf"), device=dev),
                age=torch.zeros((width,), dtype=torch.int32, device=dev),
                improvements=torch.zeros((width,), dtype=torch.int32, device=dev),
                ring_parent=torch.zeros((K, width), dtype=torch.int32, device=dev),
                ring_op=torch.zeros((K, width), dtype=torch.int32, device=dev),
                ring_best_slot=torch.zeros((K,), dtype=torch.int32, device=dev),
                ring_best_fit=torch.full((K,), float("inf"), device=dev),
                ring_delta=torch.zeros((K,), device=dev),
                ring_epoch=torch.zeros((K,), dtype=torch.int32, device=dev),
            )
            if m > 1:
                mstate = mstate.replace(
                    cur_front=torch.zeros((width, m), device=dev),
                    cur_front_mask=torch.zeros((width,), dtype=torch.bool, device=dev),
                    prev_front=torch.zeros((width, m), device=dev),
                    prev_front_mask=torch.zeros((width,), dtype=torch.bool, device=dev),
                    ring_front_size=torch.zeros((K,), dtype=torch.int32, device=dev),
                    ring_churn=torch.zeros((K,), device=dev),
                )
        else:
            mstate = mstate.replace(cur_fit=self._fold_width(key_fit, mstate.cur_fit.shape[0]))
        if m > 1:
            if fitness.shape[0] != mstate.cur_front.shape[0]:
                raise ValueError(
                    "LineageMonitor MO rings need a constant batch width (sized "
                    f"{mstate.cur_front.shape[0]} by the first generation, got {fitness.shape[0]})")
            from ..operators.selection.non_dominate import non_dominated_sort

            # the batch's rank-0 front in the minimising convention
            key_obj = (fitness * self.opt_direction).to(torch.float32)
            finite = torch.isfinite(key_obj).all(dim=-1)
            rank = non_dominated_sort(torch.where(finite[:, None], key_obj, float("inf")),
                                      until=1)
            front_mask = (rank == 0) & finite
            mstate = mstate.replace(
                cur_front=torch.where(front_mask[:, None], key_obj, 0.0),
                cur_front_mask=front_mask,
            )
        return mstate

    def post_step(self, mstate: LineageState, wf_state: Any) -> LineageState:
        if mstate.cur_fit is None:  # post_eval never ran: nothing to record
            return mstate
        width = mstate.cur_fit.shape[0]
        cur, prev = mstate.cur_fit, mstate.prev_fit
        dev = cur.device
        astate = getattr(wf_state, "algo", None)
        attrib = find_attribution(astate)
        if attrib is not None and attrib.parent_idx.shape[0] != width:
            attrib = None  # a container reshaped the slots: fall back
        if attrib is None:
            # selection-boundary tagging: parent = the slot, success = the
            # slot's fitness improved on the previous generation's, and the
            # whole batch becomes the per-slot fitness
            succ = success_mask(cur, prev)
            tag = OP_INIT if mstate.count == 0 else self.default_op
            attrib = Attribution(
                parent_idx=torch.arange(width, dtype=torch.int32, device=dev),
                op_tag=torch.full((width,), tag, dtype=torch.int32, device=dev),
                success=succ,
                improvement=improvement_mass(cur, prev, succ),
            )
            new_fit = cur
        else:
            # the contract: a slot keeps its incumbent unless the candidate
            # succeeded
            new_fit = torch.where(attrib.success, cur, prev)
        # epoch: a guardrail's restarts mirrored, plus bump_epoch's count
        restarts = mstate.restarts_seen
        if hasattr(astate, "restarts"):
            restarts = torch.as_tensor(astate.restarts, device=dev).to(torch.int32)
        epoch = restarts + mstate.epoch_extra
        age = torch.where(attrib.success, 0, mstate.age + 1).to(torch.int32)
        improvements = mstate.improvements + attrib.success.to(torch.int32)
        attempts, successes, improvement = op_credit(attrib, N_OPS)
        # best-so-far delta (minimising key, monotone: delta >= 0)
        gen_best = torch.amin(new_fit)
        best_slot = torch.argmin(new_fit).to(torch.int32)
        new_best = torch.minimum(mstate.best_key, gen_best)
        delta = torch.where(torch.isfinite(mstate.best_key),
                            torch.clamp_min(mstate.best_key - new_best, 0.0),
                            torch.zeros_like(new_best))
        count = mstate.count
        mstate = mstate.replace(
            count=count + 1,
            restarts_seen=restarts,
            best_key=new_best,
            ledger_attempts=mstate.ledger_attempts + attempts,
            ledger_success=mstate.ledger_success + successes,
            ledger_improvement=mstate.ledger_improvement + improvement,
            prev_fit=new_fit,
            age=age,
            improvements=improvements,
            ring_parent=ring_write(mstate.ring_parent, attrib.parent_idx, count),
            ring_op=ring_write(mstate.ring_op, attrib.op_tag, count),
            ring_best_slot=ring_write(mstate.ring_best_slot, best_slot, count),
            ring_best_fit=ring_write(mstate.ring_best_fit, gen_best, count),
            ring_delta=ring_write(mstate.ring_delta, delta, count),
            ring_epoch=ring_write(mstate.ring_epoch, epoch, count),
        )
        if self.num_objectives > 1:
            churn = masked_igd(mstate.cur_front, mstate.cur_front_mask,
                               mstate.prev_front, mstate.prev_front_mask)
            front_size = mstate.cur_front_mask.sum(dtype=torch.int32)
            mstate = mstate.replace(
                prev_front=mstate.cur_front,
                prev_front_mask=mstate.cur_front_mask,
                ring_front_size=ring_write(mstate.ring_front_size, front_size, count),
                ring_churn=ring_write(mstate.ring_churn, churn, count),
            )
        return mstate

    # ------------------------------------------------------------- epoching
    def bump_epoch(self, mstate: LineageState) -> LineageState:
        """Advance the exploit epoch: a caller that changes the population
        between steps (an exploit, a recenter) calls this, so later ring
        rows are never read as descent from the slots before it."""
        return mstate.replace(epoch_extra=mstate.epoch_extra + 1)

    # --------------------------------------------------------------- getters
    def _chronology(self, mstate: LineageState):
        """(generation, slot) pairs on the host, oldest first."""
        slots = ring_slots(mstate.count, self.capacity)
        gens = list(range(mstate.count - len(slots) + 1, mstate.count + 1))
        return gens, slots

    def best_ancestry(self, mstate: LineageState) -> list:
        """The current best traced back through the window, newest first:
        ``{generation, slot, parent, op, epoch}`` each. The walk stops at
        the window's edge or an epoch boundary."""
        if mstate.ring_best_slot is None or mstate.count == 0:
            return []
        gens, slots = self._chronology(mstate)
        ring_parent = mstate.ring_parent.cpu().numpy()
        ring_op = mstate.ring_op.cpu().numpy()
        ring_best = mstate.ring_best_slot.cpu().numpy()
        ring_epoch = mstate.ring_epoch.cpu().numpy()
        chain = []
        slot = int(ring_best[slots[-1]])
        epoch = int(ring_epoch[slots[-1]])
        for gen, s in zip(reversed(gens), reversed(slots)):
            if int(ring_epoch[s]) != epoch:
                break  # a restart or exploit boundary: the lineage ends here
            parent = int(ring_parent[s][slot])
            chain.append({"generation": gen, "slot": slot, "parent": parent,
                          "op": OP_NAMES[int(ring_op[s][slot])], "epoch": int(ring_epoch[s])})
            slot = parent
        return chain

    def ledger(self, mstate: LineageState) -> dict:
        """The per-operator credit table; operators with no attempt are
        left out."""
        attempts = mstate.ledger_attempts.cpu().numpy()
        success = mstate.ledger_success.cpu().numpy()
        improvement = mstate.ledger_improvement.cpu().numpy()
        return {
            name: {"attempts": int(attempts[i]), "successes": int(success[i]),
                   "improvement": float(improvement[i])}
            for i, name in enumerate(OP_NAMES) if int(attempts[i]) > 0
        }

    def get_trajectory(self, mstate: LineageState) -> dict:
        """The window by generation: best slot, best fitness (the user's
        direction for one objective), delta and epoch; front size and
        churn for several objectives."""
        if mstate.ring_best_slot is None:
            return {"generation": [], "best_slot": [], "best_fitness": [], "delta": [],
                    "epoch": []}
        gens, slots = self._chronology(mstate)
        direction = float(self.opt_direction[0]) if self.num_objectives == 1 else 1.0
        best_slot = mstate.ring_best_slot.cpu().numpy()
        best_fit = mstate.ring_best_fit.cpu().numpy()
        delta = mstate.ring_delta.cpu().numpy()
        epoch = mstate.ring_epoch.cpu().numpy()
        out = {
            "generation": gens,
            "best_slot": [int(best_slot[s]) for s in slots],
            "best_fitness": [float(best_fit[s] * direction) for s in slots],
            "delta": [float(delta[s]) for s in slots],
            "epoch": [int(epoch[s]) for s in slots],
        }
        if self.num_objectives > 1:
            size = mstate.ring_front_size.cpu().numpy()
            churn = mstate.ring_churn.cpu().numpy()
            out["front_size"] = [int(size[s]) for s in slots]
            out["churn"] = [float(churn[s]) for s in slots]
        return out

    def counter_tracks(self, mstate: LineageState) -> dict:
        """``{track: [(generation, value), ...]}`` for a trace exporter."""
        traj = self.get_trajectory(mstate)
        gens = traj["generation"]
        tracks = {
            "search/best_fitness": list(zip(gens, traj["best_fitness"])),
            "search/delta": list(zip(gens, traj["delta"])),
            "search/epoch": list(zip(gens, traj["epoch"])),
        }
        if self.num_objectives > 1:
            tracks["search/front_size"] = list(zip(gens, traj["front_size"]))
            tracks["search/churn"] = list(zip(gens, traj["churn"]))
        return tracks

    def fingerprint(self, mstate: LineageState) -> str:
        """SHA-256 over every field's path and exact bytes: the witness of
        the run-against-step laws."""
        h = hashlib.sha256()
        for path, leaf in named_leaves(mstate):
            h.update(path.encode())
            data = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            h.update(np.ascontiguousarray(data).tobytes())
        return h.hexdigest()

    def search_report(self, mstate: LineageState) -> dict:
        """The ``search`` section of ``run_report()``, strict JSON
        (validated by ``tools/check_report.py``)."""
        width = int(mstate.cur_fit.shape[0]) if mstate.cur_fit is not None else 0
        age = mstate.age.cpu().numpy() if mstate.age is not None else np.zeros((0,), np.int32)
        restarts = int(mstate.restarts_seen)
        report = {
            "enabled": True,
            "generations": mstate.count,
            "capacity": self.capacity,
            "width": width,
            "num_objectives": self.num_objectives,
            "epoch": restarts + mstate.epoch_extra,
            "restarts": restarts,
            "ledger": self.ledger(mstate),
            "ancestry": self.best_ancestry(mstate),
            "age": {"max": int(age.max()) if age.size else 0,
                    "mean": float(age.mean()) if age.size else 0.0},
            "trajectory": self.get_trajectory(mstate),
        }
        return sanitize_json(report)

    def report(self, mstate: LineageState) -> dict:
        """The monitor-report protocol (``run_report``'s telemetry list)."""
        return self.search_report(mstate)
