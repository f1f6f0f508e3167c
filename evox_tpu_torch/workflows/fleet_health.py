"""Per-tenant fault isolation for stacked fleets: signals and policy — the
port of ``evox_tpu/workflows/fleet_health.py``.

A :class:`~evox_tpu_torch.workflows.tenancy.VectorizedWorkflow` steps N
tenants as one fleet, so one tenant whose state goes non-finite would keep
riding in every later step. This module acts at the fleet's natural
boundary, between a :class:`~evox_tpu_torch.workflows.tenancy.RunQueue`'s
chunks:

- :func:`fleet_health_signals` reads the per-tenant signals the state
  already holds — a NaN scan over each tenant's algorithm tensors, the
  stacked :class:`~evox_tpu_torch.core.guardrail.GuardedState` trigger
  bitmask and restart and stagnation counters of a guarded fleet, and a
  TelemetryMonitor's stagnation and NaN counters — as one device
  computation and **one** host copy of the ``(N,)`` signals. The guard's
  counters are host integers in the port (``core/guardrail.py``), so they
  cost no copy.
- :class:`FleetHealthPolicy` maps the signals to slot actions, which
  ``RunQueue.step_chunk`` applies at every chunk boundary:

  * ``"freeze"`` — the slot's rows keep their pre-step values inside the
    fleet's step (a device ``torch.where`` on the frozen mask; host fields
    by the mask's host mirror), the slot parks with a forensic checkpoint
    and the fleet keeps its shape.
  * ``"evict"`` — checkpoint the tenant (``extract_tenant``) and refill
    the slot from the pending queue, or park it.
  * ``"restart"`` — a fresh ``init_tenant`` re-centred on the tenant's
    best-so-far by ``recenter_state``, its generation (the budget) kept;
    after ``max_restarts_per_slot`` the action escalates to ``"freeze"``.

Isolation law: healthy tenants' states are unchanged bit for bit by any
mix of actions on other slots — the member call is row-independent,
``insert_tenant`` writes one row, and the freeze select returns the
computed row unchanged for an unfrozen tenant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.guardrail import GuardedState, recenter_state
from ..core.members import MemberValues, n_members
from ..core.struct import named_leaves
from ..utils.common import fold_in_seed

__all__ = ["FleetHealthPolicy", "fleet_health_signals", "restarted_tenant"]

ACTIONS = ("freeze", "evict", "restart")


def _per_tenant_nan(tree: Any) -> torch.Tensor:
    """(N,) bool on the device: any NaN in a floating tensor of each
    tenant's slice. Inf is not counted: +inf sentinels are idiomatic (DE's
    unevaluated rows, the guardrail's initial best_fitness)."""
    flags = None
    for _, x in named_leaves(tree):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.ndim < 1:
            continue
        bad = torch.isnan(x).flatten(1).any(dim=1) if x.ndim > 1 else torch.isnan(x)
        flags = bad if flags is None else flags | bad
    if flags is None:
        raise ValueError("fleet state has no floating tenant-stacked leaves to scan")
    return flags


def _has_fields(state: Any, *names: str) -> bool:
    fields = getattr(state, "__dataclass_fields__", {})
    return all(n in fields for n in names)


def _host_column(value: Any, n: int) -> np.ndarray:
    """A stacked host counter as an ``(n,)`` int array (one value kept once
    when the members agree, else :class:`MemberValues`)."""
    values = list(value) if isinstance(value, MemberValues) else [value] * n
    return np.asarray([int(v) for v in values], dtype=np.int64)


def _signals_impl(tenants: Any) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]:
    """The device signals (each ``(N,)``) and the host ones of a
    tenant-stacked state. Which signals exist follows the state's
    structure (guarded? telemetry attached?)."""
    device: Dict[str, torch.Tensor] = {
        "generation": tenants.generation,
        "nonfinite": _per_tenant_nan(tenants.algo),
    }
    host: Dict[str, np.ndarray] = {}
    algo = tenants.algo
    if isinstance(algo, GuardedState):
        n = n_members(tenants)
        host["guard_trigger"] = _host_column(algo.last_trigger, n)
        host["guard_restarts"] = _host_column(algo.restarts, n)
        host["guard_stagnation"] = _host_column(algo.stagnation, n)
    for ms in tenants.monitors:
        if _has_fields(ms, "stagnation", "nan_fitness", "nan_candidates"):
            device["stagnation"] = ms.stagnation
            device["nan_fitness"] = ms.nan_fitness
            device["nan_candidates"] = ms.nan_candidates
            break
    return device, host


def fleet_health_signals(state: Any) -> Dict[str, np.ndarray]:
    """Per-tenant health signals of a ``VectorizedWorkflowState`` as host
    numpy arrays: one device computation and one copy to the host. Keys
    always present: ``generation`` (int32) and ``nonfinite`` (bool); plus
    ``guard_trigger``/``guard_restarts``/``guard_stagnation`` for guarded
    fleets and ``stagnation``/``nan_fitness``/``nan_candidates`` when a
    TelemetryMonitor rides along (int32, the JAX package's dtypes)."""
    device, host = _signals_impl(state.tenants)
    names = list(device)
    fetched = torch.stack([device[k].to(torch.int64) for k in names]).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for k, row in zip(names, fetched):
        out[k] = row.astype(bool) if k == "nonfinite" else row.astype(np.int32)
    out.update({k: v.astype(np.int32) for k, v in host.items()})
    return out


@dataclasses.dataclass
class FleetHealthPolicy:
    """Chunk-boundary policy mapping per-tenant signals to slot actions.

    Args:
        on_nonfinite: action when a tenant's algorithm state carries NaN
            (``"freeze"`` / ``"evict"`` / ``"restart"`` / None to ignore).
        on_trigger: action when a guarded fleet's trigger bitmask is
            nonzero (the guard already restarted the inner state; the
            policy can additionally evict or freeze the slot). Default
            None.
        stagnation_limit: generations without best-so-far improvement
            (TelemetryMonitor's counter, else the guard's) before
            ``on_stagnation`` fires. None disables.
        on_stagnation: action for stagnated tenants (default
            ``"restart"``).
        max_restarts_per_slot: in-place restarts a slot gets before a
            ``"restart"`` decision escalates to ``"freeze"``.

    ``decide`` returns ``(action, reason)`` or None per tenant; severity
    order is nonfinite > trigger > stagnation.
    """

    on_nonfinite: Optional[str] = "evict"
    on_trigger: Optional[str] = None
    stagnation_limit: Optional[int] = None
    on_stagnation: Optional[str] = "restart"
    max_restarts_per_slot: int = 2
    # a FlightRecorder (a RunQueue threads its own): every verdict counts
    # into the metrics plane by reason class; not part of the identity
    metrics: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        for name in ("on_nonfinite", "on_trigger", "on_stagnation"):
            action = getattr(self, name)
            if action is not None and action not in ACTIONS:
                raise ValueError(f"{name} must be one of {ACTIONS} or None, got {action!r}")
        if self.max_restarts_per_slot < 0:
            raise ValueError(
                f"max_restarts_per_slot must be >= 0, got {self.max_restarts_per_slot}")

    def may_freeze(self) -> bool:
        """Whether any decision can freeze a slot: the RunQueue then gives
        the fleet its frozen mask from the first step."""
        actions = {self.on_nonfinite, self.on_trigger, self.on_stagnation}
        return "freeze" in actions or "restart" in actions  # escalation

    def _resolve(self, action: str, slot_restarts: int) -> str:
        if action == "restart" and slot_restarts >= self.max_restarts_per_slot:
            return "freeze"
        return action

    def decide(self, row: Dict[str, Any], slot_restarts: int = 0) -> Optional[Tuple[str, str]]:
        """One tenant's verdict. ``row``: its slice of
        :func:`fleet_health_signals`; ``slot_restarts``: in-place restarts
        the slot has had."""
        if self.on_nonfinite is not None and bool(row.get("nonfinite")):
            return self._verdict(self._resolve(self.on_nonfinite, slot_restarts),
                                 "nonfinite_state")
        if self.on_trigger is not None and int(row.get("guard_trigger", 0)):
            return self._verdict(self._resolve(self.on_trigger, slot_restarts),
                                 f"guard_trigger:{int(row['guard_trigger'])}")
        if self.stagnation_limit is not None and self.on_stagnation is not None:
            stag = row.get("stagnation", row.get("guard_stagnation"))
            if stag is not None and int(stag) >= self.stagnation_limit:
                return self._verdict(self._resolve(self.on_stagnation, slot_restarts),
                                     f"stagnation:{int(stag)}")
        return None

    def _verdict(self, action: str, reason: str) -> Tuple[str, str]:
        if self.metrics is not None:
            # the reason class only: metric names stay low-cardinality
            self.metrics.count(f"fleet_health.{action}.{reason.split(':', 1)[0]}")
        return (action, reason)

    def report(self) -> dict:
        """The policy's configuration (``run_report``'s ``fleet_health``
        and the journal's ``start`` record)."""
        return {
            "on_nonfinite": self.on_nonfinite,
            "on_trigger": self.on_trigger,
            "stagnation_limit": self.stagnation_limit,
            "on_stagnation": self.on_stagnation,
            "max_restarts_per_slot": self.max_restarts_per_slot,
        }


def restarted_tenant(wf: Any, old_tenant: Any, spec_seed: int, fleet_generation: int,
                     hyperparams: Dict[str, Any]):
    """The in-place restart of a slot: a fresh tenant from a deterministic
    new seed (``fold_in_seed`` of the spec's seed with the fleet
    generation, so recovery replays it), re-centred on the old tenant's
    best-so-far by ``recenter_state`` when the fleet is guarded (the
    best-so-far pair carried over, the restart counter one up). The
    tenant's own generation counter is kept, so its budget keeps counting
    down."""
    fresh = wf.init_tenant(fold_in_seed(int(spec_seed), int(fleet_generation)), hyperparams)
    if wf.algorithm.has_init_ask or wf.algorithm.has_init_tell:
        fresh = wf._solo_peel(fresh)  # admission's law: the first generation peels solo
    old_algo = old_tenant.algo
    if (isinstance(old_algo, GuardedState) and isinstance(fresh.algo, GuardedState)
            and old_algo.best_x is not None):
        fresh = fresh.replace(algo=fresh.algo.replace(
            inner=recenter_state(fresh.algo.inner, old_algo.best_x),
            best_x=old_algo.best_x,
            best_fitness=old_algo.best_fitness,
            restarts=int(old_algo.restarts) + 1,
        ))
    return fresh.replace(generation=old_tenant.generation.clone())
