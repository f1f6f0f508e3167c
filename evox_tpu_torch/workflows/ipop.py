"""IPOP: increasing-population restarts between segments — the port of
``evox_tpu/workflows/ipop.py``.

:class:`~evox_tpu_torch.core.guardrail.GuardedAlgorithm` detects a
degenerate state and restarts at the same population size. The other half
of the IPOP recipe (Auger & Hansen 2005: each restart doubles λ) happens
here, on the host: ``StdWorkflow.run(restarts=policy)`` runs in segments
on the global ``policy.check_every`` grid, reads the guarded state's
counters at each boundary and, on a restart since the last check,
rebuilds the workflow around ``policy.make_algorithm(pop * growth)``.
Best-so-far (point and fitness) and the cumulative restart counter carry
across; the fresh state re-centers on the best point. Every doubling is
recorded in the caller's workflow's ``_ipop_events``.

Checkpointing: each segment runs under the
:class:`~evox_tpu_torch.workflows.checkpoint.WorkflowCheckpointer` as
usual, and the state is snapshotted right after every doubling. A resume
(:func:`resolve_ipop_resume`) first rebuilds the workflow at the
snapshot's population size, which ``GuardedState.pop_size`` records; a
crash before the post-doubling snapshot lands re-runs the segment from
the previous one and takes the same (deterministic) doubling again.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

from ..core.guardrail import GuardedState, IPOPRestarts, recenter_state
from ..utils.common import fold_in_seed
from .checkpoint import WorkflowCheckpointer, _as_checkpointer, restore_layouts

__all__ = ["grow_guarded", "ipop_run", "resolve_ipop_resume"]


def grow_guarded(fresh: GuardedState, old: GuardedState) -> GuardedState:
    """The population-growth surgery: a fresh guarded state at the grown λ,
    its inner algorithm re-centered on the old best-so-far point, best and
    restart bookkeeping carried across; the trigger that caused the growth
    is consumed (``checked_restarts`` catches up to ``restarts``)."""
    return fresh.replace(
        inner=recenter_state(fresh.inner, old.best_x),
        best_x=old.best_x,
        best_fitness=old.best_fitness,
        restarts=old.restarts,  # cumulative across the boundary
        checked_restarts=old.restarts,  # this trigger is consumed
    )


def _require_guarded(astate: Any) -> None:
    if not isinstance(astate, GuardedState):
        raise TypeError(
            "restarts=IPOPRestarts(...) needs the detector: wrap the algorithm in "
            f"GuardedAlgorithm (core/guardrail.py); the workflow state carries "
            f"{type(astate).__name__} instead"
        )


def resolve_ipop_resume(wf: Any, policy: IPOPRestarts, state: Any, n_steps: int,
                        resume_from: Any) -> Tuple[Any, Any, int, WorkflowCheckpointer]:
    """Restore the newest intact snapshot, on the workflow's device, and
    rebuild the workflow at the snapshot's (possibly doubled) population
    size. Returns ``(wf, state, remaining_steps, checkpointer)``."""
    ckpt = _as_checkpointer(resume_from)
    loaded = ckpt.latest()
    if loaded is not None:
        _require_guarded(loaded.algo)
        snap_pop = int(loaded.algo.pop_size)
        if snap_pop and snap_pop != int(wf.algorithm.pop_size):
            wf = wf.clone_with_algorithm(policy.make_algorithm(snap_pop))
        state = restore_layouts(loaded, wf.device)
    return wf, state, max(n_steps - int(state.generation), 0), ckpt


def _doublings_used(policy: IPOPRestarts, base_pop: int, cur_pop: int) -> int:
    if cur_pop <= base_pop:
        return 0
    return round(math.log(cur_pop / base_pop) / math.log(policy.growth))


def ipop_run(
    wf: Any,
    state: Any,
    n_steps: int,
    policy: IPOPRestarts,
    segment: Callable[[Any, Any, int, Optional[WorkflowCheckpointer]], Any],
    checkpointer: Optional[WorkflowCheckpointer] = None,
    resume_from: Any = None,
) -> Any:
    """Drive ``segment(wf, state, chunk, checkpointer) -> state`` (a run of
    ``chunk`` generations) under the IPOP policy, checking at every
    boundary of the global ``check_every`` grid. ``resume_from`` restores
    the newest snapshot first (:func:`resolve_ipop_resume`) and makes
    ``n_steps`` the total; its checkpointer stays on."""
    base_pop = int(wf.algorithm.pop_size)
    # every population the doubling schedule can reach must be buildable
    # now: a constructor's error belongs at entry, not at a boundary hours in
    for used in range(1, policy.max_restarts + 1):
        policy.make_algorithm(base_pop * policy.growth**used)
    # doublings are recorded on the caller's workflow (and every clone)
    events = list(getattr(wf, "_ipop_events", []))
    wf._ipop_events = events
    if resume_from is not None:
        wf, state, n_steps, resumed_ckpt = resolve_ipop_resume(wf, policy, state, n_steps,
                                                               resume_from)
        if checkpointer is None:
            checkpointer = resumed_ckpt
        # doublings before the crash happened in another process: one
        # summary entry says how far the schedule got
        snap_pop = int(state.algo.pop_size or base_pop)
        used = _doublings_used(policy, base_pop, snap_pop)
        if used > 0 and not events:
            events.append({
                "resumed": True,
                "generation": int(state.generation),
                "pop_size": snap_pop,
                "doublings": used,
                "handoff": policy.uses_handoff(snap_pop),
                "algorithm": type(wf.algorithm.algorithm).__name__,
            })
        wf._ipop_events = events
    _require_guarded(state.algo)

    # a resume that lands on a boundary takes that boundary's rule again
    # before running on, so a resumed run doubles where the straight one did
    remaining = n_steps
    while remaining > 0:
        if state.generation % policy.check_every == 0:
            wf, state = _maybe_double(wf, state, policy, base_pop, checkpointer)
        chunk = min(remaining, policy.check_every - state.generation % policy.check_every)
        state = segment(wf, state, chunk, checkpointer)
        remaining -= chunk
    return state


def _maybe_double(wf: Any, state: Any, policy: IPOPRestarts, base_pop: int,
                  checkpointer: Optional[WorkflowCheckpointer]) -> Tuple[Any, Any]:
    """The boundary rule: on a restart since the last check (or the
    policy's stagnation limit), rebuild the workflow at the grown
    population; else commit the baseline."""
    algo_state = state.algo
    used = _doublings_used(policy, base_pop, algo_state.pop_size or base_pop)
    triggered = algo_state.restarts > algo_state.checked_restarts
    if policy.stagnation_limit is not None:
        triggered = triggered or algo_state.stagnation >= policy.stagnation_limit
    if not triggered or used >= policy.max_restarts:
        if algo_state.restarts != algo_state.checked_restarts:
            state = state.replace(algo=algo_state.replace(checked_restarts=algo_state.restarts))
        return wf, state

    used += 1
    new_pop = base_pop * policy.growth**used
    events = wf._ipop_events  # shared with the caller's workflow
    algo2 = policy.make_algorithm(new_pop)
    wf = wf.clone_with_algorithm(algo2)
    events.append({
        "generation": state.generation,
        "pop_size": new_pop,
        "doublings": used,
        "handoff": policy.uses_handoff(new_pop),
        "algorithm": type(algo2.algorithm).__name__,
    })
    wf._ipop_events = events
    # the fresh state from the wrapper's restart stream, folded per doubling
    fresh = grow_guarded(algo2.init(fold_in_seed(algo_state.key, used)), algo_state)
    state = state.replace(algo=fresh, first_step=True)
    if checkpointer is not None:
        # the doubled state lands before anything runs on it, so a resume
        # rebuilds from GuardedState.pop_size (it replaces the segment's
        # snapshot of the same generation)
        checkpointer.save(state)
    return wf, state
