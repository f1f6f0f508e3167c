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

The JAX package's crash-safe resume (``resolve_ipop_resume``, a
checkpointer that snapshots after every doubling) waits for ROADMAP A11:
it raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

from ..core.guardrail import GuardedState, IPOPRestarts, recenter_state
from ..utils.common import fold_in_seed

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
                        resume_from: Any) -> Tuple[Any, Any, int, Any]:
    """Resuming an IPOP run from a checkpoint waits for the checkpointer
    (ROADMAP A11)."""
    raise NotImplementedError("resuming an IPOP run is not ported yet (ROADMAP A11)")


def _doublings_used(policy: IPOPRestarts, base_pop: int, cur_pop: int) -> int:
    if cur_pop <= base_pop:
        return 0
    return round(math.log(cur_pop / base_pop) / math.log(policy.growth))


def ipop_run(
    wf: Any,
    state: Any,
    n_steps: int,
    policy: IPOPRestarts,
    segment: Callable[[Any, Any, int], Any],
) -> Any:
    """Drive ``segment(wf, state, chunk) -> state`` (a run of ``chunk``
    generations) under the IPOP policy, checking at every boundary of the
    global ``check_every`` grid."""
    base_pop = int(wf.algorithm.pop_size)
    # every population the doubling schedule can reach must be buildable
    # now: a constructor's error belongs at entry, not at a boundary hours in
    for used in range(1, policy.max_restarts + 1):
        policy.make_algorithm(base_pop * policy.growth**used)
    # doublings are recorded on the caller's workflow (and every clone)
    events = list(getattr(wf, "_ipop_events", []))
    wf._ipop_events = events
    _require_guarded(state.algo)

    remaining = n_steps
    while remaining > 0:
        if state.generation % policy.check_every == 0:
            wf, state = _maybe_double(wf, state, policy, base_pop)
        chunk = min(remaining, policy.check_every - state.generation % policy.check_every)
        state = segment(wf, state, chunk)
        remaining -= chunk
    return state


def _maybe_double(wf: Any, state: Any, policy: IPOPRestarts, base_pop: int) -> Tuple[Any, Any]:
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
    return wf, state.replace(algo=fresh, first_step=True)
