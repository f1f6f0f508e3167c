"""Plumbing shared by the workflow implementations — the port of parts of
``evox_tpu/workflows/common.py``."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..core.monitor import HOOK_NAMES, Monitor


def build_hook_table(monitors: Sequence[Monitor]) -> Dict[str, Tuple[int, ...]]:
    """name -> indices of the monitors implementing that hook."""
    return {
        name: tuple(i for i, m in enumerate(monitors) if name in m.hooks())
        for name in HOOK_NAMES
    }


def run_hooks(
    monitors: Sequence[Monitor],
    table: Dict[str, Tuple[int, ...]],
    name: str,
    mstates: list,
    *args: Any,
) -> None:
    """Dispatch one hook across monitors, updating ``mstates`` in place."""
    for i in table[name]:
        mstates[i] = getattr(monitors[i], name)(mstates[i], *args)


def finish_step(
    monitors: Sequence[Monitor],
    table: Dict[str, Tuple[int, ...]],
    new_state: Any,
) -> Any:
    """Run the ``post_step`` hooks against the otherwise-final workflow
    state, then fold their updated states back in."""
    mstates = list(new_state.monitors)
    run_hooks(monitors, table, "post_step", mstates, new_state)
    return new_state.replace(monitors=tuple(mstates))


def refuse_deferred(where: str, **arguments: Any) -> None:
    """Raise for each argument given whose port waits for the scale-out
    slice (``None`` and ``False`` mean not given)."""
    for name, value in arguments.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet (ROADMAP A11)"
            )


def fused_run(wf: Any, state: Any, n_steps: int) -> Any:
    """Shared ``run()`` body: ``n_steps`` generations as a plain Python loop
    over ``wf.step``. The JAX package fuses them into one compiled
    ``fori_loop``; capturing the loop as a CUDA graph is later work
    (ROADMAP A2)."""
    for _ in range(n_steps):
        state = wf.step(state)
    return state


def ingest_fitness(
    wf: Any,
    astate: Any,
    mstates: list,
    fitness: torch.Tensor,
    use_init: bool,
) -> Any:
    """The tell half once the fitness is final (sign-flipped, quarantined):
    fit_transforms → pre_tell hook → ``init_tell``/``tell`` dispatch. The
    JAX package's migrate cond and sharding boundary wait for ROADMAP A11."""
    for t in wf.fit_transforms:
        fitness = t(fitness)
    run_hooks(wf.monitors, wf._hook_table, "pre_tell", mstates, fitness)
    if use_init:
        return wf.algorithm.init_tell(astate, fitness)
    return wf.algorithm.tell(astate, fitness)


def quarantine_nonfinite(fitness: torch.Tensor) -> torch.Tensor:
    """Replace non-finite fitness entries with the worst FINITE value of the
    batch (internal minimization convention: the per-objective max). A
    column with no finite entry falls back to the dtype's largest finite
    value. Shape-preserving."""
    finite = torch.isfinite(fitness)
    neg_inf = torch.full_like(fitness, float("-inf"))
    worst = torch.amax(torch.where(finite, fitness, neg_inf), dim=0)
    big = torch.full_like(worst, torch.finfo(fitness.dtype).max)
    worst = torch.where(torch.isfinite(worst), worst, big)
    return torch.where(finite, fitness, worst)
