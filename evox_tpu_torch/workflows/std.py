"""StdWorkflow — the port of ``evox_tpu/workflows/std.py``.

One generation is ask → pop transforms → evaluate → direction flip →
(quarantine) → fit transforms → tell, with the 8 monitor hooks in the same
order as the JAX package. PyTorch runs eagerly, so ``step`` is a plain call
and ``run`` a Python loop over it (a CUDA graph over the loop is later work,
ROADMAP A2). ``run(restarts=IPOPRestarts(...))`` adds IPOP's population
doubling between segments (``workflows/ipop.py``). The JAX package's mesh,
host-callback, migration, dtype-policy, donation and checkpoint arguments
wait for ROADMAP A11: passing one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..core.algorithm import Algorithm
from ..core.device import DeviceLike, resolve_device
from ..core.monitor import Monitor
from ..core.problem import Problem
from ..core.struct import PyTreeNode, static_field
from ..utils.common import parse_opt_direction, split_seed
from .common import (
    build_hook_table,
    finish_step,
    fused_run,
    ingest_fitness,
    quarantine_nonfinite,
    refuse_deferred,
    run_hooks,
)


class StdWorkflowState(PyTreeNode):
    generation: int
    algo: Any
    prob: Any
    monitors: Tuple[Any, ...]
    first_step: bool = static_field(default=True)


class StdWorkflow:
    """Compose algorithm + problem + monitors into one generation step.

    Args:
        algorithm: an :class:`~evox_tpu_torch.core.Algorithm`.
        problem: a :class:`~evox_tpu_torch.core.Problem`.
        monitors: monitors implementing the 8-hook spec.
        opt_direction: ``"min"`` / ``"max"`` or a per-objective list; fitness
            is multiplied by the resulting ±1 vector before ``tell`` so
            algorithms always minimize.
        pop_transforms: applied to candidates before evaluation.
        fit_transforms: applied to the sign-flipped fitness before ``tell``
            (e.g. ``rank_based_fitness``).
        quarantine_nonfinite: replace NaN/±Inf fitness entries with the
            worst finite value of their generation after the sign flip;
            monitors' ``post_eval`` still sees the raw fitness.
        device: where the direction vector lives; ``None`` means ``"cuda"``.
            An algorithm or problem that names another device is refused.
    """

    def __init__(
        self,
        algorithm: Algorithm,
        problem: Problem,
        monitors: Sequence[Monitor] = (),
        opt_direction: Any = "min",
        pop_transforms: Sequence[Callable] = (),
        fit_transforms: Sequence[Callable] = (),
        quarantine_nonfinite: bool = False,
        device: DeviceLike = None,
        mesh: Any = None,
        external_problem: Optional[bool] = None,
        eval_shard_map: bool = False,
        migrate_helper: Optional[Callable] = None,
        dtype_policy: Any = None,
        donate_carries: bool = False,
    ):
        self._ctor_args = dict(
            problem=problem, monitors=monitors, opt_direction=opt_direction,
            pop_transforms=pop_transforms, fit_transforms=fit_transforms,
            quarantine_nonfinite=quarantine_nonfinite, device=device,
        )
        refuse_deferred(
            "StdWorkflow",
            mesh=mesh,
            external_problem=external_problem,
            eval_shard_map=eval_shard_map,
            migrate_helper=migrate_helper,
            dtype_policy=dtype_policy,
            donate_carries=donate_carries,
        )
        self.device = resolve_device(device)
        for part in (algorithm, problem):
            dev = getattr(part, "device", None)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(
                    f"{type(part).__name__} runs on {dev}, the workflow on "
                    f"{self.device}"
                )
        self.algorithm = algorithm
        self.problem = problem
        self.monitors = tuple(monitors)
        self.opt_direction = parse_opt_direction(opt_direction).to(self.device)
        self.pop_transforms = tuple(pop_transforms)
        self.fit_transforms = tuple(fit_transforms)
        self.quarantine_nonfinite = quarantine_nonfinite
        for m in self.monitors:
            m.set_opt_direction(self.opt_direction)
        self._hook_table = build_hook_table(self.monitors)

    def clone_with_algorithm(self, algorithm: Algorithm) -> "StdWorkflow":
        """A new workflow like this one but driving ``algorithm`` (the same
        problem and monitor objects): where IPOP's population growth
        rebuilds the workflow (``workflows/ipop.py``)."""
        return StdWorkflow(algorithm, **self._ctor_args)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> StdWorkflowState:
        seeds = split_seed(seed, 2 + len(self.monitors))
        return StdWorkflowState(
            generation=0,
            algo=self.algorithm.init(seeds[0]),
            prob=self.problem.init(seeds[1]),
            monitors=tuple(m.init(s) for m, s in zip(self.monitors, seeds[2:])),
            first_step=True,
        )

    # ------------------------------------------------------------------ step
    def step(self, state: StdWorkflowState) -> StdWorkflowState:
        return self._step_impl(state)

    def run(
        self,
        state: StdWorkflowState,
        n_steps: int,
        checkpointer: Any = None,
        resume_from: Any = None,
        restarts: Any = None,
    ) -> StdWorkflowState:
        """Run ``n_steps`` generations (a Python loop over ``step``).

        ``restarts=`` (an :class:`~evox_tpu_torch.core.guardrail.IPOPRestarts`;
        the algorithm must be a ``GuardedAlgorithm``) adds IPOP's population
        doubling: the run goes in segments on the policy's ``check_every``
        grid, the guarded state's counters are read between segments, and a
        restart since the last check rebuilds the workflow around a doubled
        population, best-so-far carried across (``workflows/ipop.py``).
        ``checkpointer=`` and ``resume_from=`` wait for ROADMAP A11.
        """
        refuse_deferred(
            "StdWorkflow.run",
            checkpointer=checkpointer,
            resume_from=resume_from,
        )
        if restarts is not None:
            from .ipop import ipop_run

            return ipop_run(self, state, n_steps, restarts, segment=fused_run)
        return fused_run(self, state, n_steps)

    def _dispatch_ask(self, state: StdWorkflowState) -> Tuple[bool, Any, Any]:
        """First-step-aware ask: ``(use_init, pop, astate)``."""
        use_init = state.first_step and (
            self.algorithm.has_init_ask or self.algorithm.has_init_tell
        )
        if use_init:
            pop, astate = self.algorithm.init_ask(state.algo)
        else:
            pop, astate = self.algorithm.ask(state.algo)
        return use_init, pop, astate

    def _run_hooks(self, name: str, mstates: list, *args: Any) -> None:
        run_hooks(self.monitors, self._hook_table, name, mstates, *args)

    def _flip(self, fitness: torch.Tensor) -> torch.Tensor:
        if fitness.ndim == 1:
            return fitness * self.opt_direction[0]
        return fitness * self.opt_direction

    def _evaluate(self, pstate: Any, cand: Any) -> Tuple[torch.Tensor, Any]:
        return self.problem.evaluate(pstate, cand)

    def _step_impl(self, state: StdWorkflowState) -> StdWorkflowState:
        mstates = list(state.monitors)
        self._run_hooks("pre_step", mstates)
        self._run_hooks("pre_ask", mstates)

        use_init, pop, astate = self._dispatch_ask(state)
        self._run_hooks("post_ask", mstates, pop)

        cand = pop
        for t in self.pop_transforms:
            cand = t(cand)

        self._run_hooks("pre_eval", mstates, cand)
        fitness, pstate = self._evaluate(state.prob, cand)
        self._run_hooks("post_eval", mstates, cand, fitness)

        fitness = self._flip(fitness)
        if self.quarantine_nonfinite:
            fitness = quarantine_nonfinite(fitness)
        astate = ingest_fitness(self, astate, mstates, fitness, use_init)
        self._run_hooks("post_tell", mstates)

        new_state = state.replace(
            generation=state.generation + 1,
            algo=astate,
            prob=pstate,
            monitors=tuple(mstates),
            first_step=False,
        )
        return finish_step(self.monitors, self._hook_table, new_state)
