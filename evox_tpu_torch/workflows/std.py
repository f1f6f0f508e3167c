"""StdWorkflow — the port of ``evox_tpu/workflows/std.py``.

One generation is ask → pop transforms → evaluate → direction flip →
(quarantine) → fit transforms → tell, with the 8 monitor hooks in the same
order as the JAX package. PyTorch runs eagerly, so ``step`` is a plain call
and ``run`` a Python loop over it (a CUDA graph over the loop is later work,
ROADMAP A3).

- A host problem (``jittable = False``, or ``external_problem=True``) is
  evaluated on the host: ``step`` copies the candidates there and the
  fitness back synchronously (``workflows/common.py``'s ``HostLink``), and
  ``run`` goes through ``run_host_pipelined``. ``step`` is
  ``pipeline_ask``, the evaluation and ``pipeline_tell``, so the pipelined
  run shares its hooks and their order.
- ``run(checkpointer=, resume_from=)`` snapshots between chunks and resumes
  (``workflows/checkpoint.py``); ``resume`` continues a crashed run.
- ``dtype_policy`` holds storage-annotated leaves in bfloat16 between
  generations (``core/dtype_policy.py``).
- ``run(restarts=IPOPRestarts(...))`` adds IPOP's population doubling
  between segments (``workflows/ipop.py``).

- ``mesh`` (a :class:`~evox_tpu_torch.core.distributed.Mesh` with a
  ``"pop"`` axis): the state is placed by its ``field(sharding=...)``
  annotations (:func:`~evox_tpu_torch.core.distributed.place_state`), the
  population must divide over the axis unless ``allow_uneven_shards``, and
  with ``eval_shard_map`` each shard scores its block of candidates on its
  own device and the fitness is gathered in mesh order. Row-independent
  problems give the unsharded fitness bit for bit. ``resume(state_sharding=)``
  places a restored snapshot by an explicit tree of shardings, and a
  snapshot taken on one mesh resumes on another (or on none, or on a mesh
  that spans processes).
- A population the algorithm returns resident (``ShardedES``: a
  ``ShardedTensor``) stays so: a problem on the device whose state has
  no leaf at all scores it block by block where the blocks lie (the law of
  ``eval_shard_map``), and only the ``(pop,)`` fitness is gathered. Any
  other problem, a pop transform, and the monitors that read the
  population take one explicit, counted ``.gather()``.
- On a mesh that spans processes (``create_pod_mesh``) every process runs
  the same workflow: a problem on the device only (a host problem is
  refused).

- ``migrate_helper``, a callable ``() -> (do_migrate, foreign_pop,
  foreign_fitness)`` polled once a generation after the tell: when
  ``do_migrate`` holds, ``algorithm.migrate`` takes the foreign rows (the
  JAX package's human-in-the-loop migration slot).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..core.algorithm import Algorithm
from ..core.device import DeviceLike, resolve_device
from ..core.distributed import gather_tree, place_state
from ..core.dtype_policy import DtypePolicy, apply_compute, apply_storage
from ..core.monitor import Monitor
from ..core.problem import Problem
from ..core.struct import PyTreeNode, static_field
from ..utils.common import parse_opt_direction, split_seed, tree_flatten
from .checkpoint import WorkflowCheckpointer, checkpointed_run, enter_run, restore_layouts
from .common import (
    HostLink,
    build_hook_table,
    check_mesh,
    finish_step,
    fused_run,
    host_evaluate,
    ingest_fitness,
    is_resident,
    quarantine_nonfinite,
    run_hooks,
    shard_map_evaluate,
    stateless,
    step_loop,
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
        external_problem: evaluate on the host (numpy in, numpy out);
            defaults to ``not problem.jittable``.
        dtype_policy: an optional :class:`~evox_tpu_torch.core.dtype_policy.
            DtypePolicy` (e.g. ``BF16_STORAGE``): ``field(storage=True)``
            float leaves are held in the storage dtype between generations
            and cast to the compute dtype at step entry. ``None`` changes
            nothing. Checkpoints hold the storage-dtype leaves, and the
            config guard refuses a restore under another policy.
        donate_carries: accepted for the JAX package's signature and
            changes no number. Donation there lets XLA reuse the carried
            state's buffers instead of copying the state at every dispatch;
            eager PyTorch makes no such copy, so there is nothing to remove.
            A CUDA graph over ``run`` (ROADMAP A3) is where it would act.
            ``run`` never changes the caller's state in place; with
            donation it runs its first generation through ``step``, as the
            JAX package does, so a recorder counts the same calls.
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
        allow_uneven_shards: bool = False,
        migrate_helper: Optional[Callable] = None,
        dtype_policy: Any = None,
        donate_carries: bool = False,
    ):
        if migrate_helper is not None and fit_transforms:
            raise ValueError("migrate_helper cannot be combined with fit_transforms: migrants "
                             "carry raw fitness while tell stores shaped values")
        if dtype_policy is not None and not isinstance(dtype_policy, DtypePolicy):
            raise TypeError(f"dtype_policy must be a DtypePolicy, got {type(dtype_policy).__name__}")
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
        self.external = (not getattr(problem, "jittable", True)) if external_problem is None \
            else bool(external_problem)
        self.host_link = HostLink(self.device) if self.external else None
        self.dtype_policy = dtype_policy
        self.donate_carries = bool(donate_carries)
        self.mesh = mesh
        self.eval_shard_map = bool(eval_shard_map)
        self.migrate_helper = migrate_helper
        check_mesh(mesh, algorithm, self.device, self.external, self.eval_shard_map,
                   allow_uneven_shards)
        self._ctor_args = dict(
            problem=problem, monitors=self.monitors, opt_direction=opt_direction,
            pop_transforms=self.pop_transforms, fit_transforms=self.fit_transforms,
            quarantine_nonfinite=quarantine_nonfinite, device=device,
            external_problem=self.external, dtype_policy=dtype_policy,
            donate_carries=donate_carries, mesh=mesh, eval_shard_map=eval_shard_map,
            allow_uneven_shards=allow_uneven_shards, migrate_helper=migrate_helper,
        )
        for m in self.monitors:
            m.set_opt_direction(self.opt_direction)
        self._hook_table = build_hook_table(self.monitors)

    def clone_with_algorithm(self, algorithm: Algorithm) -> "StdWorkflow":
        """A new workflow like this one but driving ``algorithm`` (the same
        problem and monitor objects): where IPOP's population growth
        rebuilds the workflow (``workflows/ipop.py``)."""
        return StdWorkflow(algorithm, **self._ctor_args)

    def analysis_targets(self, state: StdWorkflowState) -> dict:
        """Entry points for the cost analysis (``core/cost.py``):
        ``{name: (callable, example_args)}``, the code each entry point runs,
        unwrapped by any recorder.

        The steady state (``first_step=False``) is analysed: what every
        generation after the first runs. ``run`` is analysed at one
        generation, the unit the recorder's differenced slope measures. A
        host problem is analysed through the pipelined halves (what
        ``run_host_pipelined`` runs): ``pipeline_tell`` on the ctx of one
        ``pipeline_ask`` run here and a fitness of zeros of the problem's
        ``fit_shape``; the host ``evaluate`` between them is outside the
        analysis, as in the JAX package."""
        steady = state.replace(first_step=False) if state.first_step else state
        if self.external:
            cand, ctx = self._pipeline_ask_impl(steady)
            leaves = tree_flatten(cand)[0]  # a screening workflow adds its row count
            pop = next(x for x in leaves if isinstance(x, torch.Tensor)).shape[0]
            fitness = torch.zeros(self.problem.fit_shape(pop), device=self.device)
            return {
                "pipeline_ask": (self._pipeline_ask_impl, (steady,)),
                "pipeline_tell": (self._pipeline_tell_impl, (steady, ctx, fitness, steady.prob)),
            }
        return {
            "step": (self._step_impl, (steady,)),
            "run": (lambda s, n: step_loop(self, s, n), (steady, 1)),
        }

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> StdWorkflowState:
        seeds = split_seed(seed, 2 + len(self.monitors))
        state = StdWorkflowState(
            generation=0,
            algo=self.algorithm.init(seeds[0]),
            prob=self.problem.init(seeds[1]),
            monitors=tuple(m.init(s) for m, s in zip(self.monitors, seeds[2:])),
            first_step=True,
        )
        # storage-annotated leaves rest in the storage dtype from the first
        # state on; on a mesh, each leaf where its annotation puts it
        return place_state(apply_storage(state, self.dtype_policy), self.mesh)

    # ------------------------------------------------------------------ step
    def step(self, state: StdWorkflowState) -> StdWorkflowState:
        return self._step_impl(state)

    def run(
        self,
        state: StdWorkflowState,
        n_steps: int,
        checkpointer: Optional[WorkflowCheckpointer] = None,
        resume_from: Any = None,
        restarts: Any = None,
    ) -> StdWorkflowState:
        """Run ``n_steps`` generations (a Python loop over ``step``).

        A host problem runs through the executor's host pipeline
        (``run_host_pipelined``: equal to a ``step`` loop bit for bit); call
        it directly for ``on_generation`` and ``eval_chunk``.

        ``checkpointer=`` runs in chunks that end on its cadence and
        snapshots between them (the final state identical to the unchunked
        run's). ``resume_from=`` (a :class:`WorkflowCheckpointer` or a
        directory) restores the newest intact snapshot first; ``n_steps``
        then counts total generations, so a crashed run called again with
        the same arguments finishes the straight run.

        ``restarts=`` (an :class:`~evox_tpu_torch.core.guardrail.IPOPRestarts`;
        the algorithm must be a ``GuardedAlgorithm``) adds IPOP's population
        doubling: the run goes in segments on the policy's ``check_every``
        grid, the guarded state's counters are read between segments, and a
        restart since the last check rebuilds the workflow around a doubled
        population, best-so-far carried across (``workflows/ipop.py``). It
        composes with ``checkpointer``/``resume_from``: a resumed run first
        rebuilds the snapshot's population size.
        """
        if restarts is not None:
            if self.external:
                from .pipelined import run_host_pipelined

                return run_host_pipelined(self, state, n_steps, checkpointer=checkpointer,
                                          resume_from=resume_from, restarts=restarts)
            from .ipop import ipop_run

            return ipop_run(
                self, state, n_steps, restarts,
                segment=lambda w, s, c, ck: (checkpointed_run(w, s, c, ck) if ck is not None
                                             else fused_run(w, s, c)),
                checkpointer=checkpointer,
                resume_from=resume_from,
            )
        state, n_steps, checkpointer = enter_run(state, n_steps, checkpointer, resume_from,
                                                 expect_like=state, device=self.device)
        if self.external:
            from .pipelined import run_host_pipelined

            return run_host_pipelined(self, state, n_steps, checkpointer=checkpointer)
        if checkpointer is not None:
            return checkpointed_run(self, state, n_steps, checkpointer)
        return fused_run(self, state, n_steps)

    def resume(
        self,
        checkpointer: WorkflowCheckpointer,
        n_steps: int,
        fallback_state: Optional[StdWorkflowState] = None,
        state_sharding: Any = None,
        allow_config_mismatch: bool = False,
    ) -> StdWorkflowState:
        """Continue an interrupted checkpointed run to ``n_steps`` total
        generations: restore ``checkpointer``'s newest intact snapshot on
        this workflow's device (or start from ``fallback_state``, e.g. a
        fresh ``wf.init(seed)``, when there is none) and run the rest with
        checkpointing on. A snapshot written under another algorithm,
        population size or monitor set raises
        :class:`~evox_tpu_torch.workflows.checkpoint.CheckpointConfigError`
        unless ``allow_config_mismatch=True`` (the guard's reference is
        ``fallback_state``, else ``init(0)``). The snapshot is placed on
        this workflow's mesh by the state's annotations, or leaf by leaf by
        ``state_sharding`` (a tree of
        :class:`~evox_tpu_torch.core.distributed.NamedSharding` from
        ``state_sharding()``): a run saved on one mesh resumes on
        another."""
        expect_like = fallback_state if fallback_state is not None else self.init(0)
        state = checkpointer.latest(expect_like=expect_like,
                                    allow_config_mismatch=allow_config_mismatch)
        if state is None:
            if fallback_state is None:
                raise FileNotFoundError(
                    f"no usable checkpoint under {checkpointer.directory}; "
                    "pass fallback_state=wf.init(seed) to start fresh"
                )
            state = fallback_state
        else:
            state = restore_layouts(state, self.device, mesh=self.mesh,
                                    state_sharding=state_sharding)
        return self.run(state, max(n_steps - int(state.generation), 0),
                        checkpointer=checkpointer)

    def _use_init(self, state: StdWorkflowState) -> bool:
        return state.first_step and (
            self.algorithm.has_init_ask or self.algorithm.has_init_tell
        )

    def _dispatch_ask(self, state: StdWorkflowState) -> Tuple[Any, Any]:
        """First-step-aware ask: ``(pop, astate)``; the one dispatch point
        of the step and the sample/validate previews."""
        if self._use_init(state):
            return self.algorithm.init_ask(state.algo)
        return self.algorithm.ask(state.algo)

    def _ask_preview(self, state: StdWorkflowState) -> Any:
        # previews see the compute-dtype view the step itself asks on
        return self._dispatch_ask(apply_compute(state, self.dtype_policy))[0]

    def sample(self, state: StdWorkflowState) -> Any:
        """The population the algorithm would propose next, without
        advancing the workflow."""
        return self._ask_preview(state)

    def validate(
        self,
        state: StdWorkflowState,
        problem: Optional[Problem] = None,
        seed: Optional[int] = None,
        problem_state: Any = None,
    ) -> torch.Tensor:
        """Score the current population on ``problem`` without ``tell``:
        ask, transform, evaluate; no state advances and the fitness is not
        sign-flipped. ``problem`` defaults to the training problem; a
        validation problem's state is ``problem_state`` when given, else
        ``problem.init(seed)``."""
        problem = problem if problem is not None else self.problem
        cand = self._ask_preview(state)
        for t in self.pop_transforms:
            cand = t(cand)
        if problem_state is not None and problem is self.problem:
            raise ValueError("problem_state is only meaningful with an explicit validation problem")
        if problem is self.problem:
            fitness, _ = self._evaluate(state.prob, cand)
        else:
            pstate = problem_state if problem_state is not None else (
                problem.init(seed) if seed is not None else problem.init())
            fitness, _ = problem.evaluate(pstate, cand)
        return fitness

    def _run_hooks(self, name: str, mstates: list, *args: Any) -> None:
        run_hooks(self.monitors, self._hook_table, name, mstates, *args)

    def _flip(self, fitness: torch.Tensor) -> torch.Tensor:
        if fitness.ndim == 1:
            return fitness * self.opt_direction[0]
        return fitness * self.opt_direction

    def _evaluate(self, pstate: Any, cand: Any) -> Tuple[torch.Tensor, Any]:
        resident = is_resident(cand)
        if resident and not self.external and (self.eval_shard_map or stateless(pstate)):
            return shard_map_evaluate(self.problem, self.mesh, pstate, cand)
        if resident:
            cand = gather_tree(cand)
        if self.external:
            return host_evaluate(self.problem, self.host_link, pstate, cand)
        if self.eval_shard_map:
            return shard_map_evaluate(self.problem, self.mesh, pstate, cand)
        return self.problem.evaluate(pstate, cand)

    # ----------------------------------------------- pipelined step halves
    # The step split at the evaluation. ``step`` runs the two halves around
    # ``_evaluate``; run_host_pipelined runs them around its host
    # evaluation. One code path, so a pipelined run gives a wf.step loop's
    # states bit for bit.

    def pipeline_ask(self, state: StdWorkflowState) -> Tuple[Any, Any]:
        """``(candidates, ctx)``: everything before the evaluation."""
        return self._pipeline_ask_impl(state)

    def pipeline_tell(self, state: StdWorkflowState, ctx: Any, fitness: Any,
                      pstate: Any) -> StdWorkflowState:
        """Everything after the evaluation: takes ``pipeline_ask``'s ctx and
        the (fitness, problem state) of the evaluation; a numpy fitness is
        coerced to 32 bits and copied to the device."""
        return self._pipeline_tell_impl(state, ctx, fitness, pstate)

    # the halves' bodies: ``step`` and the analysis call these, so a
    # recorder on the public entry points counts only the caller's calls
    def _pipeline_ask_impl(self, state: StdWorkflowState) -> Tuple[Any, Any]:
        # storage -> compute at step entry: every reduction of the step runs
        # in the compute dtype
        state = apply_compute(state, self.dtype_policy)
        mstates = list(state.monitors)
        self._run_hooks("pre_step", mstates)
        self._run_hooks("pre_ask", mstates)
        pop, astate = self._dispatch_ask(state)
        if is_resident(pop) and (self.pop_transforms or any(
                self._hook_table[h] for h in ("post_ask", "pre_eval", "post_eval"))):
            pop = gather_tree(pop)  # a transform or a monitor reads the whole population
        self._run_hooks("post_ask", mstates, pop)
        cand = pop
        for t in self.pop_transforms:
            cand = t(cand)
        self._run_hooks("pre_eval", mstates, cand)
        return cand, (astate, tuple(mstates), cand)

    def _pipeline_tell_impl(self, state: StdWorkflowState, ctx: Any, fitness: Any,
                            pstate: Any) -> StdWorkflowState:
        astate, mstates_t, cand = ctx
        mstates = list(mstates_t)
        if not isinstance(fitness, torch.Tensor):
            fitness = self.host_link.to_device(fitness)
        self._run_hooks("post_eval", mstates, cand, fitness)
        fitness = self._flip(fitness)
        if self.quarantine_nonfinite:
            fitness = quarantine_nonfinite(fitness)
        astate = ingest_fitness(self, astate, mstates, fitness, self._use_init(state))
        # the carried algorithm state leaves the step at storage width
        astate = apply_storage(astate, self.dtype_policy)
        self._run_hooks("post_tell", mstates)
        new_state = state.replace(
            generation=state.generation + 1,
            algo=astate,
            prob=pstate,
            monitors=tuple(mstates),
            first_step=False,
        )
        return finish_step(self.monitors, self._hook_table, new_state)

    def _step_impl(self, state: StdWorkflowState) -> StdWorkflowState:
        cand, ctx = self._pipeline_ask_impl(state)
        fitness, pstate = self._evaluate(state.prob, cand)
        return self._pipeline_tell_impl(state, ctx, fitness, pstate)
