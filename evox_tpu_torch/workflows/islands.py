"""IslandWorkflow — multi-population evolution with ring migration; the
port of ``evox_tpu/workflows/islands.py``.

``n_islands`` populations of one algorithm evolve side by side and every
``migrate_every`` generations each island's best ``migrate_k`` candidates
of that generation move one island around the ring, ingested by
``algorithm.migrate`` (the base default covers ``(population, 1-d
fitness)`` states; PSO and the GA-skeleton MOEAs override it).

- The island states are **stacked** on a leading axis, as the JAX
  package's; ``ask``, ``tell`` and ``migrate`` each run once for all
  islands through ``torch.func.vmap`` (:func:`~evox_tpu_torch.core.
  members.member_call`), each island drawing from its own seed exactly as
  a solo run of that seed. Island ``i``'s seed comes from ``split_seed``,
  as its key from ``jax.random.split``. An algorithm with ``stackable =
  False`` runs its islands one by one (``member_route``).
- The candidates of all islands are scored as one flattened
  ``(islands * pop, ...)`` batch, and the fitness flipped to the internal
  minimization convention once, for ``tell`` and migration alike.
- Single-objective elites: one batched ``partial_topk`` over the
  ``(islands, pop)`` fitness (B4, one launch of a grid over the islands on
  the card; the JAX package's ``vmap`` of the kernel). Multi-objective
  elites: :func:`mo_elites` under ``vmap``, non-dominated rank (one batched
  B3 launch for all islands) with crowding distance as the tie-break,
  boundary points (+inf crowding) first.
- Whether a generation migrates is decided on the host's generation
  counter (the JAX package's ``lax.cond`` on a device counter).
- A host problem (``external_problem``, or a problem with ``jittable =
  False``) is evaluated on the calling thread over the flattened batch
  (``workflows/common.py``'s ``host_evaluate``: pinned copies, a CUDA
  event), where the JAX package goes through ``pure_callback``.
- ``dtype_policy`` holds the storage-annotated leaves of every island at
  storage width between generations, as :class:`StdWorkflow` does;
  ``donate_carries`` is accepted and changes no number (eager PyTorch
  makes no copy for it to remove), and ``run`` then peels its first
  generation through ``step`` as the JAX package does.
- ``run(checkpointer=, resume_from=)`` snapshots the stacked island
  states on the checkpoint cadence through the executor's ``run_fused``
  and resumes under the config guard, as :meth:`StdWorkflow.run` (a
  snapshot of the older tuple form is refused by name).

``mesh`` (a :class:`~evox_tpu_torch.core.distributed.Mesh` with a
``"pop"`` axis) lays the island axis over the mesh's ``"pop"`` axis: the
number of islands must divide over it, and the stacked state is placed
on the mesh (``place_pop``); the islands' one member call runs on the
mesh's first device. A mesh that spans processes is refused: islands over
distinct cards are ROADMAP A11's fourth part (a host problem under one
raises ``ValueError`` first, as in the JAX package). The JAX package's ``use_topk_kernel`` and ``topk_interpret``
have no counterpart: the tensor's device chooses, as in B4's wrapper.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..core.algorithm import Algorithm
from ..core.device import DeviceLike, resolve_device
from ..core.dtype_policy import apply_compute, apply_storage
from ..core.members import member_call, member_route, stack_states
from ..core.monitor import Monitor
from ..core.problem import Problem
from ..core.struct import PyTreeNode, static_field
from ..kernels.topk import partial_topk
from ..utils.common import lexsort, parse_opt_direction, split_seed, tree_flatten, tree_map
from .common import (
    HostLink,
    build_hook_table,
    finish_step,
    fused_run,
    host_evaluate,
    run_hooks,
    step_loop,
)


class IslandWorkflowState(PyTreeNode):
    generation: int
    algo: Any  # the island states, stacked on a leading island axis
    prob: Any
    monitors: Tuple[Any, ...] = ()
    first_step: bool = static_field(default=True)


def mo_elites(fitness: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` best rows of an island's ``(B, m)`` fitness:
    ascending non-dominated rank, and within a rank descending crowding
    distance, ties kept in index order (``jnp.lexsort((-crowd, rank))[:k]``:
    two stable sorts)."""
    from ..operators.selection.non_dominate import crowding_distance, non_dominated_sort

    rank = non_dominated_sort(fitness)
    crowd = crowding_distance(fitness)
    return lexsort((-crowd, rank))[:k]


class IslandWorkflow:
    """Evolve ``n_islands`` populations with ring migration.

    Args:
        algorithm: the per-island :class:`Algorithm` (every island runs the
            same hyperparameters; diversity comes from independent seeds).
            Must support ``migrate``.
        problem: shared :class:`Problem`; the candidates of all islands are
            scored as one flattened batch.
        n_islands: number of islands (at least 2).
        migrate_every: generations between migrations.
        migrate_k: individuals each island sends per migration.
        monitors: 8-hook monitors, as :class:`StdWorkflow`'s; the hooks see
            the flattened ``(islands * pop, ...)`` batch.
        opt_direction / pop_transforms: as :class:`StdWorkflow`'s;
            transforms see the flattened batch. ``fit_transforms`` is
            refused: shaped fitness is population-relative, while migrants
            carry raw fitness into the algorithm's state.
        num_objectives: fitness arity; above 1 the elites are chosen by
            rank and crowding (:func:`mo_elites`) and ingested through the
            algorithm's multi-objective ``migrate``.
        device: ``None`` means ``"cuda"``.
        external_problem: evaluate on the host (numpy in, numpy out);
            defaults to ``not problem.jittable``.
        dtype_policy: an optional :class:`~evox_tpu_torch.core.
            dtype_policy.DtypePolicy` (e.g. ``BF16_STORAGE``), as
            :class:`StdWorkflow`'s.
        donate_carries: accepted for the JAX package's signature; changes
            no number (:class:`StdWorkflow`'s argument says why).
    """

    def __init__(
        self,
        algorithm: Algorithm,
        problem: Problem,
        n_islands: int,
        migrate_every: int = 10,
        migrate_k: int = 1,
        monitors: Sequence[Monitor] = (),
        opt_direction: Any = "min",
        pop_transforms: Sequence[Callable] = (),
        fit_transforms: Sequence[Callable] = (),
        num_objectives: int = 1,
        device: DeviceLike = None,
        mesh: Any = None,
        external_problem: Optional[bool] = None,
        dtype_policy: Any = None,
        donate_carries: bool = False,
    ):
        if n_islands < 2:
            raise ValueError(f"need at least 2 islands, got {n_islands}")
        if migrate_every < 1 or migrate_k < 1:
            raise ValueError("migrate_every and migrate_k must be >= 1")
        if num_objectives < 1:
            raise ValueError(f"num_objectives must be >= 1, got {num_objectives}")
        if fit_transforms:
            raise ValueError(
                "fit_transforms cannot be combined with island migration: "
                "migrants carry raw fitness while tell stores shaped values"
            )
        self.device = resolve_device(device)
        for part in (algorithm, problem):
            dev = getattr(part, "device", None)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(
                    f"{type(part).__name__} runs on {dev}, the workflow on {self.device}")
        self.algorithm = algorithm
        self.problem = problem
        self.n_islands = n_islands
        self.num_objectives = num_objectives
        self.migrate_every = migrate_every
        self.migrate_k = migrate_k
        self.monitors = tuple(monitors)
        self.opt_direction = parse_opt_direction(opt_direction).to(self.device)
        for m in self.monitors:
            m.set_opt_direction(self.opt_direction)
        self._hook_table = build_hook_table(self.monitors)
        self.pop_transforms = tuple(pop_transforms)
        self.external = (not getattr(problem, "jittable", True)) if external_problem is None \
            else bool(external_problem)
        self.host_link = HostLink(self.device) if self.external else None
        self.dtype_policy = dtype_policy
        self.donate_carries = bool(donate_carries)
        self.mesh = mesh
        if mesh is not None:
            from ..core.distributed import POP_AXIS, mesh_spans_processes, require_single_process

            if self.external and mesh_spans_processes(mesh):
                raise ValueError(
                    "external (host) problems are single-process: under a mesh that spans "
                    "processes each process would evaluate its own islands against "
                    "unsynchronized host state; run islands on a process-local mesh")
            require_single_process(mesh, "IslandWorkflow(mesh=)")
            n_shards = mesh.shape.get(POP_AXIS, 1)
            if n_islands % n_shards:
                raise ValueError(f"n_islands {n_islands} is not divisible by the mesh's 'pop' "
                                 f"axis ({n_shards} shards)")
        #: ``"vmap"`` (one call for all islands) or ``"loop"`` (an algorithm
        #: with ``stackable = False``)
        self.member_route = member_route(algorithm)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> IslandWorkflowState:
        seeds = split_seed(seed, 2 + len(self.monitors))
        state = IslandWorkflowState(
            generation=0,
            algo=stack_states([self.algorithm.init(s)
                               for s in split_seed(seeds[1], self.n_islands)]),
            prob=self.problem.init(seeds[0]),
            monitors=tuple(m.init(s) for m, s in zip(self.monitors, seeds[2:])),
            first_step=True,
        )
        # the island states rest at storage width from the start, the
        # island axis over the mesh's "pop" axis
        state = apply_storage(state, self.dtype_policy)
        if self.mesh is None:
            return state
        from ..core.distributed import place_pop

        return state.replace(algo=place_pop(state.algo, self.mesh))

    # ------------------------------------------------------------------ step
    def step(self, state: IslandWorkflowState) -> IslandWorkflowState:
        return self._step_impl(state)

    def run(self, state: IslandWorkflowState, n_steps: int, checkpointer: Any = None,
            resume_from: Any = None) -> IslandWorkflowState:
        """Run ``n_steps`` generations (a Python loop over ``step``).

        ``checkpointer=`` runs in chunks that end on its cadence and
        snapshots the stacked island states between them on the
        executor's background lane; ``resume_from=`` (a
        :class:`~evox_tpu_torch.workflows.checkpoint.WorkflowCheckpointer`
        or a directory) restores the newest intact snapshot under the
        config guard first, and ``n_steps`` then counts total
        generations (:meth:`StdWorkflow.run`'s law)."""
        from .checkpoint import checkpointed_run, enter_run

        state, n_steps, checkpointer = enter_run(state, n_steps, checkpointer, resume_from,
                                                 expect_like=state, device=self.device)
        if checkpointer is not None:
            return checkpointed_run(self, state, n_steps, checkpointer)
        return fused_run(self, state, n_steps)

    def analysis_targets(self, state: IslandWorkflowState) -> dict:
        """Entry points for the cost analysis (see
        :meth:`StdWorkflow.analysis_targets`): the steady step and ``run`` at
        one generation. A host problem gives ``{}``: the island model has
        no pipelined halves."""
        if self.external:
            return {}
        steady = state.replace(first_step=False) if state.first_step else state
        return {
            "step": (self._step_impl, (steady,)),
            "run": (lambda s, n: step_loop(self, s, n), (steady, 1)),
        }

    def best(self, state: IslandWorkflowState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per-island best fitness, global best) in the user's convention
        (a maximization run's best comes back positive), from states
        carrying ``gbest_fitness``, ``pbest_fitness`` or ``fitness``.

        Multi-objective: per-objective minima, the per-island ideal points
        ``(islands, m)`` and the global ideal point ``(m,)``."""
        for name in ("gbest_fitness", "pbest_fitness", "fitness"):
            arr = getattr(state.algo, name, None)
            if arr is None:
                continue
            if self.num_objectives > 1:
                per_island = arr.reshape(self.n_islands, -1, self.num_objectives).amin(dim=1)
                return (per_island * self.opt_direction,
                        per_island.amin(dim=0) * self.opt_direction)
            per_island = arr.reshape(self.n_islands, -1).amin(dim=1)
            sign = self.opt_direction[0]
            return per_island * sign, per_island.amin() * sign
        raise NotImplementedError(f"{type(state.algo).__name__} exposes no fitness field")

    # ------------------------------------------------------------- internals
    def elites(self, fitness: torch.Tensor) -> torch.Tensor:
        """``(islands, migrate_k)`` indices of each island's elites in this
        generation's internal-convention fitness ``(islands, B[, m])``."""
        k = self.migrate_k
        if k > fitness.shape[1]:
            raise ValueError(
                f"migrate_k={k} exceeds the per-island candidate batch ({fitness.shape[1]})")
        if self.num_objectives > 1:
            # one batched sort for all islands (the sort's vmap rule)
            return torch.func.vmap(lambda f: mo_elites(f, k))(fitness)
        return partial_topk(fitness.to(torch.float32), k, device=fitness.device)[1].long()

    def _migrate(self, astates: Any, pop: Any, fitness: torch.Tensor) -> Any:
        """Ring migration of each island's elites: island i receives from
        island i - 1, all islands' ``migrate`` in one member call."""
        idx = self.elites(fitness)
        rows = torch.arange(self.n_islands, device=idx.device)[:, None]
        recv = tree_map(lambda c: torch.roll(c[rows, idx], 1, dims=0), pop)
        recv_fit = torch.roll(fitness[rows, idx], 1, dims=0)
        return member_call(self.algorithm.migrate, astates, recv, recv_fit,
                           route=self.member_route)

    def _evaluate(self, pstate: Any, cand_flat: Any) -> Tuple[torch.Tensor, Any]:
        if self.external:
            return host_evaluate(self.problem, self.host_link, pstate, cand_flat)
        return self.problem.evaluate(pstate, cand_flat)

    def _step_impl(self, state: IslandWorkflowState) -> IslandWorkflowState:
        # storage -> compute at step entry: the algorithm math runs at the
        # compute width
        state = apply_compute(state, self.dtype_policy)
        mstates = list(state.monitors)
        run_hooks(self.monitors, self._hook_table, "pre_step", mstates)
        run_hooks(self.monitors, self._hook_table, "pre_ask", mstates)

        use_init = state.first_step and (
            self.algorithm.has_init_ask or self.algorithm.has_init_tell)
        ask = self.algorithm.init_ask if use_init else self.algorithm.ask
        # (islands, B, ...) leaf by leaf
        pop, astates = member_call(ask, state.algo, route=self.member_route)
        batch = tree_flatten(pop)[0][0].shape[1]
        cand_flat = tree_map(lambda x: x.reshape((self.n_islands * batch,) + x.shape[2:]), pop)
        run_hooks(self.monitors, self._hook_table, "post_ask", mstates, cand_flat)
        for t in self.pop_transforms:
            cand_flat = t(cand_flat)

        run_hooks(self.monitors, self._hook_table, "pre_eval", mstates, cand_flat)
        raw_fitness, pstate = self._evaluate(state.prob, cand_flat)
        run_hooks(self.monitors, self._hook_table, "post_eval", mstates, cand_flat, raw_fitness)
        # the internal minimization convention, shared by tell and migration
        if self.num_objectives > 1:
            fitness = (raw_fitness * self.opt_direction).reshape(
                self.n_islands, batch, self.num_objectives)
        else:
            fitness = (raw_fitness * self.opt_direction[0]).reshape(self.n_islands, batch)

        run_hooks(self.monitors, self._hook_table, "pre_tell", mstates,
                  fitness.reshape((self.n_islands * batch,) + fitness.shape[2:]))
        tell = self.algorithm.init_tell if use_init else self.algorithm.tell
        astates = member_call(tell, astates, fitness, route=self.member_route)
        run_hooks(self.monitors, self._hook_table, "post_tell", mstates)

        gen = state.generation + 1
        if gen % self.migrate_every == 0:
            astates = self._migrate(astates, pop, fitness)
        # the carried island states leave the step at storage width
        astates = apply_storage(astates, self.dtype_policy)
        new_state = state.replace(
            generation=gen,
            algo=astates,
            prob=pstate,
            monitors=tuple(mstates),
            first_step=False,
        )
        return finish_step(self.monitors, self._hook_table, new_state)
