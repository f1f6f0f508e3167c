"""Multi-tenant run serving: stacked strategy fleets and a RunQueue — the
port of ``evox_tpu/workflows/tenancy.py``.

- :class:`VectorizedWorkflow` runs N instances of one algorithm (stacked
  hyperparameters, seeds and per-tenant problem and monitor states) as one
  fleet: the tenants' states are stacked on a leading tenant axis (the
  JAX package's layout) and each generation's ask and tell are one
  :func:`~evox_tpu_torch.core.members.member_call` for all tenants
  (``torch.func.vmap``; one call a tenant for an algorithm with
  ``stackable = False``, named by ``member_route``). Tenant ``i`` draws
  from its own seed exactly what a solo :class:`StdWorkflow` of that seed
  draws. Candidates of a problem without per-tenant state are scored as one
  flattened ``(tenants * pop, ...)`` batch; a problem state with tensors
  is evaluated under the member call.
- :class:`RunQueue` serves more searches than the fleet's width: it runs
  the fleet in chunks, retires tenants whose budget is spent, admits
  pending :class:`TenantSpec` s into the freed slots by state surgery at
  fixed shapes, evicts mid-run (a single-tenant checkpoint that a solo
  ``StdWorkflow`` resumes), meets deadlines by EDF admission and
  preemption, and with a journal (``workflows/journal.py``) recovers a
  crashed sweep from its newest chunk barrier.

Correctness contract: tenant ``i`` of a fleet reproduces a solo run of
the same (algorithm, seed, hyperparameters). On the CPU it is bit for bit
for the algorithms the tests hold (``torch.func.vmap`` turns a matrix
product into a batched one, which may round apart at the last ulp on the
card); the tests' tolerance is the JAX package's.

Hyperparameters are bound as attributes on a shallow copy of the template
(:func:`bind_hyperparams`), inside the member call as each tenant's 0-d
tensor slice: only values the algorithm reads as tensors in ``init``,
``ask`` or ``tell`` can vary per tenant.

``mesh=`` and ``rules=`` lay the fleet out on a (TENANT, POP) mesh
(``core/distributed.py``), a RunQueue's ``supervisor=`` dispatches its
chunks under a ``RunSupervisor``, and its ``health_policy=`` (a
``fleet_health.FleetHealthPolicy``) freezes, evicts or restarts unhealthy
tenants at chunk boundaries. ``release_continuation`` is the multi-pod
control plane's steal (``workflows/control_plane.py``): a ``steal`` record
that :meth:`RunQueue.recover` honours.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.algorithm import Algorithm
from ..core.attest import IntegrityError
from ..core.device import DeviceLike, resolve_device
from ..core.distributed import POP_AXIS, TENANT_AXIS, require_single_process
from ..core.dtype_policy import DtypePolicy, apply_compute, apply_storage
from ..core.members import (
    member_call,
    member_route,
    put_state,
    select_members,
    stack_states,
    take_state,
)
from ..core.monitor import Monitor
from ..core.problem import Problem
from ..core.struct import PyTreeNode, field, named_leaves, static_field
from ..utils.common import parse_opt_direction, split_seed, tree_flatten, tree_map
from .checkpoint import (
    CheckpointConfigError,
    WorkflowCheckpointer,
    checkpointed_run,
    enter_run,
    restore_layouts,
)
from .common import build_hook_table, fused_run, quarantine_nonfinite, run_hooks, step_loop
from .std import StdWorkflow, StdWorkflowState

__all__ = [
    "RunQueue",
    "TenantSpec",
    "TenantState",
    "VectorizedWorkflow",
    "VectorizedWorkflowState",
    "bind_hyperparams",
]


class TenantState(PyTreeNode):
    """One tenant's slice of the fleet (every tensor leaf tenant-stacked in
    the live :class:`VectorizedWorkflowState`): ``StdWorkflowState``'s
    (generation, algo, prob, monitors) plus the tenant's hyperparameter
    bindings. ``generation`` is the tenant's own counter, a 0-d int64
    tensor: it differs from the fleet's lockstep counter for tenants a
    RunQueue admitted mid-run."""

    generation: torch.Tensor
    algo: Any = None
    prob: Any = None
    monitors: Tuple[Any, ...] = ()
    hyperparams: Dict[str, Any] = field(default_factory=dict)


class VectorizedWorkflowState(PyTreeNode):
    generation: int  # the fleet steps in lockstep
    tenants: TenantState  # tensor leaves carry a leading (n_tenants,) axis
    # optional (n_tenants,) bool mask: a frozen tenant keeps its pre-step
    # slice; None steps every tenant
    frozen: Any = None
    first_step: bool = static_field(default=True)
    # the frozen slots as host integers, the mask's mirror: the step keeps
    # a frozen tenant's host fields (its seeds) without reading the mask
    frozen_rows: Tuple[int, ...] = static_field(default=())


def bind_hyperparams(template: Any, hp: Dict[str, Any]) -> Any:
    """A shallow copy of ``template`` with ``hp``'s (possibly dotted)
    attribute paths bound to the given values. Dotted paths copy each
    intermediate object (a ``GuardedAlgorithm``'s inner algorithm is copied
    before its attribute is rebound); the template is never mutated."""
    if not hp:
        return template
    root = copy.copy(template)
    fresh: Dict[str, Any] = {}
    for name, value in hp.items():
        obj = root
        parts = name.split(".")
        for depth, part in enumerate(parts[:-1]):
            prefix = ".".join(parts[: depth + 1])
            child = fresh.get(prefix)
            if child is None:
                child = copy.copy(getattr(obj, part))
                fresh[prefix] = child
                setattr(obj, part, child)
            obj = child
        setattr(obj, parts[-1], value)
    return root


def _tenant_seeds(seed: Any, n: int) -> List[int]:
    """One seed (split per tenant) or a sequence of ``n`` seeds, the form
    in which tenant ``i`` gets exactly its solo run's seed."""
    if isinstance(seed, (int, np.integer)):
        return split_seed(int(seed), n)
    seeds = [int(s) for s in seed]
    if len(seeds) != n:
        raise ValueError(f"got {len(seeds)} tenant seeds, expected n_tenants={n}")
    return seeds


def _check_fleet_mesh(mesh: Any, n_tenants: int, pop_size: Optional[int]) -> None:
    """The (TENANT, POP) mesh's checks, as the JAX package makes them; a
    mesh that spans processes is refused (tenants over distinct cards are
    ROADMAP A11's fourth part)."""
    require_single_process(mesh, "VectorizedWorkflow(mesh=)")
    if TENANT_AXIS not in mesh.axis_names:
        raise ValueError(
            f"VectorizedWorkflow mesh must carry a '{TENANT_AXIS}' axis (got axes "
            f"{tuple(mesh.axis_names)}); build it with create_mesh((TENANT_AXIS, POP_AXIS), "
            "devices=..., shape=(t, p))")
    t_shards = mesh.shape[TENANT_AXIS]
    if n_tenants % t_shards:
        raise ValueError(f"n_tenants {n_tenants} is not divisible by the mesh's "
                         f"'{TENANT_AXIS}' axis ({t_shards} shards)")
    p_shards = mesh.shape.get(POP_AXIS, 1)
    if pop_size is not None and pop_size % p_shards:
        raise ValueError(f"pop_size {pop_size} is not divisible by the mesh's '{POP_AXIS}' "
                         f"axis ({p_shards} shards)")


class VectorizedWorkflow:
    """N instances of one algorithm as one stacked fleet.

    Args:
        algorithm: the template :class:`Algorithm`. Shapes (``pop_size``,
            ``dim``) are shared by every tenant; per-tenant variation comes
            from ``hyperparams`` and the per-tenant seeds.
        problem: a problem evaluated on the device (``jittable``); each
            tenant gets its own problem state (``problem.init`` of its
            seed).
        n_tenants: the fleet's width.
        hyperparams: ``{name: stacked value}``, each with leading axis
            ``n_tenants``; ``name`` is an attribute (or dotted path, e.g.
            ``"algorithm.noise_stdev"`` through a ``GuardedAlgorithm``) of
            the template, bound per tenant as a 0-d tensor.
        monitors: shared monitor objects whose states are stacked per
            tenant. Monitors that read the host each generation
            (``uses_host_callbacks``: CheckpointMonitor, StepTimerMonitor,
            PopMonitor, EvalMonitor full histories) are refused.
        opt_direction / pop_transforms / fit_transforms /
        quarantine_nonfinite / num_objectives: as :class:`StdWorkflow`,
            per tenant.
        dtype_policy / donate_carries: as :class:`StdWorkflow`, over the
            stacked state.
        device: ``None`` means ``"cuda"``.
        mesh: a :class:`~evox_tpu_torch.core.distributed.Mesh` with a
            ``"tenant"`` axis (and usually a ``"pop"`` axis):
            ``create_mesh((TENANT_AXIS, POP_AXIS), devices=..., shape=(t,
            p))``. Each field's annotation shifts one axis right under the
            tenant axis (``P("pop")`` becomes ``P("tenant", "pop")``,
            ``P()`` becomes ``P("tenant")``); ``n_tenants`` must divide
            over the tenant axis and the pop size over the pop axis. The
            stacked state is placed on the mesh (``place_state``) and the
            fleet's member call runs on its first device.
        rules: ``[(regex, P), ...]`` overriding the annotations leaf by
            leaf (``match_partition_rules``), before the tenant shift.

    The JAX package's ``jit_step`` has no counterpart: eager PyTorch
    compiles nothing.
    """

    def __init__(
        self,
        algorithm: Algorithm,
        problem: Problem,
        n_tenants: int,
        hyperparams: Optional[Dict[str, Any]] = None,
        monitors: Sequence[Monitor] = (),
        opt_direction: Any = "min",
        pop_transforms: Sequence = (),
        fit_transforms: Sequence = (),
        mesh: Any = None,
        rules: Any = None,
        num_objectives: int = 1,
        quarantine_nonfinite: bool = False,
        dtype_policy: Optional[DtypePolicy] = None,
        donate_carries: bool = False,
        device: DeviceLike = None,
    ):
        if n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
        if not getattr(problem, "jittable", True):
            raise ValueError(
                "VectorizedWorkflow requires a problem evaluated on the device: a host "
                "problem cannot run inside the fleet's member call. Serve host problems "
                "one run at a time (run_host_pipelined).")
        for m in monitors:
            if getattr(m, "uses_host_callbacks", False):
                raise ValueError(
                    f"{type(m).__name__} reads the host each generation, which cannot run "
                    "inside the fleet's member call; use the device-side monitors for "
                    "per-tenant history (TelemetryMonitor rings, "
                    "EvalMonitor(history_capacity=K))")
        self.device = resolve_device(device)
        for part in (algorithm, problem):
            dev = getattr(part, "device", None)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(f"{type(part).__name__} runs on {dev}, the workflow on {self.device}")
        self.algorithm = algorithm
        self.problem = problem
        self.n_tenants = n_tenants
        self.monitors = tuple(monitors)
        self._opt_direction_arg = opt_direction
        self.opt_direction = parse_opt_direction(opt_direction).to(self.device)
        self.pop_transforms = tuple(pop_transforms)
        self.fit_transforms = tuple(fit_transforms)
        self.mesh = mesh
        self.rules = tuple(rules) if rules else None
        if mesh is not None:
            _check_fleet_mesh(mesh, n_tenants, getattr(algorithm, "pop_size", None))
        self.num_objectives = num_objectives
        self.quarantine_nonfinite = quarantine_nonfinite
        self.dtype_policy = dtype_policy
        self.donate_carries = bool(donate_carries)
        self.external = False
        #: ``"vmap"`` (one member call for all tenants) or ``"loop"``
        self.member_route = member_route(algorithm)
        self.hyperparams = self._check_hyperparams(hyperparams or {})
        for m in self.monitors:
            m.set_opt_direction(self.opt_direction)
        self._hook_table = build_hook_table(self.monitors)

    # ------------------------------------------------------------ hyperparams
    def _check_hp_name(self, name: str) -> None:
        obj = self.algorithm
        for part in name.split("."):
            if not hasattr(obj, part):
                raise ValueError(
                    f"hyperparams[{name!r}]: template {type(obj).__name__} has no attribute {part!r}")
            obj = getattr(obj, part)

    def _as_value(self, value: Any) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.to(self.device)

    def _check_hyperparams(self, hp: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        checked = {}
        for name, value in hp.items():
            self._check_hp_name(name)
            value = self._as_value(value)
            if value.ndim < 1 or value.shape[0] != self.n_tenants:
                raise ValueError(
                    f"hyperparams[{name!r}] must be stacked with leading axis "
                    f"n_tenants={self.n_tenants}, got shape {tuple(value.shape)}")
            checked[name] = value
        return checked

    def _bind(self, hp: Dict[str, Any]) -> Algorithm:
        return bind_hyperparams(self.algorithm, hp)

    def tenant_hyperparams(self, index: int, state: Optional[VectorizedWorkflowState] = None
                           ) -> Dict[str, np.ndarray]:
        """Tenant ``index``'s bindings as host values: the live state's (a
        RunQueue rebinds slots on admission) when given, else the
        constructor's."""
        source = state.tenants.hyperparams if state is not None else self.hyperparams
        return {name: value[index].detach().cpu().numpy() for name, value in source.items()}

    # ------------------------------------------------------------------ init
    def init(self, seed: Any = 0, hyperparams: Optional[Dict[str, Any]] = None
             ) -> VectorizedWorkflowState:
        """The fleet state. ``seed``: one int (split per tenant) or a
        sequence of ``n_tenants`` ints; tenant ``i`` starts exactly as
        ``StdWorkflow.init`` of its seed. ``hyperparams=`` overrides the
        constructor's stack (a RunQueue's start)."""
        hp = self.hyperparams if hyperparams is None else self._check_hyperparams(hyperparams)
        seeds = _tenant_seeds(seed, self.n_tenants)
        tenants = stack_states([
            self._build_tenant(s, {k: v[i] for k, v in hp.items()}) for i, s in enumerate(seeds)])
        state = VectorizedWorkflowState(generation=0, tenants=tenants, frozen=None,
                                        first_step=True)
        return self.place(apply_storage(state, self.dtype_policy))

    def _build_tenant(self, seed: int, hp: Dict[str, Any]) -> TenantState:
        """One tenant, split as ``StdWorkflow.init`` splits its seed."""
        algo = self._bind(hp)
        seeds = split_seed(seed, 2 + len(self.monitors))
        return TenantState(
            generation=torch.zeros((), dtype=torch.int64, device=self.device),
            algo=algo.init(seeds[0]),
            prob=self.problem.init(seeds[1]),
            monitors=tuple(m.init(s) for m, s in zip(self.monitors, seeds[2:])),
            hyperparams=dict(hp),
        )

    def init_tenant(self, seed: int, hyperparams: Optional[Dict[str, Any]] = None) -> TenantState:
        """A fresh single tenant (unstacked) with concrete ``hyperparams``:
        the RunQueue's admission path, split as :meth:`init` splits."""
        hp = {}
        for name, value in (hyperparams or {}).items():
            self._check_hp_name(name)
            hp[name] = self._as_value(value)
        return self._build_tenant(int(seed), hp)

    # ------------------------------------------------------------------ step
    def step(self, state: VectorizedWorkflowState) -> VectorizedWorkflowState:
        return self._step_impl(state)

    def run(self, state: VectorizedWorkflowState, n_steps: int,
            checkpointer: Optional[WorkflowCheckpointer] = None,
            resume_from: Any = None) -> VectorizedWorkflowState:
        """``n_steps`` fleet generations (``StdWorkflow.run``'s laws for the
        checkpointer and ``resume_from``, over the fleet state)."""
        state, n_steps, checkpointer = enter_run(state, n_steps, checkpointer, resume_from,
                                                 expect_like=state, device=self.device)
        if checkpointer is not None:
            return checkpointed_run(self, state, n_steps, checkpointer)
        return fused_run(self, state, n_steps)

    def analysis_targets(self, state: VectorizedWorkflowState) -> dict:
        """The steady fleet step and ``run`` at one generation (see
        :meth:`StdWorkflow.analysis_targets`): the roofline attributes the
        whole fleet's generation."""
        steady = state.replace(first_step=False) if state.first_step else state
        return {
            "step": (self._step_impl, (steady,)),
            "run": (lambda s, n: step_loop(self, s, n), (steady, 1)),
        }

    # ------------------------------------------------------------- internals
    def _filter_fitness(self, t: TenantState, fitness: torch.Tensor) -> torch.Tensor:
        """Per-tenant fitness filter between the quarantine and the fit
        transforms: the identity here; ``ElasticWorkflow`` overrides it with
        the inert-row padding mask."""
        return fitness

    def _flip(self, fitness: torch.Tensor) -> torch.Tensor:
        if fitness.ndim == 1:
            return fitness * self.opt_direction[0]
        return fitness * self.opt_direction

    def _tenant_ask(self, t: TenantState, use_init: bool):
        mstates = list(t.monitors)
        run_hooks(self.monitors, self._hook_table, "pre_step", mstates)
        run_hooks(self.monitors, self._hook_table, "pre_ask", mstates)
        algo = self._bind(t.hyperparams)
        pop, astate = (algo.init_ask if use_init else algo.ask)(t.algo)
        run_hooks(self.monitors, self._hook_table, "post_ask", mstates, pop)
        cand = pop
        for tr in self.pop_transforms:
            cand = tr(cand)
        run_hooks(self.monitors, self._hook_table, "pre_eval", mstates, cand)
        return cand, (astate, tuple(mstates))

    def _tenant_tell(self, t: TenantState, ctx: Any, cand: Any, fitness: torch.Tensor,
                     pstate: Any, use_init: bool) -> TenantState:
        astate, mstates_t = ctx
        mstates = list(mstates_t)
        run_hooks(self.monitors, self._hook_table, "post_eval", mstates, cand, fitness)
        fitness = self._flip(fitness)
        if self.quarantine_nonfinite:
            fitness = quarantine_nonfinite(fitness)
        # the per-tenant filter (ElasticWorkflow's inert rows): after the
        # quarantine, before the fit transforms, where its solo reference
        # applies it
        fitness = self._filter_fitness(t, fitness)
        for tr in self.fit_transforms:
            fitness = tr(fitness)
        run_hooks(self.monitors, self._hook_table, "pre_tell", mstates, fitness)
        algo = self._bind(t.hyperparams)
        astate = (algo.init_tell if use_init else algo.tell)(astate, fitness)
        run_hooks(self.monitors, self._hook_table, "post_tell", mstates)
        generation = t.generation + 1
        # post_step sees a solo view with the tenant's own generation
        hook_state = StdWorkflowState(generation=generation, algo=astate, prob=pstate,
                                      monitors=tuple(mstates), first_step=False)
        run_hooks(self.monitors, self._hook_table, "post_step", mstates, hook_state)
        return TenantState(generation=generation, algo=astate, prob=pstate,
                           monitors=tuple(mstates), hyperparams=t.hyperparams)

    def _evaluate(self, prob: Any, cand: Any) -> Tuple[torch.Tensor, Any]:
        """Fitness ``(tenants, pop[, m])``. A problem state with tensors is
        evaluated tenant by tenant in one member call; otherwise the
        candidates are scored as one flattened batch."""
        if _has_tensors(prob):
            return member_call(self.problem.evaluate, prob, cand)
        leaves, _ = tree_flatten(cand)
        n, b = leaves[0].shape[:2]
        flat = tree_map(lambda x: x.reshape((n * b,) + tuple(x.shape[2:])), cand)
        fitness, pstate = self.problem.evaluate(prob, flat)
        return fitness.reshape((n, b) + tuple(fitness.shape[1:])), pstate

    def _step_impl(self, state: VectorizedWorkflowState) -> VectorizedWorkflowState:
        state = apply_compute(state, self.dtype_policy)
        use_init = state.first_step and (self.algorithm.has_init_ask or self.algorithm.has_init_tell)
        tenants = state.tenants
        cand, ctx = member_call(lambda t: self._tenant_ask(t, use_init), tenants,
                                route=self.member_route)
        fitness, pstate = self._evaluate(tenants.prob, cand)
        told = member_call(
            lambda t, c, x, f, p: self._tenant_tell(t, c, x, f, p, use_init),
            tenants, ctx, cand, fitness, pstate,
            in_dims=(0, 0, 0, 0 if _has_tensors(pstate) else None), route=self.member_route)
        if state.frozen is not None and state.frozen_rows:
            # a frozen slot keeps its pre-step slice, an elementwise select
            # on the device mask; the others pass through bit for bit. With
            # no slot frozen (the mask's host mirror is empty) the select
            # would return every computed row unchanged, so it is skipped
            told = select_members(state.frozen, state.frozen_rows, tenants, told)
        tenants = apply_storage(told, self.dtype_policy)
        return state.replace(generation=state.generation + 1, tenants=tenants, first_step=False)

    def _solo_peel(self, t: TenantState) -> TenantState:
        """One first generation of a single unstacked tenant (the
        init_ask/init_tell the fleet's steady step never runs for one slot
        only)."""
        cand, ctx = self._tenant_ask(t, use_init=True)
        fitness, pstate = self.problem.evaluate(t.prob, cand)
        return self._tenant_tell(t, ctx, cand, fitness, pstate, use_init=True)

    def place_restored(self, state: VectorizedWorkflowState) -> Any:
        """A host-restored fleet snapshot on this workflow's device, and on
        its mesh by the tenant-shifted layout."""
        return self.place(restore_layouts(state, self.device))

    def place(self, state: Any) -> Any:
        """``state`` laid out on the fleet's mesh: each leaf by its rule or
        annotation shifted under the tenant axis (unchanged without a
        mesh)."""
        if self.mesh is None:
            return state
        from ..core.distributed import TENANT_AXIS, place_state

        return place_state(state, self.mesh, rules=self.rules, axis_prefix=TENANT_AXIS)

    def state_shardings(self, state: Any) -> Any:
        """The fleet state's per-leaf ``NamedSharding``: rules, then
        annotations, shifted under the tenant axis (``None`` without a
        mesh)."""
        if self.mesh is None:
            return None
        from ..core.distributed import TENANT_AXIS, state_sharding

        return state_sharding(state, self.mesh, rules=self.rules, axis_prefix=TENANT_AXIS)

    # ------------------------------------------------- eviction / admission
    def solo_workflow(self, index: Optional[int] = None,
                      hyperparams: Optional[Dict[str, Any]] = None, mesh: Any = None,
                      state: Optional[VectorizedWorkflowState] = None) -> StdWorkflow:
        """A single-tenant :class:`StdWorkflow` equal to fleet slot
        ``index`` (or to explicit ``hyperparams``): the template with the
        bindings (as 0-d tensors, as the fleet binds them), the same
        problem, monitors, transforms and dtype policy; the resume target
        of an evicted tenant's checkpoint. ``state=`` reads the live
        slot's bindings; ``mesh=`` is the solo workflow's mesh."""
        if hyperparams is None:
            hyperparams = self.tenant_hyperparams(index, state=state) if index is not None else {}
        algo = self._bind({k: self._as_value(v) for k, v in hyperparams.items()})
        return StdWorkflow(
            algo, self.problem, monitors=self.monitors, opt_direction=self._opt_direction_arg,
            pop_transforms=self.pop_transforms, fit_transforms=self.fit_transforms,
            quarantine_nonfinite=self.quarantine_nonfinite, device=self.device,
            dtype_policy=self.dtype_policy, donate_carries=self.donate_carries, mesh=mesh)

    def extract_tenant(self, state: VectorizedWorkflowState, index: int,
                       generation: Optional[int] = None) -> StdWorkflowState:
        """Tenant ``index`` as a solo ``StdWorkflowState``: what
        ``solo_workflow(index)`` would carry at this generation (checkpoint
        it and the solo workflow's ``resume_from=`` completes the run)."""
        t = take_state(state.tenants, int(index))
        gen = int(t.generation) if generation is None else int(generation)
        return StdWorkflowState(generation=gen, algo=t.algo, prob=t.prob, monitors=t.monitors,
                                first_step=False)

    def insert_tenant(self, state: VectorizedWorkflowState, index: int, solo_state: Any,
                      hyperparams: Optional[Dict[str, Any]] = None) -> VectorizedWorkflowState:
        """Write a solo tenant state (a ``StdWorkflowState`` or an unstacked
        :class:`TenantState`) into slot ``index`` at fixed shapes.
        ``hyperparams``: the slot's new bindings (default: a TenantState's
        own, else the slot's current ones)."""
        if hyperparams is not None:
            slot_hp = {k: self._as_value(v) for k, v in hyperparams.items()}
        elif isinstance(solo_state, TenantState):
            slot_hp = solo_state.hyperparams
        else:
            slot_hp = {k: v[index] for k, v in state.tenants.hyperparams.items()}
        gen = solo_state.generation
        new_t = TenantState(
            generation=torch.as_tensor(int(gen), dtype=torch.int64, device=self.device),
            algo=solo_state.algo, prob=solo_state.prob, monitors=solo_state.monitors,
            hyperparams=slot_hp)
        new_t = apply_storage(new_t, self.dtype_policy)
        slot = [(p, x) for p, x in named_leaves(state.tenants) if isinstance(x, torch.Tensor)]
        new = [(p, x) for p, x in named_leaves(new_t) if isinstance(x, torch.Tensor)]
        if len(slot) == len(new):
            for (path, stacked), (_, leaf) in zip(slot, new):
                want, got = tuple(stacked.shape[1:]), tuple(leaf.shape)
                if want != got:
                    raise ValueError(
                        f"insert_tenant: solo state leaf {path} has shape {got} but fleet "
                        f"slot {index} holds {want}: the tenant was built for another "
                        "shape (population size, dim or monitor capacity)")
        return state.replace(tenants=put_state(state.tenants, int(index), new_t))

    # --------------------------------------------------------------- freezing
    def with_freeze_mask(self, state: VectorizedWorkflowState) -> VectorizedWorkflowState:
        """The per-tenant frozen mask, all False."""
        if state.frozen is not None:
            return state
        return state.replace(frozen=torch.zeros((self.n_tenants,), dtype=torch.bool,
                                                device=self.device), frozen_rows=())

    def set_frozen(self, state: VectorizedWorkflowState, index: int, flag: bool
                   ) -> VectorizedWorkflowState:
        """Flip one slot's frozen bit (the mask must exist)."""
        if state.frozen is None:
            raise ValueError("fleet state has no frozen mask; materialize it with "
                             "with_freeze_mask(state) before the first step")
        frozen = state.frozen.clone()
        frozen[index] = bool(flag)
        rows = set(state.frozen_rows)
        (rows.add if flag else rows.discard)(int(index))
        return state.replace(frozen=frozen, frozen_rows=tuple(sorted(rows)))

    # -------------------------------------------------------------- reporting
    def monitor_reports(self, mstates: Tuple[Any, ...]) -> List[dict]:
        """Each reporting monitor's ``report()`` for one tenant's monitor
        states."""
        reports = []
        for j, mon in enumerate(self.monitors):
            if hasattr(mon, "report"):
                r = mon.report(mstates[j])
                r["monitor"] = type(mon).__name__
                reports.append(r)
        return reports

    def tenancy_report(self, state: VectorizedWorkflowState) -> dict:
        """``run_report``'s ``tenancy`` section: the fleet's shape, the
        leading axes of its algorithm leaves (the validator checks them
        against ``n_tenants``), each tenant's monitor reports, the member
        route, and a RunQueue's ``queue`` section."""
        from ..core.instrument import sanitize_json

        leading = {int(x.shape[0]) for _, x in named_leaves(state.tenants.algo)
                   if isinstance(x, torch.Tensor) and x.ndim >= 1}
        per_tenant = []
        for i in range(self.n_tenants):
            entry: dict = {"tenant": i}
            if self.monitors:
                reports = self.monitor_reports(take_state(state.tenants.monitors, i))
                if reports:
                    entry["monitors"] = reports
            per_tenant.append(entry)
        report = {
            "n_tenants": self.n_tenants,
            "generation": int(state.generation),
            "tenant_axis": TENANT_AXIS if self.mesh is not None else None,
            "leading_axes": sorted(leading),
            "member_route": self.member_route,
            "per_tenant": per_tenant,
        }
        queue = getattr(self, "_run_queue", None)
        if queue is not None and hasattr(queue, "report"):
            report["queue"] = queue.report()
        if queue is not None and hasattr(queue, "health_report"):
            health = queue.health_report()
            if health is not None:
                report["fleet_health"] = health
        return sanitize_json(report)


def _has_tensors(tree: Any) -> bool:
    """Whether ``tree`` (a problem state) holds a tensor."""
    return any(isinstance(x, torch.Tensor) for _, x in named_leaves(tree))


# --------------------------------------------------------------------- queue


@dataclasses.dataclass
class TenantSpec:
    """One queued search: an integer seed, concrete hyperparameter
    bindings (the fleet's names), a generation budget and an optional tag.
    ``pop`` (optional) is checked against the fleet's population size at
    ``submit()``. ``deadline`` (optional) is the SLA bound in fleet
    generations since the queue started: a deadlined spec is admitted in
    EDF order, and the queue may preempt the running tenant with the most
    remaining budget when waiting one more chunk would miss it."""

    seed: int
    n_steps: int
    hyperparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tag: Optional[str] = None
    pop: Optional[int] = None
    deadline: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    spec: TenantSpec
    active: bool = True
    frozen: bool = False


def _spec_from_record(rec: dict) -> TenantSpec:
    spec = TenantSpec(
        seed=int(rec["seed"]),
        n_steps=int(rec["n_steps"]),
        hyperparams={k: np.asarray(v) for k, v in (rec.get("hyperparams") or {}).items()},
        tag=rec.get("tag"),
        pop=int(rec["pop"]) if rec.get("pop") is not None else None,
        deadline=int(rec["deadline"]) if rec.get("deadline") is not None else None,
    )
    spec._journal_seq = int(rec["spec_seq"])
    if rec.get("grows"):
        # the elastic grow count bounds PopAutoscaler.max_grows across a
        # recovery: a scheduling input like pop and deadline
        spec._elastic_grows = int(rec["grows"])
    return spec


_CLOSE_KINDS = ("retire", "evict", "freeze", "preempt", "autoscale")


class RunQueue:
    """Admit and evict tenants through a fixed-width fleet.

    The fleet's width is fixed; the queue serves more searches than that
    by running the fleet in chunks and swapping retired tenants for
    pending specs between chunks (state surgery at fixed shapes).

    Args:
        workflow: a :class:`VectorizedWorkflow`; each admitted spec's
            bindings overwrite its slot. A workflow driven by an
            unfinished RunQueue is refused.
        chunk: generations a chunk (the admission and eviction grain); the
            chunk is shortened so that no tenant overshoots its budget.
        checkpoint_dir: every retirement, eviction and preemption writes a
            resumable single-tenant snapshot under ``<dir>/<tag or
            tenant_K>/``; defaults to ``<journal>/tenants`` with a journal.
        keep: snapshots kept a tenant directory.
        executor: the :class:`~evox_tpu_torch.core.executor.
            GenerationExecutor` that runs the chunks.
        journal: a :class:`~evox_tpu_torch.workflows.journal.RunJournal`
            (or a directory): every queue transition is journaled, and
            every chunk ends with a fleet snapshot on the executor's
            background lane and a ``chunk_complete`` barrier record;
            :meth:`recover` resumes a crashed sweep from it.
        metrics: a :class:`~evox_tpu_torch.workflows.flightrec.
            FlightRecorder` (or a directory) for the SLO ledger.
        attest: a :class:`~evox_tpu_torch.core.attest.StateAttestor` (or
            ``True``) pinning a digest of the fleet onto every barrier.
        supervisor: a :class:`~evox_tpu_torch.workflows.supervisor.
            RunSupervisor` under whose ladder every chunk is dispatched
            (``run_fused(supervisor=)``); each admission saves the fleet
            to its checkpointer, so its restore rung never brings back a
            fleet from before a tenant was admitted.
        health_policy: a :class:`~evox_tpu_torch.workflows.fleet_health.
            FleetHealthPolicy` evaluated at every chunk boundary: per-tenant
            signals to freeze, evict and restart actions (healthy tenants
            stay bit for bit untouched), each journaled as a ``health``
            record.
    """

    def __init__(self, workflow: VectorizedWorkflow, chunk: int = 10, supervisor: Any = None,
                 checkpoint_dir: Optional[str] = None, keep: int = 2, executor: Any = None,
                 journal: Any = None, health_policy: Any = None, metrics: Any = None,
                 attest: Any = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        from ..core.executor import GenerationExecutor
        from .journal import RunJournal

        prev = getattr(workflow, "_run_queue", None)
        if prev is not None and prev is not self and not getattr(prev, "finished", True):
            raise RuntimeError(
                "this VectorizedWorkflow is already driven by an unfinished RunQueue; drive "
                "it to completion (or build a second workflow) first")
        self.workflow = workflow
        self.chunk = chunk
        self.supervisor = supervisor
        self.health_policy = health_policy
        self.executor = executor if executor is not None else GenerationExecutor()
        if isinstance(journal, (str, Path)):
            journal = RunJournal(str(journal))
        self.journal = journal
        if checkpoint_dir is None and journal is not None:
            checkpoint_dir = str(journal.directory / "tenants")
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
        self.keep = keep
        self._fleet_ckpt = (WorkflowCheckpointer(str(journal.directory / "fleet"), every=1,
                                                 keep=max(2, keep))
                            if journal is not None else None)
        if isinstance(metrics, (str, Path)):
            from .flightrec import FlightRecorder

            metrics = FlightRecorder(directory=str(metrics))
        self.metrics = metrics
        if metrics is not None:
            workflow._flight_recorder = metrics
            if getattr(self.executor, "metrics", None) is None:
                self.executor.metrics = metrics
            cache = getattr(workflow, "_exec_cache", None)
            if cache is not None and getattr(cache, "metrics", None) is None:
                cache.metrics = metrics
            if health_policy is not None and getattr(health_policy, "metrics", None) is None:
                health_policy.metrics = metrics
        if attest is True:
            from ..core.attest import StateAttestor

            attest = StateAttestor(device=workflow.device)
        self.attest = attest
        self.integrity_events: List[dict] = []
        self.health_events: List[dict] = []
        self._slot_restarts: List[int] = [0] * workflow.n_tenants
        self._config_sha: Optional[str] = None
        self._spec_seq = 0
        self.finished = False
        self.pending: List[TenantSpec] = []
        self.continuations: List[dict] = []
        self._used_dirs: set = set()
        self.slots: List[Optional[_Slot]] = [None] * workflow.n_tenants
        self.state: Optional[VectorizedWorkflowState] = None
        self.results: List[dict] = []
        self.counters = {"submitted": 0, "admitted": 0, "retired": 0, "evicted": 0, "frozen": 0,
                         "restarted": 0, "preempted": 0, "readmitted": 0, "chunks": 0}
        workflow._run_queue = self  # run_report's tenancy.queue

    # ------------------------------------------------------------- lifecycle
    def _spec_record(self, spec: TenantSpec, seq: int) -> dict:
        rec = {
            "spec_seq": seq,
            "seed": int(spec.seed),
            "n_steps": int(spec.n_steps),
            "tag": spec.tag,
            "pop": int(spec.pop) if spec.pop is not None else None,
            "deadline": int(spec.deadline) if spec.deadline is not None else None,
            "hyperparams": {k: np.asarray(torch.as_tensor(v).cpu()).tolist()
                            for k, v in spec.hyperparams.items()},
        }
        grows = getattr(spec, "_elastic_grows", 0)
        if grows:
            rec["grows"] = int(grows)
        return rec

    def _validate_spec(self, spec: TenantSpec) -> None:
        if spec.n_steps < 1:
            raise ValueError(f"TenantSpec.n_steps must be >= 1, got {spec.n_steps}")
        if not isinstance(spec.seed, (int, np.integer)):
            raise TypeError(f"TenantSpec.seed must be an integer, got {type(spec.seed).__name__}")
        fleet_pop = getattr(self.workflow.algorithm, "pop_size", None)
        if spec.pop is not None and fleet_pop is not None and int(spec.pop) != int(fleet_pop):
            raise ValueError(
                f"TenantSpec.pop={spec.pop} does not match this fleet's pop_size={fleet_pop}: "
                "a fleet holds one population shape; build a fleet at the requested pop")
        if spec.deadline is not None:
            if spec.deadline < spec.n_steps:
                raise ValueError(
                    f"TenantSpec.deadline={spec.deadline} is infeasible: the spec needs "
                    f"n_steps={spec.n_steps} fleet generations even if admitted at once")
            if self.checkpoint_dir is None:
                raise ValueError(
                    "deadlined specs need a checkpoint_dir (or a journal): meeting a "
                    "deadline may preempt a running tenant, which parks it as a resumable "
                    "eviction checkpoint")
        if set(spec.hyperparams) != set(self.workflow.hyperparams):
            raise ValueError(
                f"spec hyperparams {sorted(spec.hyperparams)} must use exactly the fleet's "
                f"hyperparam names {sorted(self.workflow.hyperparams)}")

    def _journal_submit(self, spec: TenantSpec, **extra: Any) -> None:
        seq = self._spec_seq
        if self.journal is not None:
            self.journal.append("submit", **self._spec_record(spec, seq), **extra)
        spec._journal_seq = seq
        self._spec_seq += 1
        self.counters["submitted"] += 1
        self.finished = False

    def submit(self, spec: TenantSpec) -> None:
        """Queue a spec, validated here (and journaled before it is
        queued)."""
        self._validate_spec(spec)
        self._journal_submit(spec)
        self.pending.append(spec)

    def submit_resume(self, spec: TenantSpec, checkpoint: Optional[str] = None,
                      state: Any = None, done: Optional[int] = None) -> None:
        """Queue a continuation: a spec whose tenant resumes from a parked
        solo state (a checkpoint directory, or an in-memory state without a
        journal), admitted ahead of deadline-free pending work. ``done``:
        the generations completed at park time."""
        self._validate_spec(spec)
        if checkpoint is None and state is None:
            raise ValueError("submit_resume needs a checkpoint directory or an in-memory "
                             "solo state to resume from")
        if self.journal is not None and checkpoint is None:
            raise ValueError("a journaled queue requires continuations to name a durable "
                             "checkpoint (resume_from)")
        self._journal_submit(spec, resume_from=checkpoint,
                             done=int(done) if done is not None else None)
        self.continuations.append({"spec": spec, "seq": getattr(spec, "_journal_seq", None),
                                   "checkpoint": checkpoint, "state": state,
                                   "done": int(done) if done is not None else None})

    def release_continuation(self, seq: int) -> dict:
        """Release queued work (a parked continuation or a still-pending
        spec) that the multi-pod control plane
        (``workflows/control_plane.py``) stole: its submit is already
        durable in the target pod's journal (the write-ahead order of the
        elastic growth handoff: a crash between the two duplicates the
        work, which the plane's checkpoint and tag dedup heals, and never
        loses it). A ``steal`` record keeps :meth:`recover` from requeueing
        the seq here. Returns ``{seq, tag, checkpoint, done}``. Raises
        ``KeyError`` when no queued work carries ``seq`` (an active slot is
        preempted first, which parks a continuation), and ``ValueError``
        for an in-memory continuation on a journaled queue (nothing durable
        for the target pod to resume from)."""
        seq = int(seq)
        for i, c in enumerate(self.continuations):
            if c.get("seq") is not None and int(c["seq"]) == seq:
                if self.journal is not None and c.get("checkpoint") is None:
                    raise ValueError(
                        "a journaled queue cannot release an in-memory continuation: nothing "
                        "durable exists for the target pod to resume from")
                self.continuations.pop(i)
                desc = {"seq": seq, "tag": c["spec"].tag, "checkpoint": c.get("checkpoint"),
                        "done": c.get("done")}
                break
        else:
            for i, spec in enumerate(self.pending):
                if getattr(spec, "_journal_seq", None) == seq:
                    self.pending.pop(i)
                    desc = {"seq": seq, "tag": spec.tag, "checkpoint": None, "done": None}
                    break
            else:
                raise KeyError(f"no queued work (continuation or pending spec) carries journal "
                               f"seq {seq}")
        self.counters["stolen"] = self.counters.get("stolen", 0) + 1
        if self.journal is not None:
            self.journal.append("steal", spec_seq=seq, tag=desc["tag"],
                                checkpoint=desc["checkpoint"])
        if self.metrics is not None:
            self.metrics.event("queue.stolen", tag=desc["tag"], seq=seq)
        return desc

    def _stack_hp(self, hp_dicts: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
        # at the fleet's declared dtypes: a journaled integer comes back from
        # JSON as int64, and the recovered fleet must be the journaled one
        declared = self.workflow.hyperparams
        return {name: torch.stack([self.workflow._as_value(d[name]) for d in hp_dicts]).to(
            declared[name].dtype) for name in declared}

    def start(self) -> VectorizedWorkflowState:
        """Fill every slot and init the fleet."""
        from .checkpoint import state_config_fingerprint

        wf = self.workflow
        if self.state is not None:
            raise RuntimeError("RunQueue already started")
        total = len(self.pending) + len(self.continuations)
        if total < wf.n_tenants:
            raise ValueError(
                f"need at least n_tenants={wf.n_tenants} pending specs or parked "
                f"continuations to fill the fleet, have {total}")
        units = [self._take_next_unit() for _ in range(wf.n_tenants)]
        specs = [u if k == "spec" else u["spec"] for k, u in units]
        state = wf.init([int(s.seed) for s in specs],
                        hyperparams=self._stack_hp([s.hyperparams for s in specs]))
        if self.health_policy is not None and self.health_policy.may_freeze():
            state = wf.with_freeze_mask(state)  # from the first step on
        self._config_sha = state_config_fingerprint(state)
        if self.journal is not None:
            policy = self.health_policy
            self.journal.append(
                "start", config_sha=self._config_sha, n_tenants=wf.n_tenants, chunk=self.chunk,
                keep=self.keep, freeze_mask=state.frozen is not None,
                health_policy=policy.report() if policy is not None and hasattr(policy, "report")
                else None,
                checkpoint_dir=str(self.checkpoint_dir) if self.checkpoint_dir else None,
                slots=[getattr(s, "_journal_seq", None) for s in specs])
        self.state = state
        self.slots = [_Slot(spec=s) for s in specs]
        fresh = [i for i, (k, _) in enumerate(units) if k == "spec"]
        self.counters["admitted"] += len(fresh)
        if self.metrics is not None and fresh:
            self.metrics.count("slo.admissions", len(fresh))
        if self.journal is not None:
            for i in fresh:
                self.journal.append("admit", slot=i, spec_seq=getattr(specs[i], "_journal_seq", None),
                                    fleet_generation=0)
        for i, (k, u) in enumerate(units):
            if k == "cont":
                self._install(i, u["spec"], self._continuation_state(u), resumed=True)
        return self.state

    def _dispatch(self, n: int) -> None:
        running = sum(1 for s in self.slots if s is not None and s.active)
        self.state = self.executor.run_fused(self.workflow, self.state, n,
                                             supervisor=self.supervisor)
        self.counters["chunks"] += 1
        if self.metrics is not None:
            self.metrics.count("slo.tenant_gens", n * running)
            self.metrics.count("queue.chunks")

    def _tenant_generations(self) -> np.ndarray:
        """Each slot's own generation counter (one (N,) host read)."""
        return self.state.tenants.generation.cpu().numpy()

    def _sweep(self) -> np.ndarray:
        """Retire every active tenant at or over budget and refill idle
        slots, until stable. Returns the per-slot generation ledger."""
        changed = True
        gens = self._tenant_generations()
        while changed:
            changed = False
            for i, slot in enumerate(self.slots):
                if slot is not None and slot.active and gens[i] >= slot.spec.n_steps:
                    self._retire(i, status="completed")
                    changed = True
            for i, slot in enumerate(self.slots):
                if ((slot is None or not slot.active) and not (slot is not None and slot.frozen)
                        and (self.pending or self.continuations)):
                    self._refill(i)
                    changed = True
            if changed:
                gens = self._tenant_generations()
        return gens

    def step_chunk(self) -> bool:
        """One chunk: retire and refill, the SLA pass, the dispatch, and
        (with a journal) the chunk barrier. Returns True while work
        remains. Between calls is the legal window for :meth:`evict`."""
        if self.state is None:
            self.start()
        gens = self._sweep()
        gens = self._apply_sla(gens)
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None and s.active]
        if not active:
            self._finish()
            return False
        n = int(min(self.chunk, min(s.spec.n_steps - gens[i] for i, s in active)))
        self._dispatch(n)
        self._sweep()
        self._apply_health_policy()
        self._barrier()
        if self.metrics is not None:
            m = self.metrics
            m.set("queue.pending", len(self.pending))
            m.set("queue.continuations", len(self.continuations))
            m.set("queue.running", sum(1 for s in self.slots if s is not None and s.active))
            m.sample(queue=dict(self.counters), generation=int(self.state.generation))
        more = (any(s is not None and s.active for s in self.slots) or bool(self.pending)
                or bool(self.continuations))
        if not more:
            self._finish()
        return more

    def run(self) -> List[dict]:
        """Drive everything submitted so far to completion."""
        if self.state is None:
            self.start()
        while self.step_chunk():
            pass
        return self.results

    def _finish(self) -> None:
        if self.journal is not None:
            self.executor.drain_lane("fleet_snapshot")
        self.finished = True

    def _barrier(self) -> None:
        """The chunk barrier: the fleet snapshot on the executor's
        background lane, then the ``chunk_complete`` record with the
        queue's bookkeeping."""
        if self.journal is None:
            return
        state, ckpt = self.state, self._fleet_ckpt
        self.executor.submit_background("fleet_snapshot", lambda: ckpt.save(state),
                                        counter="bg_checkpoint")
        gen = int(state.generation)
        extra = {}
        if self.attest is not None:
            att_rec = self.attest.attestation(state)
            att_rec["generation"] = gen
            extra["attest"] = att_rec
        self.journal.append(
            "chunk_complete", generation=gen,
            snapshot=str(ckpt.directory / f"ckpt_{gen:08d}.pkl"), config_sha=self._config_sha,
            pending=[getattr(s, "_journal_seq", None) for s in self.pending],
            continuations=[{"seq": c.get("seq"), "checkpoint": c.get("checkpoint"),
                            "done": c.get("done")} for c in self.continuations],
            slots=[None if s is None else {"seq": getattr(s.spec, "_journal_seq", None),
                                           "active": s.active, "frozen": s.frozen}
                   for s in self.slots],
            counters=dict(self.counters), results_len=len(self.results),
            health_len=len(self.health_events), slot_restarts=list(self._slot_restarts), **extra)

    # ------------------------------------------------------- health policy
    def _apply_health_policy(self) -> None:
        """Evaluate the health policy at the chunk boundary and apply its
        per-slot actions: a function of the state and the slot table, so
        recovery replays the same verdicts."""
        if self.health_policy is None:
            return
        from .fleet_health import fleet_health_signals

        signals = fleet_health_signals(self.state)
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.active:
                continue
            row = {k: v[i] for k, v in signals.items()}
            verdict = self.health_policy.decide(row, self._slot_restarts[i])
            if verdict is None:
                continue
            action, reason = verdict
            event = {"health_seq": len(self.health_events), "chunk": self.counters["chunks"],
                     "slot": i, "tag": slot.spec.tag, "action": action, "reason": reason,
                     "generation": int(row["generation"])}
            if self.journal is not None:
                self.journal.append("health", **event)
            self.health_events.append(event)
            if self.metrics is not None:
                self.metrics.count(f"health.{action}")
            if action == "freeze":
                self._freeze(i)
            elif action == "evict":
                self.counters["evicted"] += 1
                self._close_out(i, status="evicted")
                # an evicted tenant is unhealthy: a slot left parked stops
                # its rows too
                self._mask_parked(i)
            elif action == "restart":
                self._restart_slot(i)

    def _freeze(self, index: int) -> None:
        """Quarantine a slot in place: close it out (forensic checkpoint and
        a ``"frozen"`` result), mask its rows in the fleet's step and park
        the slot, never refilled."""
        slot = self.slots[index]
        self.counters["frozen"] += 1
        self._close_out(index, status="frozen", refill=False)
        slot.frozen = True
        self.state = self.workflow.set_frozen(self.state, index, True)

    def _restart_slot(self, index: int) -> None:
        """Restart a slot in place (``recenter_state``, budget kept),
        deterministic in the spec and the fleet generation."""
        from .fleet_health import restarted_tenant

        slot = self.slots[index]
        old = take_state(self.state.tenants, index)
        fresh = restarted_tenant(self.workflow, old, slot.spec.seed, int(self.state.generation),
                                 slot.spec.hyperparams)
        self.state = self.workflow.insert_tenant(self.state, index, fresh)
        self._slot_restarts[index] += 1
        self.counters["restarted"] += 1

    def _mask_parked(self, index: int) -> None:
        """After an eviction whose slot could not be refilled, mask the
        parked slot's rows (when the fleet has a mask). Unlike a freeze the
        slot stays refillable: the next admission clears the bit."""
        slot = self.slots[index]
        if (slot is not None and not slot.active and not slot.frozen
                and self.state.frozen is not None):
            self.state = self.workflow.set_frozen(self.state, index, True)

    # ------------------------------------------------------- retire / evict
    def _tenant_dir(self, slot: _Slot, index: int) -> Optional[Path]:
        if self.checkpoint_dir is None:
            return None
        name = slot.spec.tag or (
            f"tenant_{self.counters['retired'] + self.counters['evicted']:04d}_slot{index}")
        if name in self._used_dirs:
            seq = 2
            while f"{name}_{seq}" in self._used_dirs:
                seq += 1
            name = f"{name}_{seq}"
        self._used_dirs.add(name)
        return self.checkpoint_dir / name

    def _close_out(self, index: int, status: str, refill: bool = True) -> dict:
        slot = self.slots[index]
        solo = self.workflow.extract_tenant(self.state, index)
        entry: dict = {"tag": slot.spec.tag, "slot": index, "status": status,
                       "generations": int(solo.generation), "budget": slot.spec.n_steps}
        tenant_dir = self._tenant_dir(slot, index)
        if tenant_dir is not None:
            ckpt = WorkflowCheckpointer(str(tenant_dir), every=max(int(solo.generation), 1),
                                        keep=self.keep)
            ckpt.save(solo)
            entry["checkpoint"] = str(tenant_dir)
        reports = self.workflow.monitor_reports(solo.monitors)
        if reports:
            entry["monitors"] = reports
        prints = [mon.fingerprint(solo.monitors[j]) for j, mon in enumerate(self.workflow.monitors)
                  if hasattr(mon, "fingerprint")]
        if prints:
            entry["fingerprints"] = prints
        entry["hyperparams"] = {k: np.asarray(v).tolist() for k, v in
                                self.workflow.tenant_hyperparams(index, state=self.state).items()}
        if self.metrics is not None:
            fleet_gen = int(self.state.generation)
            deadline = slot.spec.deadline
            if deadline is not None and status in ("completed", "evicted", "frozen"):
                if status == "completed" and fleet_gen <= int(deadline):
                    self.metrics.count("slo.deadline_hits")
                else:
                    self.metrics.count("slo.deadline_misses")
            self.metrics.event(f"queue.{status}", tag=slot.spec.tag, slot=index,
                               generations=entry["generations"])
            if status in ("evicted", "frozen"):
                entry["flight_recorder"] = self.metrics.tail(20)
        if self.journal is not None:
            kind = {"evicted": "evict", "frozen": "freeze", "preempted": "preempt",
                    "grown": "autoscale"}.get(status, "retire")
            self.journal.append(kind, result_seq=len(self.results),
                                spec_seq=getattr(slot.spec, "_journal_seq", None),
                                config_sha=self._config_sha, entry=entry)
        slot.active = False
        self.results.append(entry)
        if refill:
            self._refill(index)
        return entry

    def _retire(self, index: int, status: str) -> dict:
        self.counters["retired"] += 1
        return self._close_out(index, status)

    def evict(self, index: int) -> dict:
        """Evict slot ``index`` between chunks: its state is extracted as a
        solo snapshot (checkpointed when a directory is configured), the
        result recorded as ``"evicted"``, and the slot refilled (or parked
        when nothing is pending). Resume it with
        ``workflow.solo_workflow(hyperparams=...).run(..., resume_from=
        <checkpoint>)``."""
        if self.state is None:
            raise RuntimeError("RunQueue.evict before start(): the legal eviction window is "
                               "between step_chunk() calls")
        if not 0 <= index < len(self.slots):
            raise ValueError(f"slot index {index} out of range for a {len(self.slots)}-wide fleet")
        slot = self.slots[index]
        if slot is None or not slot.active:
            raise ValueError(f"slot {index} has no active tenant to evict")
        self.counters["evicted"] += 1
        entry = self._close_out(index, status="evicted")
        self._mask_parked(index)
        return entry

    @staticmethod
    def _edf_key(spec: TenantSpec):
        return (spec.deadline, getattr(spec, "_journal_seq", 0))

    def _fresh_tenant(self, spec: TenantSpec) -> TenantState:
        wf = self.workflow
        solo = wf.init_tenant(spec.seed, spec.hyperparams)
        if wf.algorithm.has_init_ask or wf.algorithm.has_init_tell:
            # a distinct first generation peels solo: the fleet's steady
            # step never runs init_ask/init_tell for one slot only
            solo = wf._solo_peel(solo)
        return solo

    def _continuation_state(self, cont: dict) -> Any:
        if cont.get("state") is not None:
            return cont["state"]
        from .checkpoint import _as_checkpointer

        solo = _as_checkpointer(cont["checkpoint"]).latest()
        if solo is None:
            raise RuntimeError(f"continuation checkpoint {cont['checkpoint']} holds no intact "
                               "snapshot: the parked tenant cannot be resumed")
        return restore_layouts(solo, self.workflow.device)

    def _refill(self, index: int) -> None:
        """Admit the next unit of work into a freed slot (or leave the slot
        parked: it steps in lockstep and its results are ignored)."""
        if not self.pending and not self.continuations:
            return
        kind, unit = self._take_next_unit()
        if kind == "spec":
            self._install(index, unit, self._fresh_tenant(unit), resumed=False)
        else:
            self._install(index, unit["spec"], self._continuation_state(unit), resumed=True)

    def _take_next_unit(self) -> Tuple[str, Any]:
        """The next unit under the priority ladder: EDF across all
        deadlined work, then parked continuations FIFO, then pending FIFO."""
        dl_cont = [c for c in self.continuations if c["spec"].deadline is not None]
        best_c = min(dl_cont, key=lambda c: self._edf_key(c["spec"])) if dl_cont else None
        dl_pend = [s for s in self.pending if s.deadline is not None]
        best_p = min(dl_pend, key=self._edf_key) if dl_pend else None
        if best_c is not None and (best_p is None
                                   or self._edf_key(best_c["spec"]) < self._edf_key(best_p)):
            self.continuations.remove(best_c)
            return ("cont", best_c)
        if self.pending and (best_p is not None or not self.continuations):
            if best_p is not None:
                self.pending.remove(best_p)
                return ("spec", best_p)
            return ("spec", self.pending.pop(0))
        return ("cont", self.continuations.pop(0))

    def _install(self, index: int, spec: TenantSpec, solo: Any, resumed: bool) -> None:
        wf = self.workflow
        hp = spec.hyperparams if resumed else None
        self.state = wf.insert_tenant(self.state, index, solo, hyperparams=hp)
        if self.state.frozen is not None:
            self.state = wf.set_frozen(self.state, index, False)
        self.slots[index] = _Slot(spec=spec)
        self._slot_restarts[index] = 0
        self.counters["admitted"] += 1
        if resumed:
            self.counters["readmitted"] += 1
        if self.metrics is not None:
            self.metrics.count("slo.admissions")
            if resumed:
                self.metrics.count("queue.readmissions")
        if self.journal is not None:
            self.journal.append("admit", slot=index, spec_seq=getattr(spec, "_journal_seq", None),
                                fleet_generation=int(self.state.generation), resumed=resumed)
        # the supervisor's newest snapshot must hold the admitted tenant:
        # a restore would otherwise bring back the fleet from before it
        ckpt = getattr(self.supervisor, "checkpointer", None)
        if ckpt is not None:
            ckpt.save(self.state)

    # ------------------------------------------------------ SLA scheduling
    def _apply_sla(self, gens: np.ndarray) -> np.ndarray:
        """Deadline-weighted admission and preemption before each chunk,
        in fleet generations (never wall clock), so recovery replays the
        same decisions: a deadlined unit that could not meet its deadline
        after waiting one more chunk is admitted now, preempting the
        running tenant with the most remaining budget that is not itself
        deadline-tight (parked as an eviction checkpoint and resubmitted
        as a continuation)."""
        units = sorted(
            [("pending", s, s) for s in self.pending if s.deadline is not None]
            + [("cont", c, c["spec"]) for c in self.continuations
               if c["spec"].deadline is not None],
            key=lambda u: self._edf_key(u[2]))
        if not units:
            return gens
        fleet_gen = int(self.state.generation)
        for kind, unit, spec in units:
            if kind == "pending":
                remaining_hi = remaining_lo = spec.n_steps
            elif unit.get("done") is not None:
                remaining_hi = remaining_lo = max(spec.n_steps - int(unit["done"]), 1)
            else:
                remaining_hi, remaining_lo = spec.n_steps, 1
            if fleet_gen + remaining_lo > spec.deadline:
                continue  # provably missed: stays queued best-effort
            if fleet_gen + self.chunk + remaining_hi <= spec.deadline:
                continue  # can still wait one chunk
            victim = self._preempt_victim(gens, fleet_gen)
            if victim is None:
                continue
            self._preempt(victim)
            if kind == "pending":
                self.pending.remove(unit)
                self._install(victim, spec, self._fresh_tenant(spec), resumed=False)
            else:
                self.continuations.remove(unit)
                self._install(victim, spec, self._continuation_state(unit), resumed=True)
            gens = self._tenant_generations()
        return gens

    def _preempt_victim(self, gens: np.ndarray, fleet_gen: int) -> Optional[int]:
        best, best_remaining = None, 0
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.active or slot.frozen:
                continue
            remaining = int(slot.spec.n_steps - gens[i])
            if remaining <= 0:
                continue
            d = slot.spec.deadline
            if d is not None and fleet_gen + self.chunk + remaining > d:
                continue  # itself deadline-tight
            if remaining > best_remaining:
                best, best_remaining = i, remaining
        return best

    def _preempt(self, index: int) -> None:
        slot = self.slots[index]
        self.counters["preempted"] += 1
        if self.metrics is not None:
            self.metrics.count("slo.preemptions")
        entry = self._close_out(index, status="preempted", refill=False)
        self.submit_resume(slot.spec, checkpoint=entry["checkpoint"],
                           done=int(entry.get("generations") or 0))

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, workflow: VectorizedWorkflow, journal_dir: Any, supervisor: Any = None,
                executor: Any = None, health_policy: Any = None,
                allow_config_mismatch: bool = False, metrics: Any = None,
                attest: Any = None) -> "RunQueue":
        """Rebuild a journaled sweep after its driver died: read the
        journal (hash chain verified), check the journaled config
        fingerprint against ``workflow`` (:class:`CheckpointConfigError`),
        restore the fleet from the newest chunk barrier whose snapshot is
        intact (and, with an attestation, whose bits match it), and rebuild
        pending, slots, counters and results as they stood there. Driving
        the returned queue replays the lost stretch: per-tenant results
        equal the uncrashed run's, each spec admitted once."""
        from .checkpoint import state_config_fingerprint
        from .journal import RunJournal

        journal = journal_dir if isinstance(journal_dir, RunJournal) else RunJournal(str(journal_dir))
        recs = journal.records()
        specs: Dict[int, TenantSpec] = {}
        resume_from: Dict[int, Optional[str]] = {}
        resume_done: Dict[int, Optional[int]] = {}
        for r in recs:
            if r["kind"] == "submit":
                seq = int(r["spec_seq"])
                specs[seq] = _spec_from_record(r)
                if r.get("resume_from") is not None:
                    resume_from[seq] = r["resume_from"]
                    resume_done[seq] = int(r["done"]) if r.get("done") is not None else None
        start = next((r for r in recs if r["kind"] == "start"), None)
        if health_policy is None and start is not None and start.get("health_policy"):
            # the journaled policy keeps isolating through the replay; an
            # explicit health_policy= overrides it
            from .fleet_health import FleetHealthPolicy

            health_policy = FleetHealthPolicy(**start["health_policy"])
        q = cls(workflow, chunk=int(start["chunk"]) if start is not None else 10,
                supervisor=supervisor,
                checkpoint_dir=start.get("checkpoint_dir") if start is not None else None,
                keep=int(start.get("keep", 2)) if start is not None else 2, executor=executor,
                journal=journal, health_policy=health_policy, metrics=metrics, attest=attest)
        q._spec_seq = max(specs, default=-1) + 1
        q.counters["submitted"] = len(specs)
        # a stolen seq is already durable in another pod's journal (the
        # steal record is appended only after the target's submit): it is
        # never requeued here, before the barrier or after it
        stolen = {int(r["spec_seq"]) for r in recs
                  if r["kind"] == "steal" and r.get("spec_seq") is not None}

        def requeue_all() -> None:
            derived = {(r.get("entry") or {}).get("checkpoint") for r in recs
                       if r["kind"] in ("preempt", "autoscale")}
            q.pending = [specs[s] for s in sorted(specs)
                         if s not in resume_from and s not in stolen]
            q.continuations = []
            seen: set = set()
            for s in sorted(specs):
                if (s in stolen or s not in resume_from or resume_from[s] in derived
                        or resume_from[s] in seen):
                    continue
                seen.add(resume_from[s])
                q.continuations.append({"spec": specs[s], "seq": s, "checkpoint": resume_from[s],
                                        "state": None, "done": resume_done.get(s)})

        def fresh_start() -> "RunQueue":
            requeue_all()
            journal.append("recover", generation=None, snapshot=None)
            if q.metrics is not None:
                q.metrics.restore_at(generation=None)
            return q

        if start is None:
            return fresh_start()
        first_wave = [specs[s] for s in start["slots"]]
        try:
            expect = workflow.init([int(s.seed) for s in first_wave],
                                   hyperparams=q._stack_hp([s.hyperparams for s in first_wave]))
            if start.get("freeze_mask"):
                expect = workflow.with_freeze_mask(expect)
            expected_sha = state_config_fingerprint(expect)
        except Exception as e:
            raise CheckpointConfigError(
                "the supplied workflow cannot rebuild the journaled fleet structure "
                f"({type(e).__name__}: {e}): algorithm, hyperparameter names or fleet width "
                "changed since the journal was written") from e
        recorded = start.get("config_sha")
        if recorded is not None and recorded != expected_sha and not allow_config_mismatch:
            raise CheckpointConfigError(
                f"journal {journal.path} was written under a different fleet config "
                f"(journal config_sha {recorded[:12]}… != supplied workflow's "
                f"{expected_sha[:12]}…): algorithm, population size, fleet width, monitors "
                "or hyperparam names changed. Rebuild the matching workflow or pass "
                "allow_config_mismatch=True.")
        q._config_sha = recorded or expected_sha
        meta, state = None, None
        verifier = q.attest
        for b in reversed([r for r in recs if r["kind"] == "chunk_complete"]):
            state = q._fleet_ckpt.load(int(b["generation"]))
            if state is None:
                continue
            state = workflow.place_restored(state)
            att_rec = b.get("attest")
            if att_rec is not None:
                if verifier is None:
                    from ..core.attest import StateAttestor

                    verifier = StateAttestor(device=workflow.device)
                try:
                    verifier.verify(state, att_rec, generation=int(b["generation"]),
                                    where=f"fleet snapshot {b.get('snapshot')}")
                except IntegrityError as e:
                    event = {"event": "corrupt_snapshot", "generation": int(b["generation"]),
                             "snapshot": b.get("snapshot"), "leaves": list(e.leaves),
                             "action": "barrier_fallback"}
                    q.integrity_events.append(event)
                    journal.append("integrity", **event, error=str(e)[:300])
                    state = None
                    continue
            meta = b
            break
        if meta is None:
            return fresh_start()
        if health_policy is not None and health_policy.may_freeze() and state.frozen is None:
            state = workflow.with_freeze_mask(state)
        q.state = state
        q.pending = [specs[s] for s in meta["pending"] if int(s) not in stolen]
        q.continuations = [{"spec": specs[int(c["seq"])], "seq": int(c["seq"]),
                            "checkpoint": c.get("checkpoint"), "state": None,
                            "done": int(c["done"]) if c.get("done") is not None else None}
                           for c in meta.get("continuations", []) or []
                           if int(c["seq"]) not in stolen]
        q.slots = [None if s is None else _Slot(spec=specs[s["seq"]], active=bool(s["active"]),
                                                 frozen=bool(s.get("frozen", False)))
                   for s in meta["slots"]]
        q.counters.update({k: int(v) for k, v in meta["counters"].items()})
        q.counters["submitted"] = len(specs)
        q._slot_restarts = [int(v) for v in meta.get("slot_restarts", [0] * workflow.n_tenants)]
        closeouts = {int(r["result_seq"]): r["entry"] for r in recs if r["kind"] in _CLOSE_KINDS}
        q.results = [closeouts[i] for i in range(int(meta["results_len"]))]
        # submits journaled after the barrier (an acknowledged submit
        # survives the crash): requeue every seq the barrier does not
        # account for
        barrier_pos = next(i for i, r in enumerate(recs) if r is meta)
        accounted = (
            {int(s) for s in meta["pending"] if s is not None}
            | {int(c["seq"]) for c in q.continuations}
            | {int(s["seq"]) for s in meta["slots"] if s is not None}
            | {int(r["spec_seq"]) for r in recs[:barrier_pos]
               if r["kind"] in _CLOSE_KINDS and r.get("spec_seq") is not None})
        replay_derived = {(r.get("entry") or {}).get("checkpoint") for r in recs[barrier_pos:]
                          if r["kind"] in ("preempt", "autoscale")}
        claimed = {resume_from[s] for s in accounted if s in resume_from}
        for seq in sorted(specs):
            if seq in accounted or seq in stolen:
                continue
            if seq in resume_from:
                ck = resume_from[seq]
                if ck in replay_derived or ck in claimed:
                    continue
                claimed.add(ck)
                q.continuations.append({"spec": specs[seq], "seq": seq, "checkpoint": ck,
                                        "state": None, "done": resume_done.get(seq)})
            else:
                q.pending.append(specs[seq])
        healths = {int(r["health_seq"]): {k: v for k, v in r.items()
                                          if k in ("health_seq", "chunk", "slot", "tag", "action",
                                                   "reason", "generation")}
                   for r in recs if r["kind"] == "health"}
        q.health_events = [healths[i] for i in range(int(meta.get("health_len", 0)))]
        q._used_dirs = {Path(e["checkpoint"]).name for e in q.results if e.get("checkpoint")}
        q.finished = False
        journal.append("recover", generation=int(meta["generation"]),
                       snapshot=meta.get("snapshot"))
        if q.metrics is not None:
            q.metrics.restore_at(generation=int(meta["generation"]))
        return q

    # -------------------------------------------------------------- report
    def health_report(self) -> Optional[dict]:
        """The ``tenancy.fleet_health`` section: the policy's configuration
        and the chunk-boundary action log (None when no policy ever
        acted)."""
        if self.health_policy is None and not self.health_events:
            return None
        policy = self.health_policy
        return {"policy": policy.report() if policy is not None and hasattr(policy, "report")
                else None,
                "events": list(self.health_events)}

    def report(self) -> dict:
        """``run_report``'s ``tenancy.queue`` section."""
        running = sum(1 for s in self.slots if s is not None and s.active)
        out = {
            "capacity": self.workflow.n_tenants,
            "chunk": self.chunk,
            "counters": dict(self.counters),
            "pending": len(self.pending),
            "continuations": len(self.continuations),
            "running": running,
            "results": [{k: v for k, v in r.items() if k != "monitors"} for r in self.results],
        }
        if self.journal is not None:
            out["journal"] = self.journal.report()
        if self.integrity_events:
            out["integrity_events"] = [dict(e) for e in self.integrity_events]
        return out
