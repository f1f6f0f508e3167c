"""Hierarchical multi-level ES: an outer meta-ES adapting inner-ES
hyperparameters across groups — the port of
``evox_tpu/workflows/multilevel.py``.

- **Groups** are independent inner ES runs (separate states and seeds, no
  migration), each judged on its own phase.
- Each **outer generation** samples one hyperparameter vector per group
  from an outer Gaussian (``theta_g = mean + sigma * eps_g`` in the specs'
  transformed space), installs it, runs ``inner_steps`` inner generations
  (a *phase*), scores each group by its phase-end mean fitness (or its
  phase improvement without ``exploit``), and moves the outer mean toward
  the elite fraction's proposals (CEM-style; the outer sigma only decays by
  ``sigma_decay``). The update runs in numpy float32 on the host, as the
  JAX package's does, so a replay of it on the CPU gives the same bits.
- **Hyperparameters** (:class:`HyperSpec`) bind two ways: ``kind="attr"``
  rebinds a (dotted) template attribute per group as a 0-d tensor (the
  fleet's :func:`~evox_tpu_torch.workflows.tenancy.bind_hyperparams`);
  ``kind="state"`` overwrites an inner state leaf at phase start (the CMA
  family's ``sigma``).

Two drives:

- **fleet** (a problem evaluated on the device): the groups are a
  :class:`~evox_tpu_torch.workflows.tenancy.VectorizedWorkflow`; attr
  hyperparameters are rebound by surgery on the fleet's hyperparameter
  leaves, and a phase is one ``run`` of the fleet.
- **sequential** (host problems, or ``fleet=False``): the groups run one
  at a time through ``ask``/``tell`` with their bindings. A
  ``FarmDegradedError`` (matched by name: workflows never import the
  problems package) parks only the affected group, whose phase is left
  out of the outer update, and the problem's ``admit()`` runs between
  phases so replacement workers rejoin.

The outer draw goes through :meth:`MultiLevelES._draw_outer`, one method a
test can replace (as ``OpenES._draw_noise``). Single-objective only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.algorithm import Algorithm
from ..core.device import DeviceLike, resolve_device
from ..core.members import MemberSeeds, MemberValues, put_state, stack_states, take_state
from ..core.monitor import Monitor
from ..core.problem import Problem
from ..core.struct import PyTreeNode, static_field
from ..utils.common import generator, parse_opt_direction, split_seed
from .tenancy import VectorizedWorkflow, bind_hyperparams

__all__ = ["HyperSpec", "MultiLevelES", "MultiLevelState"]

# an evaluation backend whose live membership fell below its floor
_DEGRADED_ERRORS = ("FarmDegradedError",)


def _is_degraded(e: BaseException) -> bool:
    return any(c.__name__ in _DEGRADED_ERRORS for c in type(e).__mro__)


@dataclasses.dataclass(frozen=True)
class HyperSpec:
    """One adapted inner-ES hyperparameter.

    Args:
        name: template attribute path (``kind="attr"``; dotted paths reach
            through wrappers) or inner state leaf name (``kind="state"``).
        init: initial value (external space).
        sigma: outer mutation stdev in the transformed space.
        lb / ub: external-space clip bounds of every proposal.
        transform: ``"log"`` (positive scale parameters) or ``"linear"``.
        kind: ``"attr"`` or ``"state"``.
    """

    name: str
    init: float
    sigma: float = 0.3
    lb: float = 1e-8
    ub: float = 1e8
    transform: str = "log"
    kind: str = "attr"

    def __post_init__(self):
        if self.transform not in ("log", "linear"):
            raise ValueError(f"unknown transform {self.transform!r}")
        if self.kind not in ("attr", "state"):
            raise ValueError(f"unknown kind {self.kind!r}")
        if not (self.lb < self.ub):
            raise ValueError(f"need lb < ub, got [{self.lb}, {self.ub}]")
        if self.transform == "log" and self.lb <= 0:
            raise ValueError("log-transformed specs need lb > 0")
        if not (self.lb <= self.init <= self.ub):
            raise ValueError(f"init {self.init} outside [{self.lb}, {self.ub}]")

    def to_internal(self, v: Any) -> torch.Tensor:
        v = torch.as_tensor(v, dtype=torch.float32)
        return torch.log(v) if self.transform == "log" else v

    def to_external(self, z: torch.Tensor) -> torch.Tensor:
        v = torch.exp(z) if self.transform == "log" else z
        return torch.clamp(v, self.lb, self.ub)


class _PhaseBest(Monitor):
    """Per group (minimisation convention): the best candidate so far and
    the mean fitness of the newest generation, the outer score."""

    def __init__(self, device: torch.device):
        self.device = device

    def hooks(self):
        return ("post_eval",)

    def init(self, seed=None):
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=self.device)
        return (inf, inf.clone())

    def post_eval(self, mstate, cand, fitness):
        best, _ = mstate
        f = fitness * self.opt_direction[0]
        return (torch.minimum(best, torch.min(f).to(torch.float32)),
                torch.mean(f).to(torch.float32))


class MultiLevelState(PyTreeNode):
    """The outer state: ``generation`` (the outer counter) and ``key`` (the
    outer seed) on the host, the outer distribution, proposals and group
    scores on the device."""

    generation: int
    outer_mean: torch.Tensor = None  # (H,) transformed space
    outer_sigma: torch.Tensor = None  # (H,)
    theta: torch.Tensor = None  # (G, H) live proposals
    key: int = 0
    inner: Any = None  # fleet state | the groups' stacked algorithm states
    prob: Any = None  # sequential drive: the shared problem state
    best: torch.Tensor = None  # (G,) best-so-far (minimisation convention)
    score: torch.Tensor = None  # (G,) newest phase-end mean fitness
    active: torch.Tensor = None  # (G,) bool
    first_step: bool = static_field(default=True)


class MultiLevelES:
    """Outer meta-ES over a population of inner ES groups.

    Args:
        algorithm: the inner-ES template (single-objective); algorithms
            with ``init_ask``/``init_tell`` are refused in the sequential
            drive.
        problem: the shared problem (a host problem forces the sequential
            drive).
        n_groups: inner group count (the outer population).
        hyper_specs: the adapted hyperparameters (:class:`HyperSpec`).
        inner_steps: inner generations a phase.
        outer_lr: interpolation rate of the outer mean toward the elite
            proposals (0 disables adaptation).
        elite_frac: top fraction of active groups in the update.
        sigma_decay: multiplicative outer-sigma decay a generation.
        explore: sample proposals around the outer mean (``False``: every
            group runs the mean).
        exploit: at each phase start, every group's inner state restarts
            from the best group's (each keeping its own seeds).
        opt_direction / pop_transforms: as :class:`StdWorkflow`.
        fleet: force the drive (default: fleet iff the problem is
            evaluated on the device).
        admit_every: call the problem's ``admit()`` every N phases in the
            sequential drive (0 disables).
        device: ``None`` means ``"cuda"``.
    """

    def __init__(self, algorithm: Algorithm, problem: Problem, n_groups: int,
                 hyper_specs: Sequence[HyperSpec], inner_steps: int = 10, outer_lr: float = 0.5,
                 elite_frac: float = 0.5, sigma_decay: float = 1.0, explore: bool = True,
                 exploit: bool = True, opt_direction: Any = "min",
                 pop_transforms: Sequence[Callable] = (), fleet: Optional[bool] = None,
                 admit_every: int = 1, device: DeviceLike = None):
        if n_groups < 2:
            raise ValueError(f"need >= 2 groups, got {n_groups}")
        if not hyper_specs:
            raise ValueError("need at least one HyperSpec")
        if inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        if not (0.0 <= outer_lr <= 1.0):
            raise ValueError("outer_lr must be in [0, 1]")
        if not (0.0 < elite_frac <= 1.0):
            raise ValueError("elite_frac must be in (0, 1]")
        names = [s.name for s in hyper_specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate hyperparameter names: {names}")
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.problem = problem
        self.n_groups = int(n_groups)
        self.specs = tuple(hyper_specs)
        self.inner_steps = int(inner_steps)
        self.outer_lr = float(outer_lr)
        self.elite_frac = float(elite_frac)
        self.sigma_decay = float(sigma_decay)
        self.explore = bool(explore)
        self.exploit = bool(exploit)
        self.opt_direction = parse_opt_direction(opt_direction).to(self.device)
        self.pop_transforms = tuple(pop_transforms)
        self.admit_every = int(admit_every)
        jittable = getattr(problem, "jittable", True)
        self.fleet_mode = bool(jittable if fleet is None else fleet)
        if self.fleet_mode and not jittable:
            raise ValueError("fleet mode needs a problem evaluated on the device (a host problem "
                             "cannot run inside the fleet's member call); pass fleet=False for "
                             "the sequential drive")
        self._attr_specs = tuple(s for s in self.specs if s.kind == "attr")
        self._state_specs = tuple(s for s in self.specs if s.kind == "state")
        for s in self._attr_specs:
            obj = algorithm
            for part in s.name.split("."):
                if not hasattr(obj, part):
                    raise ValueError(f"HyperSpec[{s.name!r}]: template {type(obj).__name__} "
                                     f"has no attribute {part!r}")
                obj = getattr(obj, part)
        self.events: list = []  # membership and adaptation events (report())
        if self.fleet_mode:
            self._score_mon = _PhaseBest(self.device)
            self._fleet = VectorizedWorkflow(
                algorithm, problem, n_tenants=self.n_groups,
                hyperparams={s.name: np.full((self.n_groups,), s.init, np.float32)
                             for s in self._attr_specs},
                monitors=[self._score_mon], opt_direction=opt_direction,
                pop_transforms=pop_transforms, device=self.device)
        else:
            if getattr(algorithm, "has_init_ask", False) or getattr(algorithm, "has_init_tell",
                                                                    False):
                raise ValueError("sequential multi-level drive supports steady-state ask/tell "
                                 f"algorithms only (the ES family); {type(algorithm).__name__} "
                                 "declares init hooks")
            self._fleet = None

    # ------------------------------------------------------------- internals
    def _seq_ask(self, astate: Any, hp: Dict[str, torch.Tensor]):
        algo = bind_hyperparams(self.algorithm, hp)
        pop, astate = algo.ask(astate)
        cand = pop
        for t in self.pop_transforms:
            cand = t(cand)
        return cand, astate

    def _seq_tell(self, astate: Any, hp: Dict[str, torch.Tensor], fitness: torch.Tensor):
        algo = bind_hyperparams(self.algorithm, hp)
        return algo.tell(astate, fitness * self.opt_direction[0])

    def _draw_outer(self, seed: int) -> torch.Tensor:
        """The outer generation's one draw: ``(n_groups, H)`` standard
        normals from ``seed``."""
        return torch.randn((self.n_groups, len(self.specs)), generator=generator(seed, self.device),
                           device=self.device, dtype=torch.float32)

    def _theta_to_values(self, theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(G, H) internal proposals -> {name: (G,) external values}."""
        return {s.name: s.to_external(theta[:, i]) for i, s in enumerate(self.specs)}

    def hyper_values(self, state: MultiLevelState) -> Dict[str, np.ndarray]:
        """Each group's current hyperparameter values (external space, host
        numpy)."""
        return {k: v.cpu().numpy() for k, v in self._theta_to_values(state.theta).items()}

    def _apply_values(self, state: MultiLevelState, values: Dict[str, torch.Tensor]
                      ) -> MultiLevelState:
        """Install proposals: attr specs rebind the fleet's hyperparameter
        leaves (the sequential drive hands them to ``ask``/``tell``); state
        specs overwrite the groups' stacked inner state leaf."""
        inner = state.inner
        if self.fleet_mode and self._attr_specs:
            hp = dict(inner.tenants.hyperparams)
            for s in self._attr_specs:
                hp[s.name] = values[s.name].to(hp[s.name].dtype)
            inner = inner.replace(tenants=inner.tenants.replace(hyperparams=hp))
        algo_states = inner.tenants.algo if self.fleet_mode else inner
        if self._state_specs:
            updates = {}
            for s in self._state_specs:
                leaf = getattr(algo_states, s.name)
                v = values[s.name].to(leaf.dtype).reshape((self.n_groups,) + (1,) * (leaf.ndim - 1))
                updates[s.name] = v.expand(leaf.shape).contiguous()
            algo_states = algo_states.replace(**updates)
            if self.fleet_mode:
                inner = inner.replace(tenants=inner.tenants.replace(algo=algo_states))
            else:
                inner = algo_states
        return state.replace(inner=inner)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> MultiLevelState:
        """The outer state: the outer mean at every spec's ``init``, every
        group running it, no phase scored yet. The sequential drive's groups
        are ``algorithm.init`` of their own seeds; nothing is evaluated."""
        k_outer, k_inner = split_seed(int(seed))
        mean = torch.stack([s.to_internal(s.init) for s in self.specs]).to(self.device)
        sigma = torch.tensor([s.sigma for s in self.specs], dtype=torch.float32,
                             device=self.device)
        theta = mean.repeat(self.n_groups, 1)
        if self.fleet_mode:
            inner, prob = self._fleet.init(k_inner), None
        else:
            gseeds = split_seed(k_inner, self.n_groups + 1)
            inner = stack_states([self.algorithm.init(s) for s in gseeds[: self.n_groups]])
            prob = self.problem.init(gseeds[-1])
        inf = torch.full((self.n_groups,), float("inf"), dtype=torch.float32, device=self.device)
        state = MultiLevelState(
            generation=0, outer_mean=mean, outer_sigma=sigma, theta=theta, key=k_outer,
            inner=inner, prob=prob, best=inf, score=inf.clone(),
            active=torch.ones((self.n_groups,), dtype=torch.bool, device=self.device),
            first_step=True)
        # the init proposals are the means: install them so the groups start
        # where the outer distribution says
        return self._apply_values(state, self._theta_to_values(theta))

    # ------------------------------------------------------------------ step
    def step(self, state: MultiLevelState) -> MultiLevelState:
        """One outer generation: exploit, sample proposals, install, run one
        inner phase, score, outer update."""
        if self.exploit and not state.first_step:
            state = self._exploit_best(state)
        key, k_eps = split_seed(state.key)
        if self.explore:
            theta = state.outer_mean + state.outer_sigma * self._draw_outer(k_eps)
        else:
            theta = state.outer_mean.repeat(self.n_groups, 1)
        state = self._apply_values(state.replace(theta=theta, key=key),
                                   self._theta_to_values(theta))
        score_before = state.score
        state = self._run_phase(state)
        if self.exploit:
            # the groups started this phase from the same state: the
            # phase-end mean fitness ranks the proposals directly
            gain = -state.score
        else:
            gain = torch.where(torch.isinf(score_before), -state.score, score_before - state.score)
        gain = torch.nan_to_num(gain, nan=0.0, posinf=0.0, neginf=0.0)
        state = self._outer_update(state, gain)
        return state.replace(generation=state.generation + 1, first_step=False)

    def _exploit_best(self, state: MultiLevelState) -> MultiLevelState:
        """Restart every group's inner algorithm state from the best-scoring
        active group's, each group keeping its own seeds (fields whose name
        ends in ``key`` or ``seed``)."""
        score = state.score.cpu().numpy()
        active = state.active.cpu().numpy()
        score = np.where(active, score, np.inf)
        if not np.isfinite(score).any():
            return state
        best_g = int(np.argmin(score))
        g = self.n_groups

        def pick(tree: Any, name: str) -> Any:
            if name.endswith(("key", "seed")):
                return tree
            if isinstance(tree, torch.Tensor):
                return tree[best_g].expand(tree.shape).clone() if tree.ndim >= 1 and \
                    tree.shape[0] == g else tree
            if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
                return tree.replace(**{f.name: pick(getattr(tree, f.name), f.name)
                                       for f in dataclasses.fields(tree)})
            if isinstance(tree, dict):
                return {k: pick(v, str(k)) for k, v in tree.items()}
            if isinstance(tree, MemberValues):
                return tree[best_g]
            if isinstance(tree, (list, tuple)) and not isinstance(tree, MemberSeeds):
                return type(tree)(pick(v, name) for v in tree)
            return tree

        algo_states = state.inner.tenants.algo if self.fleet_mode else state.inner
        algo_states = pick(algo_states, "")
        if self.fleet_mode:
            inner = state.inner.replace(tenants=state.inner.tenants.replace(algo=algo_states))
        else:
            inner = algo_states
        return state.replace(inner=inner)

    def run(self, state: MultiLevelState, n_outer: int) -> MultiLevelState:
        for _ in range(int(n_outer)):
            state = self.step(state)
        return state

    # ----------------------------------------------------------- inner phase
    def _run_phase(self, state: MultiLevelState) -> MultiLevelState:
        if not self.fleet_mode:
            return self._run_phase_sequential(state)
        inner = self._fleet.run(state.inner, self.inner_steps)
        tracker_best, tracker_mean = inner.tenants.monitors[0]
        best = torch.where(state.active, torch.minimum(state.best, tracker_best.float()),
                           state.best)
        score = torch.where(state.active, tracker_mean.float(), state.score)
        return state.replace(inner=inner, best=best, score=score)

    def _run_phase_sequential(self, state: MultiLevelState) -> MultiLevelState:
        values = self._theta_to_values(state.theta)
        active = state.active.cpu().numpy().copy()
        best = state.best.cpu().numpy().copy()
        score = state.score.cpu().numpy().copy()
        inner, pstate = state.inner, state.prob
        phase_idx = int(state.generation)
        if (self.admit_every and phase_idx % self.admit_every == 0
                and hasattr(self.problem, "admit")):
            admitted = self.problem.admit()
            if admitted:
                self.events.append({"event": "admit", "phase": phase_idx, "workers": admitted})
        sign = float(self.opt_direction[0])
        for g in range(self.n_groups):
            if not active[g]:
                continue
            hp_g = {s.name: values[s.name][g] for s in self._attr_specs}
            astate = take_state(inner, g)
            try:
                for _ in range(self.inner_steps):
                    cand, astate = self._seq_ask(astate, hp_g)
                    fitness, pstate = self.problem.evaluate(pstate, cand)
                    f_int = np.asarray(torch.as_tensor(fitness).cpu().numpy(),
                                       dtype=np.float32) * sign
                    best[g] = min(best[g], float(f_int.min()))
                    score[g] = float(f_int.mean())
                    astate = self._seq_tell(astate, hp_g, torch.as_tensor(fitness,
                                                                          device=self.device))
            except Exception as e:
                if not _is_degraded(e):
                    raise
                # the evaluation pool fell below its floor mid-phase: this
                # group parks (its partial phase left out of the outer
                # score) and the run goes on with the others
                active[g] = False
                self.events.append({"event": "group_lost", "phase": phase_idx, "group": g,
                                    "error": f"{type(e).__name__}: {e}"})
                continue
            inner = put_state(inner, g, astate)
        if not active.any():
            raise RuntimeError("multi-level ES: every group lost its evaluation backend "
                               f"(events: {self.events[-self.n_groups:]})")
        dev = self.device
        return state.replace(inner=inner, prob=pstate,
                             best=torch.as_tensor(best, dtype=torch.float32, device=dev),
                             score=torch.as_tensor(score, dtype=torch.float32, device=dev),
                             active=torch.as_tensor(active, dtype=torch.bool, device=dev))

    # ---------------------------------------------------------- outer update
    def _outer_update(self, state: MultiLevelState, gain: torch.Tensor) -> MultiLevelState:
        """The outer mean moves ``outer_lr`` of the way to the elite
        proposals' mean; the outer sigma only decays (a CEM-style shrink
        toward the elites' spread collapses exploration once they cluster).
        numpy float32 on the host, as the JAX package computes it."""
        if self.outer_lr == 0.0:
            return state
        active = state.active.cpu().numpy()
        n_active = int(active.sum())
        if n_active < 2:
            return state  # nothing to rank against
        k = max(1, int(round(self.elite_frac * n_active)))
        g = np.where(active, gain.cpu().numpy(), -np.inf)  # parked groups never elite
        elite = np.argsort(-g)[:k]
        theta = state.theta.cpu().numpy()
        lr = self.outer_lr
        mean = (1 - lr) * state.outer_mean.cpu().numpy() + lr * theta[elite].mean(axis=0)
        sigma = np.maximum(state.outer_sigma.cpu().numpy() * self.sigma_decay, 1e-4)
        return state.replace(
            outer_mean=torch.as_tensor(mean, dtype=torch.float32, device=self.device),
            outer_sigma=torch.as_tensor(sigma, dtype=torch.float32, device=self.device))

    # --------------------------------------------------------------- readout
    def best_fitness(self, state: MultiLevelState) -> Tuple[np.ndarray, float]:
        """(per-group best-so-far, overall best) in the user's convention."""
        sign = float(self.opt_direction[0])
        per_group = state.best.cpu().numpy() * sign
        overall = per_group.min() if sign > 0 else per_group.max()
        return per_group, float(overall)

    def report(self, state: Optional[MultiLevelState] = None) -> dict:
        """The drive, the outer distribution, the groups' scores and the
        membership events."""
        out = {"mode": "fleet" if self.fleet_mode else "sequential",
               "n_groups": self.n_groups, "inner_steps": self.inner_steps,
               "hyperparams": [s.name for s in self.specs], "events": list(self.events)}
        if state is not None:
            per_group, overall = self.best_fitness(state)
            out.update({
                "outer_generation": int(state.generation),
                "active_groups": int(state.active.sum()),
                "best_per_group": per_group.tolist(),
                "best_overall": overall,
                "outer_mean_external": {s.name: float(s.to_external(state.outer_mean[i]))
                                        for i, s in enumerate(self.specs)},
            })
        return out
