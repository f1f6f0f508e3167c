"""Numerical self-defense: degenerate-state detection and restarts — the
port of ``evox_tpu/core/guardrail.py``.

:class:`GuardedAlgorithm` wraps any single-objective algorithm with the
same interface and, after every ``tell``, checks the wrapped state: a NaN
(optionally ±inf) leaf, a step size below its floor or above its ceiling,
a collapsed candidate diversity, a stagnated best-so-far. On a trigger it
restarts: a fresh ``init`` from the wrapper's restart stream, re-centered
on the best-so-far point, with the best-so-far pair and a restart counter
kept in the wrapper's own state. :class:`IPOPRestarts` is the host-side
half of the IPOP recipe (``StdWorkflow.run(restarts=...)``,
``workflows/ipop.py``): it doubles the population between segments.

Where the JAX package decides with ``lax.cond`` on the device, the port
folds every check of a ``tell`` into one small integer on the card (the
trigger bits and whether the best improved) and reads it **once per
tell**: a restart rebuilds the inner state through ``init``, which a
``torch.where`` over leaves cannot do. The counters the host decides on
(``stagnation``, ``restarts``, ``checked_restarts``, ``last_trigger``)
are then host integers, as the port's other states hold their
generation counters; ``best_x`` and ``best_fitness`` stay on the card.

No-trigger law: with guards enabled but never triggered,
``GuardedAlgorithm(alg)`` gives the bare algorithm's trajectory bit for
bit: ``init`` hands the wrapped algorithm the caller's seed unchanged (the
restart stream is ``fold_in_seed(seed, 0x6A72)``), ``ask``/``tell``
delegate exactly, and an untriggered check leaves the inner state as the
inner ``tell`` returned it.

The JAX package sizes a fixed candidate buffer (``pop``) by ``eval_shape``
of the first and the steady ask, because its loop carry needs one static
shape; the port keeps the last asked batch, and ``tell`` reads its first
``fitness.shape[0]`` rows, the rows JAX's slice of its buffer reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..utils.common import fold_in_seed, split_seed, tree_flatten, tree_map
from .algorithm import Algorithm
from .struct import PyTreeNode, field, static_field

__all__ = [
    "GuardedAlgorithm",
    "GuardedState",
    "IPOPRestarts",
    "recenter_state",
    "TRIGGER_NONFINITE",
    "TRIGGER_SIGMA",
    "TRIGGER_DIVERSITY",
    "TRIGGER_STAGNATION",
]

# bitmask codes recorded in GuardedState.last_trigger
TRIGGER_NONFINITE = 1  # NaN (optionally Inf) leaves in the wrapped state
TRIGGER_SIGMA = 2  # step size below floor / above ceiling
TRIGGER_DIVERSITY = 4  # candidate diversity collapsed below the floor
TRIGGER_STAGNATION = 8  # generations without best-so-far improvement
_IMPROVED = 16  # not a trigger: the generation's best beat best-so-far

_TRIGGER_NAMES = (
    (TRIGGER_NONFINITE, "nonfinite_state"),
    (TRIGGER_SIGMA, "sigma_collapse"),
    (TRIGGER_DIVERSITY, "diversity_collapse"),
    (TRIGGER_STAGNATION, "stagnation"),
)


class GuardedState(PyTreeNode):
    inner: Any  # the wrapped algorithm's state
    pop: Any = field(storage=True)  # the last asked candidate batch (None before the first ask)
    best_x: Any  # best-so-far candidate (None before the first tell)
    best_fitness: torch.Tensor  # 0-d float32, internal (minimize) key
    stagnation: int  # generations since best-so-far improved
    restarts: int  # restarts so far
    # the value of `restarts` when the IPOP driver (workflows/ipop.py) last
    # evaluated its escalation rule; written only between segments
    checked_restarts: int
    last_trigger: int  # bitmask, 0 = healthy
    key: int  # the restart stream's seed
    # the wrapped algorithm's population size, which IPOP's rule reads
    pop_size: int = static_field(default=0)


def _has_field(state: Any, name: str) -> bool:
    return dataclasses.is_dataclass(state) and name in {f.name for f in dataclasses.fields(state)}


def recenter_state(astate: Any, best_x: Any) -> Any:
    """Re-center a fresh algorithm state on the best-so-far point.

    Duck-typed and shape-preserving: a distribution-based state (a ``mean``
    or ``center`` field of ``best_x``'s shape; the port's CMA-ES family
    holds ``mean``) moves its center onto ``best_x``; a population-based
    state (a 2-D ``population``) gets ``best_x`` written into row 0 (the
    rest of the fresh population keeps exploring). Anything else, or a
    ``best_x`` that is not a vector (a parameter tree), is returned
    unchanged: the fresh ``init()`` alone is the restart.
    """
    if isinstance(best_x, np.ndarray):
        best_x = torch.from_numpy(best_x)
    if not isinstance(best_x, torch.Tensor) or best_x.ndim != 1:
        return astate
    for name in ("mean", "center"):
        if _has_field(astate, name):
            cur = getattr(astate, name)
            if isinstance(cur, torch.Tensor) and cur.shape == best_x.shape:
                return astate.replace(**{name: best_x.to(device=cur.device, dtype=cur.dtype)})
    if _has_field(astate, "population"):
        pop = astate.population
        if isinstance(pop, torch.Tensor) and pop.ndim == 2 and pop.shape[1:] == best_x.shape:
            pop = pop.clone()
            pop[0] = best_x.to(device=pop.device, dtype=pop.dtype)
            return astate.replace(population=pop)
    return astate


def _take_best(improved: torch.Tensor, i: torch.Tensor, prev: Any, batch: Any) -> Any:
    """Row ``i`` of each leaf of ``batch`` where ``improved``, else ``prev``'s
    leaf. ``index_select``, not ``b[i]``: indexing by a 0-d CUDA tensor
    reads it on the host."""
    leaves, rebuild = tree_flatten(prev)
    return rebuild([torch.where(improved, b.index_select(0, i.reshape(1))[0].to(p.dtype), p)
                    for p, b in zip(leaves, tree_flatten(batch)[0])])


def _float_leaves(tree: Any):
    """The floating-point tensors of a state (dataclasses walked field by
    field, then dicts, lists and tuples)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _float_leaves(getattr(tree, f.name))
    elif isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, (dict, list, tuple)):
        for leaf in tree_flatten(tree)[0]:
            yield from _float_leaves(leaf)


class GuardedAlgorithm(Algorithm):
    """Wrap any single-objective :class:`Algorithm` with health checks and
    automatic restart.

    After each ``tell`` the enabled predicates are evaluated on the freshly
    updated inner state:

    - **non-finite leaves** (``check_nonfinite``): a NaN in a floating
      leaf of the inner state; ``check_inf=True`` also triggers on ±inf
      (off by default: +inf fitness sentinels are idiomatic, e.g. PSO's
      initial personal bests).
    - **step size** (``sigma_floor``/``sigma_ceiling``, inclusive): checked
      only when the inner state has a ``sigma`` field (the ES family); a
      per-axis sigma triggers on any one axis.
    - **diversity** (``diversity_floor``): the finite-masked mean
      per-dimension std of the scored batch below the floor. Off by
      default.
    - **stagnation** (``stagnation_limit``): generations since best-so-far
      improved (the fitness is in the internal minimization convention,
      so "improved" is "strictly smaller"). Off by default.

    On a trigger the inner state is replaced by ``inner.init(seed)`` from
    the restart stream, re-centered on best-so-far (:func:`recenter_state`),
    the stagnation counter is reset and ``restarts`` counts one more; the
    best-so-far pair survives. The device decides nothing: the checks are
    folded into one integer on the card, read once per ``tell``. Unknown
    attributes (``pop_size``, ``dim``, ``lb``, ...) are forwarded to the
    wrapped algorithm.
    """

    # not under torch.func.vmap: its tell reads the health flag on the host (one
    # read a tell); stacked members run one by one
    stackable = False

    def __init__(
        self,
        algorithm: Algorithm,
        check_nonfinite: bool = True,
        check_inf: bool = False,
        sigma_floor: Optional[float] = 1e-20,
        sigma_ceiling: Optional[float] = 1e20,
        diversity_floor: Optional[float] = None,
        stagnation_limit: Optional[int] = None,
    ):
        self.algorithm = algorithm
        self.check_nonfinite = check_nonfinite
        self.check_inf = check_inf
        self.sigma_floor = sigma_floor
        self.sigma_ceiling = sigma_ceiling
        self.diversity_floor = diversity_floor
        self.stagnation_limit = stagnation_limit

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails: forward hyperparameter
        # reads (pop_size, dim, lb, ub, device, ...) to the wrapped algorithm
        if name.startswith("__") or name == "algorithm":
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "algorithm"), name)

    # first-generation dispatch mirrors the wrapped algorithm exactly
    @property
    def has_init_ask(self) -> bool:
        return self.algorithm.has_init_ask

    @property
    def has_init_tell(self) -> bool:
        return self.algorithm.has_init_tell

    # ------------------------------------------------------------------ api
    def init(self, seed: int) -> GuardedState:
        # the inner algorithm gets the caller's seed unchanged: the
        # no-trigger law; the restart stream is folded off it
        inner = self.algorithm.init(seed)
        return GuardedState(
            inner=inner,
            pop=None,
            best_x=None,
            best_fitness=torch.tensor(float("inf"), device=self._device(inner)),
            stagnation=0,
            restarts=0,
            checked_restarts=0,
            last_trigger=0,
            key=fold_in_seed(seed, 0x6A72),  # "gr"
            pop_size=int(getattr(self.algorithm, "pop_size", 0) or 0),
        )

    def _device(self, inner: Any) -> torch.device:
        dev = getattr(self.algorithm, "device", None)
        if dev is not None:
            return dev
        leaf = next(_float_leaves(inner), None)
        return torch.device("cpu") if leaf is None else leaf.device

    def ask(self, state: GuardedState) -> Tuple[Any, GuardedState]:
        pop, inner = self.algorithm.ask(state.inner)
        return pop, state.replace(inner=inner, pop=pop)

    def init_ask(self, state: GuardedState) -> Tuple[Any, GuardedState]:
        pop, inner = self.algorithm.init_ask(state.inner)
        return pop, state.replace(inner=inner, pop=pop)

    def tell(self, state: GuardedState, fitness: torch.Tensor) -> GuardedState:
        return self._postcheck(state, self.algorithm.tell(state.inner, fitness), fitness)

    def init_tell(self, state: GuardedState, fitness: torch.Tensor) -> GuardedState:
        return self._postcheck(state, self.algorithm.init_tell(state.inner, fitness), fitness)

    def migrate(self, state: GuardedState, pop: Any, fitness: torch.Tensor) -> GuardedState:
        """Migrants count as progress: they fold into best-so-far and the
        stagnation counter (``fitness`` in the internal minimization
        convention, as ``tell``'s), so an island's best genome does not
        look stagnant to the guard. One host read: whether they improved."""
        fitness = fitness.to(torch.float32)
        masked = torch.where(torch.isfinite(fitness), fitness, torch.full_like(fitness, float("inf")))
        mig_best_i = torch.argmin(masked)
        mig_best = torch.amin(masked)
        improved = mig_best < state.best_fitness
        best_x = _take_best(improved, mig_best_i, self._best_x(state.best_x, pop), pop)
        return state.replace(
            inner=self.algorithm.migrate(state.inner, pop, fitness),
            best_x=best_x,
            best_fitness=torch.minimum(state.best_fitness, mig_best),
            stagnation=0 if bool(improved) else state.stagnation,
        )

    # ------------------------------------------------------- health checks
    @staticmethod
    def _best_x(best_x: Any, batch: Any) -> Any:
        """best-so-far, or zeros of a candidate's shape before the first
        tell (the JAX package's initial buffer)."""
        if best_x is not None:
            return best_x
        return tree_map(lambda p: torch.zeros_like(p[0]), batch)

    def _postcheck(self, state: GuardedState, inner: Any, fitness: torch.Tensor) -> GuardedState:
        if fitness.ndim != 1:
            raise ValueError(
                "GuardedAlgorithm restarts re-center on a scalar best-so-far "
                f"point and are single-objective; got fitness of shape {tuple(fitness.shape)}"
            )
        fitness = fitness.to(torch.float32)
        # the rows of the last asked batch this fitness scored
        batch = tree_map(lambda p: p[: fitness.shape[0]], state.pop)

        # best-so-far (finite-masked, so a poison generation cannot claim it)
        masked = torch.where(torch.isfinite(fitness), fitness, torch.full_like(fitness, float("inf")))
        gen_best_i = torch.argmin(masked)
        gen_best = torch.amin(masked)
        improved = gen_best < state.best_fitness
        best_fitness = torch.minimum(state.best_fitness, gen_best)
        best_x = _take_best(improved, gen_best_i, self._best_x(state.best_x, batch), batch)

        # every device-side check folded into one integer
        flag = improved.to(torch.int32) * _IMPROVED
        if self.check_nonfinite:
            flag = flag | self._nonfinite_in(inner).to(torch.int32).to(flag.device) * TRIGGER_NONFINITE
        if _has_field(inner, "sigma") and (
            self.sigma_floor is not None or self.sigma_ceiling is not None
        ):
            sigma = torch.abs(torch.as_tensor(inner.sigma, dtype=torch.float32))
            bad = torch.zeros((), dtype=torch.bool, device=sigma.device)
            # inclusive comparisons: a rail that pins sigma at exactly its
            # floor or ceiling still reads as collapsed
            if self.sigma_floor is not None:
                bad = bad | (torch.amin(sigma) <= self.sigma_floor)
            if self.sigma_ceiling is not None:
                bad = bad | (torch.amax(sigma) >= self.sigma_ceiling)
            flag = flag | bad.to(torch.int32).to(flag.device) * TRIGGER_SIGMA
        if self.diversity_floor is not None:
            low = self._diversity(batch) < self.diversity_floor
            flag = flag | low.to(torch.int32).to(flag.device) * TRIGGER_DIVERSITY
        flag = int(flag)  # the one host read of a tell

        stagnation = 0 if flag & _IMPROVED else state.stagnation + 1
        trigger = flag & ~_IMPROVED
        if self.stagnation_limit is not None and stagnation >= self.stagnation_limit:
            trigger |= TRIGGER_STAGNATION
        checked = state.replace(
            inner=inner,
            best_x=best_x,
            best_fitness=best_fitness,
            stagnation=stagnation,
            last_trigger=trigger,
        )
        return self._restart(checked) if trigger else checked

    def _restart(self, state: GuardedState) -> GuardedState:
        key, s_init = split_seed(state.key)
        fresh = recenter_state(self.algorithm.init(s_init), state.best_x)
        return state.replace(inner=fresh, stagnation=0, restarts=state.restarts + 1, key=key)

    def _nonfinite_in(self, tree: Any) -> torch.Tensor:
        bad = None
        for x in _float_leaves(tree):
            b = torch.isnan(x).any()
            if self.check_inf:
                b = b | torch.isinf(x).any()
            bad = b if bad is None else bad | b.to(bad.device)
        return torch.zeros((), dtype=torch.bool) if bad is None else bad

    @staticmethod
    def _diversity(pop: Any) -> torch.Tensor:
        """Finite-masked mean per-dimension std over the batch axis, summed
        in float32 (the statistic the JAX package's TelemetryMonitor
        rings)."""
        std_sum, n_dims, dev = None, 0, None
        for x in tree_flatten(pop)[0]:
            if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
                continue
            flat = x.to(torch.float32).reshape(x.shape[0], -1)
            ok = torch.isfinite(flat)
            zero = torch.zeros_like(flat)
            n = torch.clamp(ok.to(torch.float32).sum(dim=0), min=1.0)
            mean = torch.where(ok, flat, zero).sum(dim=0) / n
            var = torch.where(ok, (flat - mean) ** 2, zero).sum(dim=0) / n
            s = torch.sqrt(var).sum()
            std_sum = s if std_sum is None else std_sum + s
            n_dims += flat.shape[1]
            dev = flat.device
        if std_sum is None:
            return torch.zeros((), dtype=torch.float32, device=dev)
        return std_sum / max(n_dims, 1)

    # -------------------------------------------------------------- report
    def health_report(self, state: GuardedState) -> dict:
        """A JSON-friendly snapshot of the wrapper's health counters."""
        trig = int(state.last_trigger)
        return {
            "restarts": int(state.restarts),
            "stagnation": int(state.stagnation),
            "best_fitness": float(state.best_fitness),
            "pop_size": int(state.pop_size),
            "algorithm": type(self.algorithm).__name__,
            "last_trigger": trig,
            "last_trigger_names": [name for bit, name in _TRIGGER_NAMES if trig & bit],
        }


class IPOPRestarts:
    """Host-side IPOP policy: double the population on restart.

    A new population size means new shapes, so growth happens between
    segments of ``check_every`` generations: ``StdWorkflow.run(restarts=
    ...)`` (workflows/ipop.py) reads the guarded state's counters at each
    boundary and, on a restart since the last check, rebuilds the workflow
    around ``algorithm_factory(pop * growth)``.

    Args:
        algorithm_factory: ``pop_size -> GuardedAlgorithm``; deterministic
            in ``pop_size``.
        max_restarts: population doublings allowed (the IPOP budget).
        growth: population multiplier per restart (2 = classic IPOP).
        check_every: generations per segment between host checks.
        stagnation_limit: also escalate when the guarded state's
            stagnation counter reaches this limit, even if no restart
            fired.
        handoff_pop: population at or past which a rebuild takes
            ``handoff_factory`` in place of ``algorithm_factory`` (e.g. a
            low-memory track past the dense one's reach). Given together
            with ``handoff_factory``.
        handoff_factory: ``pop_size -> GuardedAlgorithm`` used at or past
            ``handoff_pop``.
    """

    def __init__(
        self,
        algorithm_factory,
        max_restarts: int = 4,
        growth: int = 2,
        check_every: int = 50,
        stagnation_limit: Optional[int] = None,
        handoff_pop: Optional[int] = None,
        handoff_factory=None,
    ):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if growth < 2:
            raise ValueError(f"growth must be >= 2, got {growth}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if (handoff_pop is None) != (handoff_factory is None):
            raise ValueError("handoff_pop and handoff_factory must be given together")
        self.algorithm_factory = algorithm_factory
        self.max_restarts = max_restarts
        self.growth = growth
        self.check_every = check_every
        self.stagnation_limit = stagnation_limit
        self.handoff_pop = handoff_pop
        self.handoff_factory = handoff_factory

    def uses_handoff(self, pop_size: int) -> bool:
        """Whether a (re)build at ``pop_size`` takes the handoff factory."""
        return self.handoff_pop is not None and pop_size >= self.handoff_pop

    def make_algorithm(self, pop_size: int) -> GuardedAlgorithm:
        factory = self.handoff_factory if self.uses_handoff(pop_size) else self.algorithm_factory
        algo = factory(pop_size)
        if not isinstance(algo, GuardedAlgorithm):
            raise TypeError(
                "IPOPRestarts factories must return a GuardedAlgorithm (the "
                f"detector the host boundary reads); got {type(algo).__name__}"
            )
        return algo
