"""Abstract Algorithm: the ask–evaluate–tell contract.

The port of ``evox_tpu/core/algorithm.py``. The algorithm object holds only
hyperparameters (and its device); all mutable data lives in a frozen state
dataclass returned by ``init`` and threaded through ``ask``/``tell``.
Optional ``init_ask``/``init_tell`` overrides serve algorithms whose first
generation differs from the steady state; workflows detect them by method
override, as the JAX package does. ``migrate`` ingests foreign individuals
(island migration); its default serves population-based states.

Stacked members (:mod:`evox_tpu_torch.core.members`): every method whose
name starts with ``_draw`` takes one host seed and returns that seed's
draws. Given a stacked state's member seeds it makes each member's draw
from its own seed and hands each member its row, whether the method is the
class's or one a test put on the instance. ``stackable = False`` marks an
algorithm whose ``ask`` or ``tell`` cannot run under ``torch.func.vmap``
(a host read of the device); its members then run one by one.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch

AlgorithmState = Any


def _member_seeded(fn: Callable, method: bool) -> Callable:
    """``fn`` (a draw method, or a draw function put on an instance) mapped
    over member seeds member by member."""
    if getattr(fn, "_member_seeded", False):
        return fn

    @functools.wraps(fn)
    def draw(*args: Any, **kwargs: Any) -> Any:
        from .members import MemberSeeds, member_draw

        at = 1 if method else 0
        seed = args[at] if len(args) > at else None
        if isinstance(seed, MemberSeeds):
            head, tail = args[:at], args[at + 1:]
            return member_draw(lambda s: fn(*head, s, *tail, **kwargs), seed)
        return fn(*args, **kwargs)

    draw._member_seeded = True
    return draw


class Algorithm:
    """Base class for every optimization algorithm.

    Contract::

        state = algo.init(seed)                # build initial state
        pop, state = algo.ask(state)           # propose candidates
        state = algo.tell(state, fitness)      # ingest fitness of `pop`

    ``ask`` returns a ``(pop_size, ...)`` candidate tensor. ``tell`` receives
    fitness of shape ``(pop_size,)`` (single objective) or
    ``(pop_size, n_objectives)``. ``seed`` is a Python integer: the port's
    random streams are ``torch.Generator``s seeded from integers held in
    the state.
    """

    #: whether ``ask``/``tell``/``migrate`` run under ``torch.func.vmap`` for
    #: stacked members (``core.members.member_call``); ``False`` runs the
    #: members one by one
    stackable = True

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        for name, attr in list(vars(cls).items()):
            if name.startswith("_draw") and callable(attr) and not isinstance(attr, (staticmethod, classmethod)):
                setattr(cls, name, _member_seeded(attr, method=True))

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_draw") and callable(value):
            value = _member_seeded(value, method=False)
        object.__setattr__(self, name, value)

    def init(self, seed: int) -> AlgorithmState:
        raise NotImplementedError

    def ask(self, state: AlgorithmState) -> Tuple[Any, AlgorithmState]:
        raise NotImplementedError

    def tell(self, state: AlgorithmState, fitness: torch.Tensor) -> AlgorithmState:
        raise NotImplementedError

    # -- optional first-generation hooks ------------------------------------
    def init_ask(self, state: AlgorithmState) -> Tuple[Any, AlgorithmState]:
        """Candidates for the very first evaluation. Default: ``ask``."""
        return self.ask(state)

    def init_tell(self, state: AlgorithmState, fitness: torch.Tensor) -> AlgorithmState:
        """Ingest the very first fitness batch. Default: ``tell``."""
        return self.tell(state, fitness)

    @property
    def has_init_ask(self) -> bool:
        return type(self).init_ask is not Algorithm.init_ask

    @property
    def has_init_tell(self) -> bool:
        return type(self).init_tell is not Algorithm.init_tell

    # -- optional migration hook --------------------------------------------
    def migrate(self, state: AlgorithmState, pop: Any, fitness: torch.Tensor) -> AlgorithmState:
        """Ingest foreign individuals (``IslandWorkflow``'s ring migration).

        ``fitness`` is in the internal minimization convention. The default
        offers each migrant to the worst rows of ``state.population`` /
        ``state.fitness`` (a stable descending sort, as ``jnp.argsort`` of
        the negated fitness), accepting only migrants that beat the row
        they would displace: elitist acceptance, so a bad migrant cannot
        overwrite a better row. Enough for every population-based
        single-objective state carrying those two fields; algorithms with
        more per-individual bookkeeping (personal bests, archives) or
        multi-objective selection override it.
        """
        pop_arr = getattr(state, "population", None)
        fit_arr = getattr(state, "fitness", None)
        if pop_arr is None or fit_arr is None or fit_arr.ndim != 1:
            raise NotImplementedError(
                f"{type(self).__name__} has no (population, 1-d fitness) "
                "state fields; override migrate() to support migration"
            )
        k = fitness.shape[0]
        worst = torch.argsort(-fit_arr, stable=True)[:k]
        accept = fitness < fit_arr[worst]  # (k,) per-row elitism
        new_rows = torch.where(accept[:, None], pop, pop_arr[worst])
        new_fit = torch.where(accept, fitness, fit_arr[worst])
        return state.replace(
            population=pop_arr.index_put((worst,), new_rows),
            fitness=fit_arr.index_put((worst,), new_fit),
        )
