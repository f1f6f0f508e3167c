"""Shared machinery for multi-objective EAs — the port of
``evox_tpu/algorithms/mo/common.py``.

The GA skeleton: uniform init -> evaluate the parents once
(init_ask/init_tell) -> each generation propose offspring by (mating
selection, SBX, polynomial mutation) -> merge parents and offspring ->
environmental selection in ``tell``. :class:`GAMOAlgorithm` captures it;
subclasses implement ``select`` and may override ``mate`` or
``variation``.

Randomness: the state holds an integer ``seed``; ``ask`` splits it into a
mating seed and a variation seed, and each operator draws from its own
``torch.Generator``. The initial population is drawn by
:func:`uniform_init`, through the one method ``_init_population``.
Algorithms with an ``ask`` of their own make every draw of a generation in
one ``_draw`` method (:func:`draw_variation` for the SBX and polynomial
parts), which the tests replace with the JAX package's draws. A draw with
probabilities takes only its uniforms from ``_draw``: ``ask`` works out the
probabilities and turns them into indices by :func:`weighted_indices`, so
both meet the JAX package in the tests. ``blocked_cumsum`` and
``weighted_indices`` live in ``utils/common.py`` and are re-exported here.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode, field
from ...operators.crossover.sbx import simulated_binary
from ...operators.mutation.ops import polynomial
from ...utils.common import (  # noqa: F401  (the cumsum helpers re-exported)
    CUMSUM_BLOCK,
    blocked_cumsum,
    float_vector,
    generator,
    seeded,
    split_seed,
    weighted_indices,
)


class MOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)  # (pop, m)
    offspring: torch.Tensor = field(storage=True)
    seed: int


def uniform_init(
    seed: int, lb: torch.Tensor, ub: torch.Tensor, pop_size: int
) -> torch.Tensor:
    """``(pop_size, dim)`` uniform in ``[lb, ub)``, on ``lb``'s device."""
    u = torch.rand((pop_size, lb.shape[0]), generator=generator(seed, lb.device), device=lb.device)
    return u * (ub - lb) + lb


def draw_variation(g: torch.Generator, n_pairs: int, n_rows: int, dim: int,
                   device: torch.device) -> dict:
    """The draws of SBX over ``n_pairs`` parent pairs (``u_sbx``) and of the
    polynomial mutation of ``n_rows`` rows at its default rate 1/dim
    (``site``, ``u_pm``)."""
    return {
        "u_sbx": torch.rand((n_pairs, dim), generator=g, device=device),
        "site": torch.rand((n_rows, dim), generator=g, device=device) < 1.0 / dim,
        "u_pm": torch.rand((n_rows, dim), generator=g, device=device),
    }


def draw_ga(g: torch.Generator, n: int, dim: int, device: torch.device) -> dict:
    """A GA generation's draws: a binary tournament's ``contestants``
    ``(n, 2)``, then SBX over ``n // 2`` pairs and the polynomial mutation
    of ``n`` rows (:func:`draw_variation`)."""
    return {"contestants": torch.randint(0, n, (n, 2), generator=g, device=device),
            **draw_variation(g, n // 2, n, dim, device)}


def ga_offspring(pool: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor, draws: dict) -> torch.Tensor:
    """``GAMOAlgorithm.variation`` on given draws: SBX over consecutive
    pairs of ``pool`` (both children), then polynomial mutation."""
    off = simulated_binary(0, pool, u=draws["u_sbx"])
    return polynomial(0, off, (lb, ub), site=draws["site"], u=draws["u_pm"])


def sbx_first_children(parents: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
                       draws: dict) -> torch.Tensor:
    """One child per parent pair: SBX over ``parents`` (pairs of consecutive
    rows), the first child of each pair, then polynomial mutation."""
    off = simulated_binary(0, parents, u=draws["u_sbx"])[0::2]
    return polynomial(0, off, (lb, ub), site=draws["site"], u=draws["u_pm"])


class GAMOAlgorithm(Algorithm):
    """GA-skeleton MO base: subclasses implement ``select(state, merged_pop,
    merged_fit) -> (pop, fit)``.

    ``mesh``: a :class:`~evox_tpu_torch.core.distributed.Mesh` with a
    ``"pop"`` axis; the O(n²) non-dominated sort of the tell (and of the
    migration ingest) is then row-sharded over it, one B3 rows launch a
    shard, with the unsharded sort's ranks and survivors. It can also be
    assigned later (``algo.mesh = mesh``). ``device``: ``None`` means
    ``"cuda"``."""

    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, mesh: Any = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.n_objs = n_objs
        self.pop_size = pop_size
        self.mesh = mesh

    # -- state ----------------------------------------------------------------
    def _init_population(self, seed: int) -> torch.Tensor:
        """The initial population's one draw."""
        return uniform_init(seed, self.lb, self.ub, self.pop_size)

    def init(self, seed: int) -> MOState:
        seed, pop_seed = split_seed(seed)
        pop = self._init_population(pop_seed)
        return MOState(
            population=pop,
            fitness=torch.full((self.pop_size, self.n_objs), float("inf"), device=self.device),
            offspring=pop,
            seed=seed,
        )

    def init_ask(self, state: MOState) -> Tuple[torch.Tensor, MOState]:
        return state.population, state

    def init_tell(self, state: MOState, fitness: torch.Tensor) -> MOState:
        return state.replace(fitness=fitness)

    # -- generation -----------------------------------------------------------
    def mate(self, seed: int, state: MOState) -> torch.Tensor:
        """Mating pool (default: a random shuffle of the parents)."""
        idx = seeded(seed, self.device,
                     lambda g: torch.randperm(self.pop_size, generator=g, device=self.device))
        return state.population[idx]

    def variation(self, seed: int, mating_pool: torch.Tensor) -> torch.Tensor:
        s1, s2 = split_seed(seed)
        off = simulated_binary(s1, mating_pool)
        return polynomial(s2, off, (self.lb, self.ub))

    def ask(self, state: MOState) -> Tuple[torch.Tensor, MOState]:
        seed, s_mate, s_var = split_seed(state.seed, 3)
        off = self.variation(s_var, self.mate(s_mate, state))
        return off, state.replace(offspring=off, seed=seed)

    def tell(self, state: MOState, fitness: torch.Tensor) -> MOState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        pop, fit = self.select(state, merged_pop, merged_fit)
        return state.replace(population=pop, fitness=fit)

    # -- migration ------------------------------------------------------------
    def migrate(self, state: MOState, pop: torch.Tensor, fitness: torch.Tensor) -> MOState:
        """Merge migrants into the population and keep the best by NSGA-II
        (rank, crowding) truncation, for every GA-skeleton MOEA. States that
        carry (rank, crowd) mating keys get them refreshed."""
        from ...operators.selection.non_dominate import crowding_distance, rank_crowding_truncate

        merged_pop = torch.cat([state.population, pop])
        merged_fit = torch.cat([state.fitness, fitness])
        order, ranks = rank_crowding_truncate(merged_fit, self.pop_size, mesh=self.mesh)
        fit_sel = merged_fit[order]
        updates = dict(population=merged_pop[order], fitness=fit_sel)
        if hasattr(state, "rank"):
            updates["rank"] = ranks
        if hasattr(state, "crowd"):
            updates["crowd"] = crowding_distance(fit_sel)
        return state.replace(**updates)

    def select(self, state: MOState, pop: torch.Tensor, fit: torch.Tensor):
        raise NotImplementedError


class DrawnGAMOAlgorithm(GAMOAlgorithm):
    """The GA skeleton with every draw of a generation made by one
    ``_draw(seed)`` (by default :func:`draw_ga`), which the tests replace
    with the JAX package's. Subclasses give the mating pool by
    ``mate_with(state, draws)``; ``after_ask(state, draws)`` may keep draws
    that ``tell`` uses in the state."""

    def _draw(self, seed: int) -> dict:
        return draw_ga(generator(seed, self.device), self.pop_size, self.dim, self.device)

    def mate_with(self, state: MOState, draws: dict) -> torch.Tensor:
        raise NotImplementedError

    def after_ask(self, state: MOState, draws: dict) -> MOState:
        return state

    def ask(self, state: MOState) -> Tuple[torch.Tensor, MOState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        off = ga_offspring(self.mate_with(state, draws), self.lb, self.ub, draws)
        return off, self.after_ask(state.replace(offspring=off, seed=seed), draws)
