"""MOEA/D variants — the port of ``evox_tpu/algorithms/mo/moead_variants.py``.

- MOEADDRA (Zhang, Liu & Li 2009): MOEA/D with dynamic resource
  allocation. A per-subproblem utility, from the relative improvement of
  its aggregation value every ``utility_update_period`` generations, biases
  the choice of mating parents by a 10-ary tournament (every subproblem
  still gets an offspring, as in the JAX package).
- MOEADM2M (Liu, Gu & Zhang 2014): K direction-based subregions, each
  evolving its own subpopulation of S; each keeps its S best members by
  (Pareto rank, crowding), borrowing the best others when short.

The generation counter is a host integer; the draws of a generation come
from one ``_draw`` method.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode, field
from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.non_dominate import crowding_distance, non_dominated_sort
from ...utils.common import float_vector, generator, inner_products, row_norm, split_seed
from .common import draw_variation, sbx_first_children, uniform_init
from .moead import INF, MOEAD, MOEADState

INT32_MAX = 2**31 - 1


class MOEADDRAState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    ideal: torch.Tensor
    utility: torch.Tensor = field(storage=True)
    old_value: torch.Tensor = field(storage=True)  # each subproblem's aggregation value at the last update
    offspring: torch.Tensor = field(storage=True)
    gen: int
    seed: int


class MOEADDRA(MOEAD):
    def __init__(self, *args: Any, utility_update_period: int = 30, **kwargs: Any):
        kwargs.setdefault("aggregate_op", "tchebycheff")
        super().__init__(*args, **kwargs)
        self.period = utility_update_period

    def init(self, seed: int) -> MOEADDRAState:
        base = super().init(seed)
        return MOEADDRAState(
            population=base.population,
            fitness=base.fitness,
            ideal=base.ideal,
            utility=torch.ones((self.pop_size,), device=self.device),
            old_value=torch.full((self.pop_size,), INF, device=self.device),
            offspring=base.offspring,
            gen=0,
            seed=base.seed,
        )

    def init_tell(self, state: MOEADDRAState, fitness: torch.Tensor) -> MOEADDRAState:
        ideal = torch.amin(fitness, dim=0)
        return state.replace(fitness=fitness, ideal=ideal,
                             old_value=self.agg(fitness, self.weights, ideal))

    def _draw(self, seed: int) -> dict:
        """``cand`` ``(n, 10)``, the tournament's contestants; ``picks`` ``(n,
        2)``, the two parents' places in the winner's neighbourhood; the
        variation's draws."""
        n = self.pop_size
        g = generator(seed, self.device)
        cand = torch.randint(0, n, (n, 10), generator=g, device=self.device)
        picks = torch.randint(0, self.T, (n, 2), generator=g, device=self.device)
        return {"cand": cand, "picks": picks, **draw_variation(g, n, n, self.dim, self.device)}

    def ask(self, state: MOEADDRAState) -> Tuple[torch.Tensor, MOEADDRAState]:
        seed, draw_seed = split_seed(state.seed)
        d = self._draw(draw_seed)
        n = self.pop_size
        # 10-ary tournament on utility: parents from high-utility subproblems
        util = state.utility[d["cand"]]
        chosen = d["cand"][torch.arange(n, device=self.device), torch.argmax(util, dim=1)]
        p = self.neighbors[chosen[:, None], d["picks"]]  # (n, 2)
        off = sbx_first_children(state.population[p.reshape(-1)], self.lb, self.ub, d)
        return off, state.replace(offspring=off, seed=seed)

    def tell(self, state: MOEADDRAState, fitness: torch.Tensor) -> MOEADDRAState:
        base = super().tell(
            MOEADState(population=state.population, fitness=state.fitness, ideal=state.ideal,
                       offspring=state.offspring, seed=state.seed),
            fitness,
        )
        gen = state.gen + 1
        utility, old_value = state.utility, state.old_value
        if gen % self.period == 0:
            value = self.agg(base.fitness, self.weights, base.ideal)
            delta = (old_value - value) / torch.clamp_min(torch.abs(old_value), 1e-12)
            # the DRA rule: back to 1 on real progress, else decay toward 0
            new_util = torch.where(delta > 0.001, 1.0, (0.95 + 0.05 * delta / 0.001) * utility)
            utility, old_value = torch.clamp(new_util, 0.0, 1.0), value
        return state.replace(population=base.population, fitness=base.fitness, ideal=base.ideal,
                             utility=utility, old_value=old_value, gen=gen)


class MOEADM2MState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    offspring: torch.Tensor = field(storage=True)
    seed: int


class MOEADM2M(Algorithm):
    """K = ``k`` subregions (fewer if the simplex lattice has fewer
    directions) of S = max(2, pop_size // k) each. ``device``: ``None`` means
    ``"cuda"``."""

    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, k: int = 10,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.n_objs = n_objs
        self.K = k
        self.S = max(2, pop_size // k)
        self.pop_size = self.K * self.S
        w, nk = UniformSampling(k, n_objs, device=self.device)()
        # the K subregions' unit directions
        self.dirs = (w / row_norm(w)[:, None])[: self.K]
        if nk < self.K:
            self.K = nk
            self.pop_size = self.K * self.S

    def _init_population(self, seed: int) -> torch.Tensor:
        """The initial population's one draw."""
        return uniform_init(seed, self.lb, self.ub, self.pop_size)

    def init(self, seed: int) -> MOEADM2MState:
        seed, pop_seed = split_seed(seed)
        pop = self._init_population(pop_seed)
        return MOEADM2MState(
            population=pop,
            fitness=torch.full((self.pop_size, self.n_objs), INF, device=self.device),
            offspring=pop,
            seed=seed,
        )

    def init_ask(self, state: MOEADM2MState) -> Tuple[torch.Tensor, MOEADM2MState]:
        return state.population, state

    def init_tell(self, state: MOEADM2MState, fitness: torch.Tensor) -> MOEADM2MState:
        return state.replace(fitness=fitness)

    def _draw(self, seed: int) -> dict:
        """``mate`` ``(n,)``, each row's mate's place in its subregion's
        block, and the variation's draws."""
        n = self.pop_size
        g = generator(seed, self.device)
        mate = torch.randint(0, self.S, (n,), generator=g, device=self.device)
        return {"mate": mate, **draw_variation(g, n, n, self.dim, self.device)}

    def ask(self, state: MOEADM2MState) -> Tuple[torch.Tensor, MOEADM2MState]:
        seed, draw_seed = split_seed(state.seed)
        d = self._draw(draw_seed)
        n = self.pop_size
        # mate within each subregion's block (contiguous slices of S rows)
        block = torch.arange(n, device=self.device) // self.S
        mate = d["mate"] + block * self.S
        parents = torch.stack([state.population, state.population[mate]], dim=1).reshape(2 * n, self.dim)
        off = sbx_first_children(parents, self.lb, self.ub, d)
        return off, state.replace(offspring=off, seed=seed)

    def tell(self, state: MOEADM2MState, fitness: torch.Tensor) -> MOEADM2MState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        f = merged_fit - torch.amin(merged_fit, dim=0)
        norm = row_norm(f)[:, None]
        cos = torch.clamp(inner_products(f, self.dirs) / torch.clamp_min(norm, 1e-12), -1.0, 1.0)
        region = torch.argmax(cos, dim=1)  # (2n,)

        # per region: the S best members by (rank, -crowding); a region short
        # of members takes the others by crowding alone (they tie on rank)
        rank = non_dominated_sort(merged_fit)
        crowd = crowding_distance(merged_fit)
        regions = torch.arange(self.K, device=self.device)[:, None]
        key_rank = torch.where(region[None, :] == regions, rank[None, :].to(torch.int64), INT32_MAX)
        # jnp.lexsort((-crowd, key_rank)) in every region: stable sorts,
        # the shared secondary key first
        by_crowd = torch.argsort(-crowd, stable=True)
        order = by_crowd[torch.argsort(key_rank[:, by_crowd], dim=1, stable=True)]
        idx = order[:, : self.S].reshape(-1)
        return state.replace(population=merged_pop[idx], fitness=merged_fit[idx])
