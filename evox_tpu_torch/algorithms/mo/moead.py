"""MOEA/D (Zhang & Li 2007) — the port of ``evox_tpu/algorithms/mo/moead.py``.

Das-Dennis weight vectors, each with the T nearest weights as its
neighbourhood; one offspring a subproblem from its own solution and a
random neighbour (SBX, first child, then polynomial mutation); and the
neighbourhood replacement by aggregation value as one batched scatter-min,
as the JAX package does it (order-free, where the reference's loop is
sequential).

**The neighbour table** is built once, in the constructor, as the JAX
package builds it: a stable argsort of each row of the ``x² − 2xyᵀ + y²``
distances between weights. Das-Dennis weights tie in exact arithmetic for
many pairs, so the last bits of those distances decide which tied
neighbours enter the T nearest. The product ``xyᵀ`` is therefore summed
over the objectives in index order by elementwise steps
(:func:`~evox_tpu_torch.utils.common.inner_products`): the table comes out
the same on the card and on the CPU. It can still differ from the JAX
package's table among distances that tie within an ulp (its BLAS rounds
another way); ``interop.set_neighbors`` hands the port JAX's table.

**The replacement** compares aggregation values whose sums run in index
order (:mod:`~evox_tpu_torch.utils.aggregation`), so the card and the CPU
take the same decisions, and a replacement only copies rows.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode, field
from ...operators.sampling.uniform import UniformSampling
from ...utils.aggregation import AggregationFunction
from ...utils.common import float_vector, generator, inner_products, split_seed, sqrt_rn, sum_last
from .common import draw_variation, sbx_first_children, uniform_init

INF = float("inf")
# rows of the distance matrix built at a time: a (2048, 9870) block is 81 MB
NEIGHBOR_CHUNK_ROWS = 2048


def neighbor_table(w: torch.Tensor, T: int, chunk_rows: int = NEIGHBOR_CHUNK_ROWS) -> torch.Tensor:
    """``(n, T)`` int64: each weight's ``T`` nearest weights (itself first),
    the first ``T`` of a stable argsort of its row of ``sqrt(max(x² − 2xyᵀ +
    y², 0))``, built ``chunk_rows`` rows at a time on ``w``'s device."""
    x2 = sum_last(w * w)
    parts = []
    for start in range(0, w.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        sq = x2[rows, None] - 2.0 * inner_products(w[rows], w) + x2[None, :]
        dist = sqrt_rn(torch.clamp_min(sq, 0.0))
        parts.append(torch.argsort(dist, dim=1, stable=True)[:, :T])
    return torch.cat(parts)


class MOEADState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    ideal: torch.Tensor
    offspring: torch.Tensor = field(storage=True)
    seed: int


class MOEAD(Algorithm):
    """``pop_size`` is a request: the population is the number of Das-Dennis
    weight vectors ``UniformSampling(pop_size, n_objs)`` gives (9870 for
    10000 at m = 3). ``device``: ``None`` means ``"cuda"``."""

    def __init__(
        self,
        lb: Any,
        ub: Any,
        n_objs: int,
        pop_size: int,
        aggregate_op: str = "pbi",
        n_neighbors: Optional[int] = None,
        max_replace: int = 4,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.n_objs = n_objs
        w, n = UniformSampling(pop_size, n_objs, device=self.device)()
        self.weights = w
        self.pop_size = n  # the number of weight vectors
        self.T = n_neighbors or min(max(2, n // 5), 20)
        self.neighbors = neighbor_table(w, self.T)
        self.agg = AggregationFunction(aggregate_op)
        # the replacement cap per offspring, at most the neighbourhood
        self.nr = min(max_replace, self.T)

    # -- state ----------------------------------------------------------------
    def _init_population(self, seed: int) -> torch.Tensor:
        """The initial population's one draw."""
        return uniform_init(seed, self.lb, self.ub, self.pop_size)

    def init(self, seed: int) -> MOEADState:
        seed, pop_seed = split_seed(seed)
        pop = self._init_population(pop_seed)
        return MOEADState(
            population=pop,
            fitness=torch.full((self.pop_size, self.n_objs), INF, device=self.device),
            ideal=torch.full((self.n_objs,), INF, device=self.device),
            offspring=pop,
            seed=seed,
        )

    def init_ask(self, state: MOEADState) -> Tuple[torch.Tensor, MOEADState]:
        return state.population, state

    def init_tell(self, state: MOEADState, fitness: torch.Tensor) -> MOEADState:
        return state.replace(fitness=fitness, ideal=torch.amin(fitness, dim=0))

    # -- generation -----------------------------------------------------------
    def _draw(self, seed: int) -> dict:
        """The one draw of a generation: ``picks`` ``(n,)``, the neighbour
        each subproblem mates with, and the variation's draws."""
        n = self.pop_size
        g = generator(seed, self.device)
        picks = torch.randint(0, self.T, (n,), generator=g, device=self.device)
        return {"picks": picks, **draw_variation(g, n, n, self.dim, self.device)}

    def ask(self, state: MOEADState) -> Tuple[torch.Tensor, MOEADState]:
        seed, draw_seed = split_seed(state.seed)
        d = self._draw(draw_seed)
        n = self.pop_size
        # parents: the subproblem's own solution and one random neighbour
        mate = self.neighbors[torch.arange(n, device=self.device), d["picks"]]
        parents = torch.stack([state.population, state.population[mate]], dim=1).reshape(2 * n, self.dim)
        off = sbx_first_children(parents, self.lb, self.ub, d)
        return off, state.replace(offspring=off, seed=seed)

    def aggregation_values(
        self, fitness: torch.Tensor, ideal: torch.Tensor, new_fitness: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(off_val, inc_val)``, each ``(n, T)``: the aggregation value of
        offspring ``i`` and of the incumbent of its ``j``-th neighbour, both
        under that neighbour's weights."""
        nbr = self.neighbors
        w_nbr = self.weights[nbr]  # (n, T, m)
        return self.agg(new_fitness[:, None, :], w_nbr, ideal), self.agg(fitness[nbr], w_nbr, ideal)

    def replacement(
        self, fitness: torch.Tensor, ideal: torch.Tensor, new_fitness: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(replace, winner)``: which subproblems take an offspring, and
        which one (``(n,)`` bool and int64; a winner only where ``replace``).
        Offspring ``i`` may replace any incumbent of its neighbourhood it
        improves, at most ``nr`` of them (its largest improvements); each
        slot takes the improving offspring of least aggregation value, ties
        to the lowest index."""
        n, T = self.pop_size, self.T
        nbr = self.neighbors
        off_val, inc_val = self.aggregation_values(fitness, ideal, new_fitness)
        better = off_val < inc_val
        improvement = torch.where(better, inc_val - off_val, -INF)
        thresh = torch.sort(improvement, dim=1).values[:, -self.nr]  # the nr-th best
        better = better & (improvement >= thresh[:, None])

        flat_slots = nbr.reshape(-1)
        flat_vals = torch.where(better, off_val, INF).reshape(-1)
        best_val = torch.full((n,), INF, device=self.device).scatter_reduce(
            0, flat_slots, flat_vals, reduce="amin", include_self=True)
        cand_idx = torch.arange(n, device=self.device)[:, None].expand(n, T).reshape(-1)
        is_winner = flat_vals == best_val[flat_slots]
        winner = torch.full((n,), n, dtype=torch.int64, device=self.device).scatter_reduce(
            0, flat_slots, torch.where(is_winner, cand_idx, n), reduce="amin", include_self=True)
        # a slot no offspring improves holds inf, and every inf entry would
        # tie as its winner: gate on finiteness
        replace = (winner < n) & torch.isfinite(best_val)
        return replace, torch.where(replace, winner, 0)

    def tell(self, state: MOEADState, fitness: torch.Tensor) -> MOEADState:
        ideal = torch.minimum(state.ideal, torch.amin(fitness, dim=0))
        replace, winner = self.replacement(state.fitness, ideal, fitness)
        population = torch.where(replace[:, None], state.offspring[winner], state.population)
        fit = torch.where(replace[:, None], fitness[winner], state.fitness)
        return state.replace(population=population, fitness=fit, ideal=ideal)
