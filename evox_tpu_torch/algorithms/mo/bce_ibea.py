"""BCE-IBEA (Li, Yang & Liu 2016): the bi-criterion evolution framework
with IBEA as its non-Pareto-criterion (NPC) evolution — the port of
``evox_tpu/algorithms/mo/bce_ibea.py``.

- Generations alternate by the parity of a counter, a host integer here:
  odd generations explore from the Pareto-criterion (PC) population, even
  ones evolve the NPC population by IBEA's tournament and variation. No
  parity is read from the device.
- Exploration: only PC members with at most one NPC neighbour inside the
  adaptive radius ``r = (n_nd / n) r0`` spawn offspring, mated with random
  partners.
- PC selection: the non-dominated rows (one ``packed_dominance`` launch,
  the sort stopped after the first front); when they exceed the budget, the
  most crowded by the product of scaled distances goes, one at a time. The
  number of removals is read on the host, once a selection.
- The NPC population goes through IBEA's worst removal in both phases.

The JAX package's deliberate deviation is kept: its even-phase PC
selection pairs the PC population with the PC population's own objectives.
Every draw of a generation comes from one ``_draw(seed, even)`` method.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...core.struct import PyTreeNode, field
from ...operators.crossover.sbx import simulated_binary
from ...operators.mutation.ops import polynomial
from ...operators.selection.basic import tournament
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import generator, pairwise_euclidean_dist, split_seed
from .common import draw_ga, draw_variation, ga_offspring
from .ibea import IBEA, ibea_fitness


def _no_self_no_nan(dist: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(dist.shape[0], dtype=torch.bool, device=dist.device)
    return torch.where(eye | torch.isnan(dist), torch.inf, dist)


def exploration(pc_fit: torch.Tensor, npc_fit: torch.Tensor, n_nd: torch.Tensor, n: int) -> torch.Tensor:
    """``(n,)`` bool: PC members in regions the NPC population has not
    reached (at most one NPC row within the adaptive radius)."""
    f_min = torch.amin(pc_fit, dim=0)
    f_max = torch.amax(pc_fit, dim=0)
    span = torch.clamp_min(f_max - f_min, 1e-12)
    pc_n = (pc_fit - f_min) / span
    npc_n = (npc_fit - f_min) / span
    sd = torch.sort(_no_self_no_nan(pairwise_euclidean_dist(pc_n, pc_n)), dim=1).values
    r0 = torch.mean(sd[:, min(2, sd.shape[1] - 1)])
    r = n_nd / n * r0
    d_cross = pairwise_euclidean_dist(pc_n, npc_n)
    return torch.sum(d_cross <= r, dim=1) <= 1


def pc_selection(pc: torch.Tensor, pc_fit: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(population, fitness, n_nd)``: the non-dominated rows, thinned to
    ``n`` by removing the most crowded one at a time, in index order and
    padded with the first kept row; ``n_nd`` the size of the first front
    (0-dim int32)."""
    rank = non_dominated_sort(pc_fit, until=1)  # only the first front matters
    mask = rank == 0
    n_nd = mask.sum().to(torch.int32)
    removals = int(n_nd) - n  # the one host read: the thinning's length
    if removals > 0:
        mask = pc_thinning(pc_fit, mask, n_nd, removals)
    rows = mask.shape[0]
    kept = torch.argsort((~mask).to(torch.int8), stable=True)
    count = mask.sum()
    first = torch.where(count > 0, kept[0], rows - 1)
    idx = torch.where(torch.arange(rows, device=mask.device) < count, kept, first)[:n]
    return pc[idx], pc_fit[idx], n_nd


def pc_thinning(pc_fit: torch.Tensor, mask: torch.Tensor, n_nd: torch.Tensor,
                removals: int) -> torch.Tensor:
    """The non-dominated ``mask`` less its ``removals`` most crowded rows,
    removed one at a time: each step takes the live row of largest ``1 -
    prod`` of its scaled distances and sets its row and column to 1."""
    f_max = torch.amax(torch.where(mask[:, None], pc_fit, -torch.inf), dim=0)
    f_min = torch.amin(torch.where(mask[:, None], pc_fit, torch.inf), dim=0)
    norm = (pc_fit - f_min) / torch.clamp_min(f_max - f_min, 1e-12)
    norm = torch.where(mask[:, None], norm, torch.inf)
    dist = _no_self_no_nan(pairwise_euclidean_dist(norm, norm))
    sd = torch.sort(dist, dim=1).values
    sd = torch.where(mask[:, None], sd, 0.0)
    r = torch.sum(sd[:, min(2, sd.shape[1] - 1)]) / n_nd
    big_r = torch.clamp_max(dist / r, 1.0)
    mask = mask.clone()
    for _ in range(removals):
        crowd = 1.0 - torch.prod(big_r, dim=0)
        idx = torch.argmax(torch.where(mask, crowd, -torch.inf), dim=0, keepdim=True)
        mask.index_fill_(0, idx, False)
        big_r.index_fill_(0, idx, 1.0)
        big_r.index_fill_(1, idx, 1.0)
    return mask


class BCEIBEAState(PyTreeNode):
    population: torch.Tensor = field(storage=True)  # the PC archive (the algorithm's output)
    fitness: torch.Tensor = field(storage=True)
    npc: torch.Tensor = field(storage=True)  # the NPC (IBEA) population
    npc_fit: torch.Tensor = field(storage=True)
    new_pc: torch.Tensor = field(storage=True)  # the exploration's offspring, waiting for the even phase
    new_pc_fit: torch.Tensor = field(storage=True)
    n_nd: torch.Tensor  # 0-dim int32
    counter: int
    offspring: torch.Tensor = field(storage=True)
    seed: int


class BCEIBEA(IBEA):

    # not under torch.func.vmap: its exploration reads a count on the host
    # (.item()); stacked members run one by one
    stackable = False
    def init(self, seed: int) -> BCEIBEAState:
        seed, pop_seed = split_seed(seed)
        pop = self._init_population(pop_seed)
        inf = torch.full((self.pop_size, self.n_objs), torch.inf, device=self.device)
        return BCEIBEAState(
            population=pop, fitness=inf, npc=pop, npc_fit=inf, new_pc=pop, new_pc_fit=inf,
            n_nd=torch.zeros((), dtype=torch.int32, device=self.device), counter=1,
            offspring=pop, seed=seed)

    def init_tell(self, state: BCEIBEAState, fitness: torch.Tensor) -> BCEIBEAState:
        pc, pc_fit, n_nd = pc_selection(state.population, fitness, self.pop_size)
        return state.replace(population=pc, fitness=pc_fit, npc_fit=fitness, new_pc_fit=fitness,
                             n_nd=n_nd)

    def _draw(self, seed: int, even: bool = False) -> Dict[str, torch.Tensor]:
        """An even generation's draws are IBEA's (:func:`draw_ga`); an odd
        one's are the exploration's: ``partner`` ``(pop,)`` rows, SBX over
        ``pop`` pairs and the mutation of ``pop`` children."""
        n, d, dev = self.pop_size, self.dim, self.device
        g = generator(seed, dev)
        if even:
            return draw_ga(g, n, d, dev)
        return {"partner": torch.randint(0, n, (n,), generator=g, device=dev),
                **draw_variation(g, n, n, d, dev)}

    def ask(self, state: BCEIBEAState) -> Tuple[torch.Tensor, BCEIBEAState]:
        seed, k = split_seed(state.seed)
        even = state.counter % 2 == 0
        draws = self._draw(k, even)
        if even:
            # the NPC round: IBEA's tournament and variation
            score = ibea_fitness(state.npc_fit, self.kappa)
            parents = tournament(0, state.npc, -score, contestants=draws["contestants"])
            off = ga_offspring(parents, self.lb, self.ub, draws)
        else:
            # the PC round: sparse PC members mate with random partners; the
            # others propose themselves again
            s = exploration(state.fitness, state.npc_fit, state.n_nd, self.pop_size)
            pop = state.population
            pairs = torch.stack([pop, pop[draws["partner"]]], dim=1).reshape(2 * self.pop_size, self.dim)
            child = simulated_binary(0, pairs, u=draws["u_sbx"])[0::2]
            child = polynomial(0, child, (self.lb, self.ub), site=draws["site"], u=draws["u_pm"])
            off = torch.where(s[:, None], child, pop)
        return off, state.replace(offspring=off, seed=seed)

    def tell(self, state: BCEIBEAState, fitness: torch.Tensor) -> BCEIBEAState:
        # both phases feed the NPC population the same way
        npc, npc_fit = IBEA.select(self, None, torch.cat([state.npc, state.offspring]),
                                   torch.cat([state.npc_fit, fitness]))
        if state.counter % 2 == 0:
            merged_pop = torch.cat([state.population, state.offspring, state.new_pc])
            merged_fit = torch.cat([state.fitness, fitness, state.new_pc_fit])
            pc, pc_fit, n_nd = pc_selection(merged_pop, merged_fit, self.pop_size)
            state = state.replace(population=pc, fitness=pc_fit, n_nd=n_nd)
        else:
            state = state.replace(new_pc=state.offspring, new_pc_fit=fitness)
        return state.replace(npc=npc, npc_fit=npc_fit, counter=state.counter + 1)
