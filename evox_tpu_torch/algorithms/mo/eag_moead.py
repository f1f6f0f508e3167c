"""EAG-MOEA/D (Cai, Li & Fan 2014): external-archive guided MOEA/D — the port
of ``evox_tpu/algorithms/mo/eag_moead.py``.

- Subproblem sampling by success: subproblem ``i`` is worked on with a
  probability that follows its archive admissions over the last
  ``learning_period`` generations, floored at 0.002.
- Both parents come from the sampled subproblem's neighbourhood.
- The inner population takes MOEA/D's neighbourhood replacement by
  weighted sum, offspring by offspring: order-dependent, so sequential.
- The external archive is NSGA-II environmental selection over archive and
  offspring (``non_dominate_indices``: the dominance kernel on the card);
  each admitted offspring credits the subproblem it came from.

The sequential replacement runs as a Python loop over the offspring with
no host read: each subproblem's aggregation value under its own weights is
kept in a vector and updated in place, since the weighted sum of a slot's
incumbent is all the loop compares with (the JAX package recomputes it from
the incumbent's fitness: the same numbers). About seven small launches an
offspring.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.struct import PyTreeNode, field
from ...operators.selection.non_dominate import non_dominate_indices
from ...utils.common import generator, split_seed
from .common import draw_variation, sbx_first_children, weighted_indices
from .moead import INF, MOEAD


class EAGMOEADState(PyTreeNode):
    population: torch.Tensor = field(storage=True)  # the external archive (the algorithm's output)
    fitness: torch.Tensor = field(storage=True)
    inner_pop: torch.Tensor = field(storage=True)  # MOEA/D's working population
    inner_fit: torch.Tensor = field(storage=True)
    success: torch.Tensor  # (LP, n) archive admissions per subproblem
    offspring: torch.Tensor = field(storage=True)
    offspring_loc: torch.Tensor = field(storage=True)  # (n,) the subproblem each offspring came from
    gen: int
    seed: int


class EAGMOEAD(MOEAD):

    # not under torch.func.vmap: its archive update writes with in-place
    # index_put_ into unbatched tensors; stacked members run one by one
    stackable = False
    def __init__(self, *args: Any, learning_period: int = 8, **kwargs: Any):
        kwargs.setdefault("aggregate_op", "weighted_sum")
        if kwargs["aggregate_op"] != "weighted_sum":
            # tell() tracks no ideal point, which the other aggregations need
            raise ValueError(
                "EAGMOEAD supports only aggregate_op='weighted_sum' "
                "(the paper's formulation)"
            )
        super().__init__(*args, **kwargs)
        self.LP = learning_period

    def init(self, seed: int) -> EAGMOEADState:
        base = super().init(seed)
        n = self.pop_size
        return EAGMOEADState(
            population=base.population,
            fitness=torch.full((n, self.n_objs), INF, device=self.device),
            inner_pop=base.population,
            inner_fit=torch.full((n, self.n_objs), INF, device=self.device),
            success=torch.zeros((self.LP, n), device=self.device),
            offspring=base.population,
            offspring_loc=torch.zeros((n,), dtype=torch.int32, device=self.device),
            gen=0,
            seed=base.seed,
        )

    def init_tell(self, state: EAGMOEADState, fitness: torch.Tensor) -> EAGMOEADState:
        return state.replace(fitness=fitness, inner_fit=fitness)

    def _draw(self, seed: int) -> dict:
        """``u_sub`` ``(n,)``, the uniform draw of the subproblems; ``i1``,
        ``i2`` ``(n,)``, the parents' places in their neighbourhoods; the
        variation's draws."""
        n = self.pop_size
        g = generator(seed, self.device)
        u_sub = torch.rand((n,), generator=g, device=self.device)
        i1 = torch.randint(0, self.T, (n,), generator=g, device=self.device)
        i2 = torch.randint(0, self.T, (n,), generator=g, device=self.device)
        return {"u_sub": u_sub, "i1": i1, "i2": i2, **draw_variation(g, n, n, self.dim, self.device)}

    def ask(self, state: EAGMOEADState) -> Tuple[torch.Tensor, EAGMOEADState]:
        seed, draw_seed = split_seed(state.seed)
        # subproblems by admission success, floored so cold ones are explored
        s = torch.sum(state.success, dim=0) + 1e-6
        d = s / torch.sum(s) + 0.002
        draws = self._draw(draw_seed)
        n = self.pop_size
        sub = weighted_indices(d / torch.sum(d), draws["u_sub"])
        p1 = self.neighbors[sub, draws["i1"]]
        p2 = self.neighbors[sub, draws["i2"]]
        parents = torch.stack([state.inner_pop[p1], state.inner_pop[p2]], dim=1).reshape(2 * n, self.dim)
        off = sbx_first_children(parents, self.lb, self.ub, draws)
        return off, state.replace(offspring=off, offspring_loc=sub.to(torch.int32), seed=seed)

    def sequential_replacement(
        self, inner_fit: torch.Tensor, fitness: torch.Tensor, loc: torch.Tensor
    ) -> torch.Tensor:
        """``(n,)`` int64: the offspring each inner slot holds after offspring
        ``0 .. n-1`` in turn replace every incumbent of their origin
        subproblem's neighbourhood that they improve by weighted sum (-1:
        the slot keeps its incumbent)."""
        n = self.pop_size
        zeros = torch.zeros((self.n_objs,), device=self.device)  # weighted_sum ignores it
        nbr_loc = self.neighbors[loc.to(torch.int64)]  # (n, T)
        # each offspring's value under each neighbour's weights, and each
        # slot's incumbent's value under its own: all the loop compares
        g_new = self.agg(fitness[:, None, :], self.weights[nbr_loc], zeros)  # (n, T)
        value = self.agg(inner_fit, self.weights, zeros)  # (n,)
        owner = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        for i in range(n):
            idx = nbr_loc[i]
            old = value[idx]
            replace = g_new[i] < old
            value[idx] = torch.where(replace, g_new[i], old)
            owner[idx] = torch.where(replace, i, owner[idx])
        return owner

    def tell(self, state: EAGMOEADState, fitness: torch.Tensor) -> EAGMOEADState:
        n = self.pop_size
        owner = self.sequential_replacement(state.inner_fit, fitness, state.offspring_loc)
        taken = owner >= 0
        src = torch.clamp_min(owner, 0)
        inner_pop = torch.where(taken[:, None], state.offspring[src], state.inner_pop)
        inner_fit = torch.where(taken[:, None], fitness[src], state.inner_fit)

        # the external archive: environmental selection over archive + offspring
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        keep = non_dominate_indices(merged_fit, n)
        admitted = keep >= n  # kept rows that are offspring
        # credit each admitted offspring's origin subproblem (slot n: dropped)
        adm_loc = torch.where(admitted, state.offspring_loc[torch.clamp(keep - n, 0, n - 1)].to(torch.int64), n)
        hist = torch.zeros((n + 1,), device=self.device).index_add_(
            0, adm_loc, torch.ones((n,), device=self.device))[:n]
        success = state.success.clone()
        success[state.gen % self.LP] = hist
        return state.replace(
            population=merged_pop[keep],
            fitness=merged_fit[keep],
            inner_pop=inner_pop,
            inner_fit=inner_fit,
            success=success,
            gen=state.gen + 1,
        )
