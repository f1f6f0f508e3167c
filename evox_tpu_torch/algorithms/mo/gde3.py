"""GDE3 (Kukkonen & Lampinen 2005): the third-generation multi-objective
differential evolution — the port of ``evox_tpu/algorithms/mo/gde3.py``.

DE/rand/1/bin trials, one per parent, then a pairwise pre-selection: a
trial that the parent dominates, or a parent that its trial dominates, gets
``+inf`` fitness, and the merged parents and trials go through
:func:`~evox_tpu_torch.operators.selection.non_dominate` (rank and
crowding; one ``packed_dominance`` launch a generation on the card). The
``+inf`` rows are dominated by every finite row, so they rank last; their
crowding terms are ``inf - inf = NaN``, which the crowding distance turns
to 0 as the JAX package's does. The draws of a generation come from one
``_draw`` method.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ...core.device import DeviceLike
from ...operators.selection.non_dominate import non_dominate
from ...utils.common import generator, split_seed
from ..so.de.de import select_rand_indices
from .common import GAMOAlgorithm, MOState


def pairwise_dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(n,)``: row ``i`` of ``a`` Pareto-dominates row ``i`` of ``b``
    (minimisation; a NaN objective makes it false)."""
    return torch.all(a <= b, dim=1) & torch.any(a < b, dim=1)


class GDE3(GAMOAlgorithm):
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, F: float = 0.5,
                 CR: float = 0.3, mesh: Any = None, device: DeviceLike = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        self.F = F
        self.CR = CR

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws: ``idx`` ``(pop, 3)`` distinct other rows,
        ``u_cr`` ``(pop, dim)`` uniforms and ``j_rand`` ``(pop, 1)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        return {"idx": select_rand_indices(s_idx, n, 3, dev),
                "u_cr": torch.rand((n, d), generator=g, device=dev),
                "j_rand": torch.randint(0, d, (n, 1), generator=g, device=dev)}

    def ask(self, state: MOState) -> Tuple[torch.Tensor, MOState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop, idx = state.population, draws["idx"]
        mutant = pop[idx[:, 0]] + self.F * (pop[idx[:, 1]] - pop[idx[:, 2]])
        cols = torch.arange(self.dim, device=pop.device)
        mask = (draws["u_cr"] < self.CR) | (cols == draws["j_rand"])
        trials = torch.clamp(torch.where(mask, mutant, pop), self.lb, self.ub)
        return trials, state.replace(offspring=trials, seed=seed)

    def tell(self, state: MOState, fitness: torch.Tensor) -> MOState:
        # a trial its parent dominates, or a parent its trial dominates,
        # goes to +inf; mutually non-dominated pairs both enter the pool
        parent_dom = pairwise_dominates(state.fitness, fitness)
        trial_dom = pairwise_dominates(fitness, state.fitness)
        par_fit = torch.where(trial_dom[:, None], torch.inf, state.fitness)
        tri_fit = torch.where(parent_dom[:, None], torch.inf, fitness)
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([par_fit, tri_fit])
        pop, fit = non_dominate(merged_pop, merged_fit, self.pop_size, mesh=self.mesh)
        return state.replace(population=pop, fitness=fit)
