"""BiGE (Li, Yang & Liu 2015): bi-goal evolution — the port of
``evox_tpu/algorithms/mo/bige.py``.

The objectives map to two meta-goals, proximity and crowding degree, and
Pareto selection runs in that bi-goal space:

- an asymmetric sharing function: neighbours of better (or equal)
  proximity count two or three times toward a row's crowding degree,
  within the radius ``r = 1 / n^(1/m)``;
- mating: a tournament on the bi-goal non-dominated rank of the parents;
- selection keeps the fronts better than the cut one outright and ranks
  only the cut front in bi-goal space.

``packed_dominance`` runs three times a generation: on the parents' bi-goals
in the mating, on the merged objectives and on the cut front's bi-goals in
the selection. The crowding degree's sum over rows is added in a fixed
order and its root correctly rounded, so the card and the CPU agree.
"""

from __future__ import annotations

import torch

from ...operators.selection.basic import tournament
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import halving_sum, pairwise_euclidean_dist, sqrt_rn, sum_last
from .common import DrawnGAMOAlgorithm, MOState


def bi_goals(fit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``(n, 2)`` [proximity, crowding degree] of the rows in ``mask``;
    the other rows ``+inf``. The masked minimum and maximum ignore NaNs as
    the JAX package's ``nanmin``/``nanmax`` do (torch has neither):
    ``±inf`` stands in for the rows left out and for NaN objectives."""
    n, m = fit.shape
    n_live = torch.sum(mask)
    r = 1.0 / n_live.to(torch.float32) ** (1.0 / m)
    live = mask[:, None] & ~torch.isnan(fit)
    any_live = live.any(dim=0)
    fmin = torch.where(any_live, torch.amin(torch.where(live, fit, torch.inf), dim=0), torch.nan)
    fmax = torch.where(any_live, torch.amax(torch.where(live, fit, -torch.inf), dim=0), torch.nan)
    f = (fit - fmin) / torch.clamp_min(fmax - fmin, 1e-6)
    f = torch.where(mask[:, None], f, float(m))
    pr = sum_last(f)
    d = pairwise_euclidean_dist(f, f)
    w = 1.0 + (pr[:, None] >= pr[None, :]).to(f.dtype) + (pr[:, None] > pr[None, :]).to(f.dtype)
    sh = ((d < r).to(f.dtype) * 0.5 * (w * (1.0 - d / r))) ** 2
    cd = sqrt_rn(halving_sum(sh, 1) - torch.diagonal(sh))
    bi = torch.stack([pr, cd], dim=1)
    return torch.where(mask[:, None], bi, torch.inf)


class BiGE(DrawnGAMOAlgorithm):
    def mate_with(self, state: MOState, draws: dict) -> torch.Tensor:
        all_live = torch.ones((self.pop_size,), dtype=torch.bool, device=self.device)
        bi_rank = non_dominated_sort(bi_goals(state.fitness, all_live), mesh=self.mesh)
        return tournament(0, state.population, bi_rank.to(torch.float32),
                          contestants=draws["contestants"])

    def select(self, state: MOState, pop: torch.Tensor, fit: torch.Tensor):
        rank = non_dominated_sort(fit, mesh=self.mesh)
        order = torch.argsort(rank, stable=True)
        rank = rank[order]
        pop, fit = pop[order], fit[order]
        last_rank = rank[self.pop_size]
        # bi-goal ranks only on the cut front; better fronts keep -1
        bi_rank = non_dominated_sort(bi_goals(fit, rank == last_rank), mesh=self.mesh)
        fin = torch.where(rank >= last_rank, bi_rank, -1)
        idx = torch.argsort(fin, stable=True)[: self.pop_size]
        return pop[idx], fit[idx]
