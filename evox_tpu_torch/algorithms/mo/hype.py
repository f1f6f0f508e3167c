"""HypE (Bader & Zitzler 2011): hypervolume-estimation based many-objective
EA — the port of ``evox_tpu/algorithms/mo/hype.py``.

- Environmental selection: non-dominated rank first, the hypervolume
  score breaking ties on the cut front (one ``packed_dominance`` launch a
  generation).
- The sampling reference point is fixed at the first generation (1.2 times
  the largest objective) and carried in the state.
- Mating: a tournament on (rank, -score) of the population.
- Scores: m 2 takes the exact leave-one-out contribution within each front
  (a sorted sweep); m 3 the exact contribution through
  ``metrics/hypervolume.py::hypervolume_contributions`` grouped by rank, up
  to ``exact_hv_max_n`` rows; otherwise the Monte Carlo estimate of
  :func:`hype_fitness` over ``n_samples`` uniform points.

Every draw of a generation comes from one ``_draw`` method: the
tournament's contestants, the mating score's and the selection's Monte
Carlo uniforms, and the variation's. ``ask`` keeps the selection's uniforms
in the state for ``tell``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...core.device import DeviceLike
from ...metrics.hypervolume import hypervolume_contributions
from ...operators.selection.basic import tournament_multifit
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import generator, lexsort
from .common import DrawnGAMOAlgorithm, MOState, draw_ga


def hype_fitness(seed: int, fit: torch.Tensor, ref: torch.Tensor, k: int, n_samples: int = 8192,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Monte Carlo HypE fitness: the expected hypervolume share each row
    would lose if the ``k`` worst were removed (higher is better). ``u``:
    the ``(n_samples, m)`` uniform draw, drawn from ``seed`` when not
    given."""
    n, m = fit.shape
    dev = fit.device
    lo = torch.amin(fit, dim=0)
    if u is None:
        u = torch.rand((n_samples, m), generator=generator(seed, dev), device=dev)
    samples = u * (ref - lo) + lo
    # dominated[s, i]: sample s is dominated by row i
    dominated = fit[None, :, 0] <= samples[:, None, 0]
    for j in range(1, m):
        dominated &= fit[None, :, j] <= samples[:, None, j]
    count = torch.sum(dominated, dim=1)  # how many rows cover each sample
    j = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    ratios = torch.cat([torch.ones((1,), device=dev), (k - j[:-1]) / (n - j[:-1])])
    alpha = torch.where(j <= k, torch.cumprod(ratios, dim=0) / j, 0.0)
    w = torch.where(count > 0, alpha[torch.clamp(count - 1, 0, n - 1)], 0.0)
    return torch.sum(dominated * w[:, None], dim=0)


def exact_contrib_3d(fit: torch.Tensor, ref: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Exact leave-one-out contributions for m = 3 within each front."""
    return hypervolume_contributions(fit, ref, group=rank)


def exact_contrib_2d(fit: torch.Tensor, ref: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Exact leave-one-out contributions for m = 2 within each front: one
    sweep sorted by (rank, f0); inside a front f1 does not rise, so each
    point's box is closed by its sorted neighbours and by ``ref``."""
    n = fit.shape[0]
    dev = fit.device
    order = lexsort((fit[:, 0], rank))
    sf = fit[order]
    grp = rank[order]
    same = grp[1:] == grp[:-1]
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    same_next = torch.cat([same, no])
    same_prev = torch.cat([no, same])
    next_f0 = torch.where(same_next, torch.roll(sf[:, 0], -1), ref[0])
    prev_f1 = torch.where(same_prev, torch.roll(sf[:, 1], 1), ref[1])
    contrib = torch.clamp_min(next_f0 - sf[:, 0], 0.0) * torch.clamp_min(prev_f1 - sf[:, 1], 0.0)
    return torch.zeros((n,), dtype=fit.dtype, device=dev).index_copy(0, order, contrib)


class HypEState(MOState):
    ref_point: torch.Tensor  # (m,) the fixed sampling reference
    rank: torch.Tensor  # (pop,) int32: the survivors' non-domination ranks
    u_select: Optional[torch.Tensor] = None  # the next tell's Monte Carlo uniforms


class HypE(DrawnGAMOAlgorithm):
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, n_samples: int = 8192,
                 mesh: Any = None, exact_hv_max_n: int = 512, device: DeviceLike = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        self.n_samples = n_samples
        # m 3's exact contributions are O(n^3 log n): exact up to this many
        # rows, Monte Carlo beyond; 0 forces Monte Carlo
        self.exact_hv_max_n = exact_hv_max_n

    def init(self, seed: int) -> HypEState:
        base = super().init(seed)
        return HypEState(population=base.population, fitness=base.fitness,
                         offspring=base.offspring, seed=base.seed,
                         ref_point=torch.zeros((self.n_objs,), device=self.device),
                         rank=torch.zeros((self.pop_size,), dtype=torch.int32, device=self.device))

    def init_tell(self, state: HypEState, fitness: torch.Tensor) -> HypEState:
        ref = (torch.amax(fitness) * 1.2).repeat(self.n_objs)
        return state.replace(fitness=fitness, ref_point=ref,
                             rank=non_dominated_sort(fitness, mesh=self.mesh))

    def _monte_carlo(self, rows: int) -> bool:
        return not (self.n_objs == 2 or (self.n_objs == 3 and rows <= self.exact_hv_max_n))

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """:func:`draw_ga`'s draws, plus ``u_mate`` and ``u_select``, the
        ``(n_samples, m)`` Monte Carlo uniforms of the mating score and of
        the selection (drawn only where the score is estimated)."""
        n, d, m, dev = self.pop_size, self.dim, self.n_objs, self.device
        g = generator(seed, dev)
        draws = draw_ga(g, n, d, dev)
        for name, rows in (("u_mate", n), ("u_select", 2 * n)):
            if self._monte_carlo(rows):
                draws[name] = torch.rand((self.n_samples, m), generator=g, device=dev)
        return draws

    def _score(self, fit: torch.Tensor, ref: torch.Tensor, rank: torch.Tensor, k: int,
               u: Optional[torch.Tensor]) -> torch.Tensor:
        if self.n_objs == 2:
            return exact_contrib_2d(fit, ref, rank)
        if not self._monte_carlo(fit.shape[0]):
            return exact_contrib_3d(fit, ref, rank)
        return hype_fitness(0, fit, ref, k, self.n_samples, u=u)

    def mate_with(self, state: HypEState, draws: dict) -> torch.Tensor:
        score = self._score(state.fitness, state.ref_point, state.rank, self.pop_size,
                            draws.get("u_mate"))
        # rank first, so dominated parents keep the pressure toward the front
        keys = torch.stack([state.rank.to(torch.float32), -score], dim=1)
        return tournament_multifit(0, state.population, keys, contestants=draws["contestants"])

    def after_ask(self, state: HypEState, draws: dict) -> HypEState:
        return state.replace(u_select=draws.get("u_select"))

    def tell(self, state: HypEState, fitness: torch.Tensor) -> HypEState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        k_remove = merged_fit.shape[0] - self.pop_size
        if self._monte_carlo(merged_fit.shape[0]) and state.u_select is None:
            raise ValueError("HypE.tell needs the state that HypE.ask returned")
        rank = non_dominated_sort(merged_fit, mesh=self.mesh)
        cut_rank = torch.sort(rank).values[self.pop_size]
        score = self._score(merged_fit, state.ref_point, rank, k_remove, state.u_select)
        # rank first, the score breaking ties on the cut front
        dis = torch.where(rank == cut_rank, score, -torch.inf)
        idx = lexsort((-dis, rank))[: self.pop_size]
        return state.replace(population=merged_pop[idx], fitness=merged_fit[idx], rank=rank[idx],
                             u_select=None)
