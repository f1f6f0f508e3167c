"""KnEA (Zhang, Tian & Jin 2015): knee-point driven many-objective EA —
the port of ``evox_tpu/algorithms/mo/knea.py``.

- Each front's extreme hyperplane (solved through the per-objective
  maxima; a diagonal plane when they are singular) and its knees found by
  greedy suppression of neighbours in the order of distance past the plane.
- An adaptive suppression radius ``R = (max - min) r``, with ``r <- r
  exp(-(1 - t / rate) / m)`` carried across fronts and generations (``t``:
  the last front's knee ratio).
- Selection keeps every front better than the cut one, plus the cut
  front's knees, topped up or trimmed by the distance past the plane.
- Mating: a binary tournament on (rank, not a knee, -DW), DW the weighted
  distance to the k nearest neighbours.

The loop over fronts and the greedy loop inside it run on the device; the
number of fronts and their sizes, which set the loops' lengths, are read on
the host once a generation (and ``matrix_rank``'s SVD waits for the card
once a front). Each greedy step is a masked update of the knee
mask, ``kn & ~(near & kn[p])``, not a host ``if``. The non-dominated sort
launches ``packed_dominance`` once a generation.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.device import DeviceLike
from ...operators.selection.basic import tournament_multifit
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import pairwise_euclidean_dist, sum_last
from .common import DrawnGAMOAlgorithm, MOState


class KnEAState(MOState):
    knee: torch.Tensor  # (pop,) bool
    rank: torch.Tensor  # (pop,) int32: the survivors' non-domination ranks
    r: torch.Tensor  # 0-dim: the adaptive radius factor
    t: torch.Tensor  # 0-dim: the knee ratio of the last processed front


def weighted_neighbor_dist(fit: torch.Tensor, k: int) -> torch.Tensor:
    """DW: the distance to the ``k`` nearest neighbours, weighted toward
    those nearest to the neighbourhood's mean distance. Only the ``k + 1``
    smallest distances of each row are needed (the first is the row's own)."""
    dis = pairwise_euclidean_dist(fit, fit)
    neighbor = torch.topk(dis, k + 1, dim=1, largest=False, sorted=True).values[:, 1:]
    avg = sum_last(neighbor) / k
    w = 1.0 / torch.clamp_min(torch.abs(neighbor - avg[:, None]), 1e-12)
    w = w / sum_last(w)[:, None]
    return sum_last(neighbor * w)


def _nanargmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanargmax`` over dim 0: NaN counts as ``-inf``; an all-NaN
    column gives -1."""
    arg = torch.argmax(torch.where(torch.isnan(x), -torch.inf, x), dim=0)
    return torch.where(torch.isnan(x).all(dim=0), -1, arg)


def _nan_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """``jnp.nanmax``/``jnp.nanmin`` over dim 0: NaNs ignored, NaN where a
    column is all NaN."""
    nan = torch.isnan(x)
    fill = -torch.inf if largest else torch.inf
    out = (torch.amax if largest else torch.amin)(torch.where(nan, fill, x), dim=0)
    return torch.where(nan.all(dim=0), torch.nan, out)


def front_plane(f_front: torch.Tensor, m: int) -> torch.Tensor:
    """The normal of the hyperplane through the front's per-objective
    maxima (rows of ``f_front`` outside the front are NaN): ``extreme⁻¹ 1``,
    or the diagonal plane when ``extreme`` is not of full rank."""
    extreme = f_front[_nanargmax(f_front)]  # (m, m)
    ones = torch.ones((m,), dtype=f_front.dtype, device=f_front.device)
    plane = torch.linalg.solve_ex(extreme, ones).result
    diag = torch.diag(torch.clamp_min(torch.diagonal(extreme), 1e-6))
    fallback = torch.linalg.solve_ex(diag, ones).result
    ok = torch.linalg.matrix_rank(extreme) == m
    return torch.where(ok, plane, fallback)


def _plane_dot(plane: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``plane @ f.T``, added in objective order."""
    return sum_last(plane * f)


class KnEA(DrawnGAMOAlgorithm):
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, knee_rate: float = 0.5,
                 k_neighbors: int = 3, mesh: Any = None, device: DeviceLike = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        self.knee_rate = knee_rate
        self.k_neighbors = k_neighbors

    def init(self, seed: int) -> KnEAState:
        base = super().init(seed)
        dev = self.device
        return KnEAState(population=base.population, fitness=base.fitness,
                         offspring=base.offspring, seed=base.seed,
                         knee=torch.zeros((self.pop_size,), dtype=torch.bool, device=dev),
                         rank=torch.zeros((self.pop_size,), dtype=torch.int32, device=dev),
                         r=torch.ones((), device=dev), t=torch.zeros((), device=dev))

    def init_tell(self, state: KnEAState, fitness: torch.Tensor) -> KnEAState:
        return state.replace(fitness=fitness, rank=non_dominated_sort(fitness, mesh=self.mesh))

    def mate_with(self, state: KnEAState, draws: dict) -> torch.Tensor:
        dw = weighted_neighbor_dist(state.fitness, self.k_neighbors)
        keys = torch.stack([state.rank.to(torch.float32), (~state.knee).to(torch.float32), -dw], dim=1)
        return tournament_multifit(0, state.population, keys, contestants=draws["contestants"])

    def find_knees(self, fit_sel: torch.Tensor, rank: torch.Tensor, sizes: list, r: torch.Tensor,
                   t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(knee, r, t, plane)`` after the fronts ``0 .. len(sizes) - 1``
        (their sizes on the host), front by front: ``r`` and ``t`` carry
        from one front to the next."""
        n, m = fit_sel.shape
        knee = torch.ones((n,), dtype=torch.bool, device=fit_sel.device)
        plane = torch.full((m,), torch.nan, device=fit_sel.device)
        for i, size in enumerate(sizes):
            in_front = rank == i
            f_i = torch.where(in_front[:, None], fit_sel, torch.nan)
            mx = _nan_extreme(f_i, largest=True)
            mn = _nan_extreme(f_i, largest=False)
            plane = front_plane(f_i, m)
            order_i = torch.argsort(_plane_dot(plane, f_i), stable=True)  # NaNs last
            r = r * torch.exp(-(1.0 - t / self.knee_rate) / m)
            R = (mx - mn) * r
            for j in range(size):
                p = order_i[j : j + 1]
                near = torch.all(torch.abs(f_i - f_i[p]) < R, dim=1)
                near.index_fill_(0, p, False)
                knee &= ~(near & knee[p])
            t = torch.sum(in_front & knee) / max(size, 1)
        return knee, r, t, plane

    def sorted_fronts(self, merged_fit: torch.Tensor):
        """``(order, rank, last_rank, sizes)``: the rows by rank (a stable
        sort), their ranks, the cut rank and the sizes of fronts 0 ..
        ``last_rank`` — the last two in the one host read of a generation."""
        n = merged_fit.shape[0]
        dev = merged_fit.device
        rank = non_dominated_sort(merged_fit, mesh=self.mesh)
        order = torch.argsort(rank, stable=True)
        rank = rank[order]
        sizes = torch.zeros((n + 1,), dtype=torch.int64, device=dev).index_add_(
            0, rank.to(torch.int64), torch.ones((n,), dtype=torch.int64, device=dev))
        head = torch.cat([rank[self.pop_size : self.pop_size + 1].to(torch.int64), sizes]).tolist()
        return order, rank, head[0], head[1 : head[0] + 2]

    def tell(self, state: KnEAState, fitness: torch.Tensor) -> KnEAState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        n = merged_fit.shape[0]
        dev = merged_fit.device

        order, rank, last_rank, sizes = self.sorted_fronts(merged_fit)
        pop = merged_pop[order]
        fit = merged_fit[order]
        fit_sel = torch.where((rank <= last_rank)[:, None], fit, torch.nan)

        knee, r, t, plane = self.find_knees(fit_sel, rank, sizes, state.r, state.t)
        knee = knee & (rank <= last_rank)

        # environmental selection: trim or top up the cut front (each a no-op
        # when the count is already right or off the other way)
        selected = (rank < last_rank) | knee
        dif = torch.sum(selected) - self.pop_size
        in_cut = rank == last_rank
        plane_dist = _plane_dot(plane, torch.where(torch.isnan(fit_sel), 0.0, fit_sel))
        ar = torch.arange(n, device=dev)
        sink = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        # too many: drop the cut front's knees nearest the plane first
        drop = torch.argsort(torch.where(knee & in_cut, -plane_dist, torch.inf), stable=True)
        sel = torch.cat([selected, sink[:1]])
        sel[torch.where(ar < dif, drop, n)] = False
        # too few: add the cut front's other rows farthest past the plane
        add = torch.argsort(torch.where(~knee & in_cut, plane_dist, torch.inf), stable=True)
        sel[torch.where(ar < -dif, add, n)] = True
        selected = sel[:n]
        idx = torch.sort(torch.where(selected, ar, n)).values[: self.pop_size]
        return state.replace(population=pop[idx], fitness=fit[idx], knee=knee[idx],
                             rank=rank[idx], r=r, t=t)
