"""SPEA2 (Zitzler, Laumanns & Thiele 2001): strength-Pareto fitness with a
k-NN density and the classic archive truncation — the port of
``evox_tpu/algorithms/mo/spea2.py``.

When the non-dominated rows overflow the budget, the one with the smallest
nearest-neighbour distance is removed, one at a time, each removal updating
the others' distances (a one-shot sort would delete clustered pairs whole);
otherwise the population fills by ascending fitness. Which branch runs, and
how many removals, is read on the host: one host read a generation. The
removals run on the device. Argsorts are stable, as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...operators.selection.basic import tournament
from ...utils.common import dominate_relation, pairwise_euclidean_dist
from .common import DrawnGAMOAlgorithm, MOState


def masked_dist(fit: torch.Tensor) -> torch.Tensor:
    """Pairwise distances with an inf diagonal."""
    eye = torch.eye(fit.shape[0], dtype=torch.bool, device=fit.device)
    return torch.where(eye, torch.inf, pairwise_euclidean_dist(fit, fit))


def spea2_fitness(fit: torch.Tensor, dist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw strength fitness plus the k-NN density, k = sqrt(n) (lower is
    better; below 1 exactly for the non-dominated rows)."""
    n = fit.shape[0]
    dom = dominate_relation(fit, fit)  # i dominates j
    strength = torch.sum(dom, dim=1).to(torch.float32)  # S(i)
    raw = torch.sum(torch.where(dom, strength[:, None], 0.0), dim=0)  # R(j): integers, exact
    if dist is None:
        dist = masked_dist(fit)
    k = max(1, int(math.sqrt(n)))
    knn = torch.kthvalue(dist, k, dim=1).values
    return raw + 1.0 / (knn + 2.0)


def truncate(dist: torch.Tensor, keep: torch.Tensor, removals: int) -> torch.Tensor:
    """The truncation: ``removals`` times, drop the kept row nearest to
    another kept row (the first on ties; nearest-neighbour distances
    clamped to the largest float, so an all-inf row never wins over a kept
    one), then forget its distances."""
    n = dist.shape[0]
    d = torch.where(keep[:, None] & keep[None, :], dist, torch.inf)
    keep = keep.clone()
    fmax = torch.finfo(d.dtype).max
    for _ in range(removals):
        nn = torch.clamp_max(torch.amin(d, dim=1), fmax)
        idx = torch.argmin(torch.where(keep, nn, torch.inf), dim=0, keepdim=True)
        keep.index_fill_(0, idx, False)
        d.index_fill_(0, idx, torch.inf)
        d.index_fill_(1, idx, torch.inf)
    return keep


class SPEA2(DrawnGAMOAlgorithm):
    def mate_with(self, state: MOState, draws: dict) -> torch.Tensor:
        return tournament(0, state.population, spea2_fitness(state.fitness),
                          contestants=draws["contestants"])

    def select(self, state: MOState, pop: torch.Tensor, fit: torch.Tensor):
        dist = masked_dist(fit)
        score = spea2_fitness(fit, dist)
        nd_mask = score < 1.0  # raw fitness < 1: non-dominated
        n_valid = int(nd_mask.sum())  # the one host read of a generation
        if n_valid <= self.pop_size:
            order = torch.argsort(score, stable=True)
        else:
            keep = truncate(dist, nd_mask, n_valid - self.pop_size)
            order = torch.argsort((~keep).to(torch.int8), stable=True)
        idx = order[: self.pop_size]
        return pop[idx], fit[idx]
