"""Inverted Generational Distance and IGD+ — the port of
``evox_tpu/metrics/igd.py``."""

from __future__ import annotations

import torch

from ..utils.common import pairwise_euclidean_dist


def igd(objs: torch.Tensor, pf: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """Mean distance from each true-front point to its nearest solution."""
    d = pairwise_euclidean_dist(pf, objs)
    return torch.mean(torch.amin(d, dim=1) ** p) ** (1.0 / p)


def masked_igd(objs: torch.Tensor, objs_mask: torch.Tensor, pf: torch.Tensor,
               pf_mask: torch.Tensor) -> torch.Tensor:
    """IGD between two masked point sets of fixed shape: the mean over the
    valid ``pf`` rows of the distance to the nearest valid ``objs`` row.

    Fronts change size every generation, so both sets come padded with
    boolean row masks instead of sliced (the churn ring of
    ``monitors/lineage.py`` in the JAX package). Returns 0 when either set
    is empty: an undefined churn reads as no movement rather than NaN."""
    d = pairwise_euclidean_dist(pf, objs)
    d = torch.where(objs_mask[None, :], d, torch.inf)
    nearest = torch.amin(d, dim=1)
    n_pf = pf_mask.to(torch.float32).sum()
    mean = torch.where(pf_mask, nearest, 0.0).sum() / torch.clamp_min(n_pf, 1.0)
    defined = objs_mask.any() & pf_mask.any()
    return torch.where(defined, mean, torch.zeros_like(mean))


def igd_plus(objs: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """IGD+ (Ishibuchi et al. 2015): only dominated directions count."""
    diff = torch.clamp_min(objs[None, :, :] - pf[:, None, :], 0.0)
    return torch.mean(torch.amin(torch.linalg.norm(diff, dim=-1), dim=1))


class IGD:
    def __init__(self, pf: torch.Tensor, p: float = 1.0):
        self.pf = pf
        self.p = p

    def __call__(self, objs: torch.Tensor) -> torch.Tensor:
        return igd(objs, self.pf, self.p)


class IGDPlus:
    def __init__(self, pf: torch.Tensor):
        self.pf = pf

    def __call__(self, objs: torch.Tensor) -> torch.Tensor:
        return igd_plus(objs, self.pf)
