"""Inverted Generational Distance and IGD+ — the port of
``evox_tpu/metrics/igd.py``."""

from __future__ import annotations

import torch

from ..utils.common import pairwise_euclidean_dist


def igd(objs: torch.Tensor, pf: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """Mean distance from each true-front point to its nearest solution."""
    d = pairwise_euclidean_dist(pf, objs)
    return torch.mean(torch.amin(d, dim=1) ** p) ** (1.0 / p)


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
