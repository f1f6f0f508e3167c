"""Generational Distance and GD+ — the port of ``evox_tpu/metrics/gd.py``."""

from __future__ import annotations

import torch

from ..utils.common import pairwise_euclidean_dist


def gd(objs: torch.Tensor, pf: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """Mean distance from each solution to its nearest true-front point."""
    d = pairwise_euclidean_dist(objs, pf)
    return torch.mean(torch.amin(d, dim=1) ** p) ** (1.0 / p)


def gd_plus(objs: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """GD+: only the directions in which a solution is worse count."""
    diff = torch.clamp_min(objs[:, None, :] - pf[None, :, :], 0.0)
    return torch.mean(torch.amin(torch.linalg.norm(diff, dim=-1), dim=1))


class GD:
    def __init__(self, pf: torch.Tensor, p: float = 1.0):
        self.pf = pf
        self.p = p

    def __call__(self, objs: torch.Tensor) -> torch.Tensor:
        return gd(objs, self.pf, self.p)


class GDPlus:
    def __init__(self, pf: torch.Tensor):
        self.pf = pf

    def __call__(self, objs: torch.Tensor) -> torch.Tensor:
        return gd_plus(objs, self.pf)
