"""Scalarization (aggregation) functions for decomposition-based MOEAs — the
port of ``evox_tpu/utils/aggregation.py``. Each maps ``(fitness (..., m),
weights (..., m), ideal (m,) [, nadir (m,)])`` to ``(...)``.

Sums and norms over the objectives go through
:func:`~evox_tpu_torch.utils.common.sum_last` (index order, one elementwise
step each), so an aggregation value has the same bits on the card and on
the CPU: MOEA/D's replacement decisions compare such values.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import row_norm, sum_last

EPS = 1e-6


def weighted_sum(f: torch.Tensor, w: torch.Tensor, ideal=None, nadir=None) -> torch.Tensor:
    return sum_last(f * w)


def tchebycheff(f: torch.Tensor, w: torch.Tensor, ideal: torch.Tensor, nadir=None) -> torch.Tensor:
    return torch.amax(torch.abs(f - ideal) * w, dim=-1)


def tchebycheff_norm(f: torch.Tensor, w: torch.Tensor, ideal: torch.Tensor,
                     nadir: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(f - ideal) / torch.clamp_min(nadir - ideal, EPS) * w, dim=-1)


def modified_tchebycheff(f: torch.Tensor, w: torch.Tensor, ideal: torch.Tensor,
                         nadir=None) -> torch.Tensor:
    return torch.amax(torch.abs(f - ideal) / torch.clamp_min(w, EPS), dim=-1)


def pbi(f: torch.Tensor, w: torch.Tensor, ideal: torch.Tensor, nadir=None,
        theta: float = 5.0) -> torch.Tensor:
    """Penalty-based boundary intersection: ``d1 + theta * d2``, ``d1`` the
    projection of ``f - ideal`` on ``w``, ``d2`` the distance from it."""
    norm_w = torch.clamp_min(row_norm(w), EPS)
    diff = f - ideal
    d1 = sum_last(diff * w) / norm_w
    d2 = row_norm(diff - d1[..., None] * w / norm_w[..., None])
    return d1 + theta * d2


_FUNCS = {
    "weighted_sum": weighted_sum,
    "tchebycheff": tchebycheff,
    "tchebycheff_norm": tchebycheff_norm,
    "modified_tchebycheff": modified_tchebycheff,
    "pbi": pbi,
}


class AggregationFunction:
    """Callable wrapper selecting an aggregation function by name."""

    def __init__(self, name: str):
        if name not in _FUNCS:
            raise ValueError(f"unknown aggregation function {name!r}; options: {sorted(_FUNCS)}")
        self.name = name
        self.func = _FUNCS[name]

    def __call__(self, f: torch.Tensor, w: torch.Tensor, ideal: Optional[torch.Tensor] = None,
                 nadir: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.func(f, w, ideal, nadir)
