"""One-point and uniform crossover — the port of
``evox_tpu/operators/crossover/simple.py``.

Both cross consecutive pairs ``(0, 1), (2, 3), ...`` and pass an odd last
row through. Each takes an integer ``seed`` where the JAX function takes a
key, and its draw as an optional argument (``point``, ``mask``), so a test
can hand it the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.common import generator


def _interleave(pop: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    half = c1.shape[0]
    out = torch.stack([c1, c2], dim=1).reshape(2 * half, pop.shape[1])
    return torch.cat([out, pop[2 * half:]]) if 2 * half < pop.shape[0] else out


def one_point(seed: int, pop: torch.Tensor, point: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-point crossover: genes before each pair's cut point come from
    the first parent in the first child. ``point``: the ``(pop // 2, 1)``
    cut points in ``[1, dim)``, drawn from ``seed`` when not given."""
    n, d = pop.shape
    half = n // 2
    p1, p2 = pop[0::2][:half], pop[1::2][:half]
    if point is None:
        point = torch.randint(1, d, (half, 1), generator=generator(seed, pop.device), device=pop.device)
    mask = torch.arange(d, device=pop.device)[None, :] < point
    return _interleave(pop, torch.where(mask, p1, p2), torch.where(mask, p2, p1))


def uniform_rand_cross(seed: int, pop: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform crossover: each gene swaps between the pair's children with
    probability 1/2. ``mask``: the ``(pop // 2, dim)`` bool draw (True
    keeps the gene), drawn from ``seed`` when not given."""
    n, d = pop.shape
    half = n // 2
    p1, p2 = pop[0::2][:half], pop[1::2][:half]
    if mask is None:
        mask = torch.rand((half, d), generator=generator(seed, pop.device), device=pop.device) < 0.5
    return _interleave(pop, torch.where(mask, p1, p2), torch.where(mask, p2, p1))


class OnePoint:
    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return one_point(seed, pop)


class UniformRand:
    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return uniform_rand_cross(seed, pop)
