"""Simulated binary crossover — the port of
``evox_tpu/operators/crossover/sbx.py``."""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.common import generator, seeded


def simulated_binary(
    seed: int,
    pop: torch.Tensor,
    distribution_factor: float = 20.0,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SBX over consecutive parent pairs ``(0, 1), (2, 3), ...``; returns
    offspring of the same shape (an odd last row passes through).

    ``u``: the ``(pop // 2, dim)`` uniform draw in ``[0, 1)``, drawn from
    ``seed`` when not given."""
    n, d = pop.shape
    half = n // 2
    p1 = pop[0::2][:half]
    p2 = pop[1::2][:half]
    if u is None:
        u = seeded(seed, pop.device, lambda g: torch.rand((half, d), generator=g, device=pop.device))
    e = 1.0 / (distribution_factor + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** e, (1.0 / (2.0 * (1.0 - u))) ** e)
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    # interleave the children back into pair order, then the odd tail
    out = torch.stack([c1, c2], dim=1).reshape(2 * half, d)
    return torch.cat([out, pop[2 * half:]]) if 2 * half < n else out


class SimulatedBinary:
    def __init__(self, distribution_factor: float = 20.0):
        self.distribution_factor = distribution_factor

    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return simulated_binary(seed, pop, self.distribution_factor)
