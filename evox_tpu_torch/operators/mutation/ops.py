"""Mutation operators — the port of ``evox_tpu/operators/mutation/ops.py``.

Each takes an integer ``seed`` where the JAX function takes a key, and its
draws as optional arguments a test can hand it."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utils.common import generator, seeded, split_seed


def polynomial(
    seed: int,
    pop: torch.Tensor,
    boundary: Tuple[torch.Tensor, torch.Tensor],
    pro_m: float = 1.0,
    dis_m: float = 20.0,
    site: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Polynomial mutation (Deb & Goyal), batched over the population.

    ``boundary`` = (lower, upper), broadcastable to a row. Each gene mutates
    with probability ``pro_m / dim``. Draws: ``site``, the ``(n, dim)``
    boolean mutation mask, and ``u``, the ``(n, dim)`` uniform draw in
    ``[0, 1)``; each drawn from its own seed when not given."""
    n, d = pop.shape
    lb, ub = boundary
    lb = torch.broadcast_to(torch.as_tensor(lb, dtype=pop.dtype, device=pop.device), (d,))
    ub = torch.broadcast_to(torch.as_tensor(ub, dtype=pop.dtype, device=pop.device), (d,))
    s_site, s_u = split_seed(seed)
    if site is None:
        site = seeded(s_site, pop.device,
                      lambda g: torch.rand((n, d), generator=g, device=pop.device)) < (pro_m / d)
    if u is None:
        u = seeded(s_u, pop.device, lambda g: torch.rand((n, d), generator=g, device=pop.device))
    span = ub - lb
    zero = torch.zeros((), dtype=pop.dtype, device=pop.device)
    norm = torch.where(span > 0, (pop - lb) / span, zero)
    norm_up = torch.where(span > 0, (ub - pop) / span, zero)
    mut_pow = 1.0 / (dis_m + 1.0)
    lhs = (2.0 * u + (1.0 - 2.0 * u) * (1.0 - norm) ** (dis_m + 1.0)) ** mut_pow - 1.0
    rhs = 1.0 - (2.0 * (1.0 - u) + 2.0 * (u - 0.5) * (1.0 - norm_up) ** (dis_m + 1.0)) ** mut_pow
    delta = torch.where(u <= 0.5, lhs, rhs)
    mutated = pop + delta * span
    return torch.clamp(torch.where(site, mutated, pop), lb, ub)


def gaussian(
    seed: int, pop: torch.Tensor, stdvar: float = 1.0, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Additive Gaussian mutation (``noise``: the standard-normal draw)."""
    if noise is None:
        noise = torch.randn(pop.shape, generator=generator(seed, pop.device), device=pop.device,
                            dtype=pop.dtype)
    return pop + stdvar * noise


def bitflip(
    seed: int, pop: torch.Tensor, prob: float = 0.1, flip: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Flip boolean or 0/1 genes with probability ``prob`` (``flip``: the
    boolean draw)."""
    if flip is None:
        flip = torch.rand(pop.shape, generator=generator(seed, pop.device), device=pop.device) < prob
    return torch.where(flip, ~pop, pop) if pop.dtype == torch.bool else torch.where(flip, 1 - pop, pop)


class Polynomial:
    def __init__(self, boundary, pro_m: float = 1.0, dis_m: float = 20.0):
        self.boundary = boundary
        self.pro_m = pro_m
        self.dis_m = dis_m

    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return polynomial(seed, pop, self.boundary, self.pro_m, self.dis_m)


class Gaussian:
    def __init__(self, stdvar: float = 1.0):
        self.stdvar = stdvar

    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return gaussian(seed, pop, self.stdvar)


class Bitflip:
    def __init__(self, prob: float = 0.1):
        self.prob = prob

    def __call__(self, seed: int, pop: torch.Tensor) -> torch.Tensor:
        return bitflip(seed, pop, self.prob)
