"""Differential-evolution building blocks — the port of
``evox_tpu/operators/crossover/de_ops.py``.

Every function is batched over the whole population. Each takes an integer
``seed`` where the JAX function takes a key, and its random draws as
optional arguments (uniforms, integers), so a test can hand it the JAX
package's draws; drawn from ``seed`` when not given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utils.common import generator

__all__ = [
    "DifferentialEvolve",
    "de_arith_recom",
    "de_bin_cross",
    "de_diff_sum",
    "de_exp_cross",
    "differential_evolve",
]


def _per_row(x, n: int, device: torch.device) -> torch.Tensor:
    """A scalar or ``(n,)`` parameter as an ``(n, 1)`` float32 column."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)[:, None]


def de_diff_sum(
    seed: int,
    diff_padding_num: int,
    num_diff_vectors,
    index: torch.Tensor,
    population: torch.Tensor,
    random_choices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum of ``num_diff_vectors`` random difference pairs for each
    individual: ``(difference_sum, rand_vect_idx)``, the latter the first
    random index (the random base vector). ``diff_padding_num`` indices
    are drawn per row in ``[0, pop - 1)`` (``random_choices``, ``(pop,
    diff_padding_num)``) and shifted past the row's own index; positions
    past ``2 * num_diff_vectors + 1`` do not count."""
    pop_size = population.shape[0]
    dev = population.device
    if random_choices is None:
        random_choices = torch.randint(0, pop_size - 1, (pop_size, diff_padding_num),
                                       generator=generator(seed, dev), device=dev)
    select_len = torch.as_tensor(num_diff_vectors, device=dev).reshape(()) * 2 + 1
    own = index[:, None] if index.ndim == 1 else index.expand(pop_size, 1)
    rand_indices = torch.where(random_choices >= own, random_choices + 1, random_choices)
    pos = torch.arange(diff_padding_num, device=dev)
    active = pos[None, :] < select_len
    sign = torch.where(pos % 2 == 1, 1.0, -1.0)
    sign[0] = 0.0  # the first is the base vector, not a difference term
    vecs = population[rand_indices]  # (pop, padding, dim)
    contrib = torch.where(active[..., None], vecs * sign[None, :, None], 0.0)
    return torch.sum(contrib, dim=1), rand_indices[:, 0]


def de_bin_cross(
    seed: int,
    mutant: torch.Tensor,
    parent: torch.Tensor,
    cr,
    u: Optional[torch.Tensor] = None,
    jrand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binomial crossover with one mutant gene guaranteed per row: the
    ``(pop, dim)`` uniforms ``u`` and the ``(pop,)`` forced columns
    ``jrand``, drawn when not given."""
    pop_size, dim = mutant.shape
    dev = mutant.device
    if u is None or jrand is None:
        g = generator(seed, dev)
        u = torch.rand((pop_size, dim), generator=g, device=dev) if u is None else u
        jrand = torch.randint(0, dim, (pop_size,), generator=g, device=dev) if jrand is None else jrand
    mask = (u < _per_row(cr, pop_size, dev)) | (torch.arange(dim, device=dev)[None, :] == jrand[:, None])
    return torch.where(mask, mutant, parent)


def de_exp_cross(
    seed: int,
    mutant: torch.Tensor,
    parent: torch.Tensor,
    cr,
    start: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exponential crossover: a contiguous (wrapping) segment from the
    mutant. It starts at ``start`` (``(pop, 1)`` integers) and its length
    ``L`` has ``P(L >= l) = cr^(l-1)``, from the ``(pop, 1)`` uniforms
    ``u`` in ``[1e-12, 1)``; both drawn when not given."""
    pop_size, dim = mutant.shape
    dev = mutant.device
    if start is None or u is None:
        g = generator(seed, dev)
        if start is None:
            start = torch.randint(0, dim, (pop_size, 1), generator=g, device=dev)
        if u is None:
            u = torch.rand((pop_size, 1), generator=g, device=dev) * (1.0 - 1e-12) + 1e-12
    cr_b = _per_row(cr, pop_size, dev)
    # a geometric length in [1, dim]; cr >= 1 copies the whole mutant
    length = torch.clamp(
        torch.floor(1.0 + torch.log(u) / torch.log(torch.clamp(cr_b, 1e-12, 1.0 - 1e-7))), 1, dim
    ).to(torch.int32)
    length = torch.where(cr_b >= 1.0, dim, length)
    offset = torch.remainder(torch.arange(dim, device=dev)[None, :] - start, dim)
    return torch.where(offset < length, mutant, parent)


def de_arith_recom(mutant: torch.Tensor, parent: torch.Tensor, k) -> torch.Tensor:
    """Arithmetic recombination: ``parent + K * (mutant - parent)``."""
    return parent + _per_row(k, mutant.shape[0], mutant.device) * (mutant - parent)


def differential_evolve(
    seed: int,
    p1: torch.Tensor,
    p2: torch.Tensor,
    p3: torch.Tensor,
    f: float,
    cr: float,
    u: Optional[torch.Tensor] = None,
    jrand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The classic rand/1/bin step on explicit parent triples."""
    return de_bin_cross(seed, p1 + f * (p2 - p3), p1, cr, u=u, jrand=jrand)


class DifferentialEvolve:
    """The class form of rand/1/bin."""

    def __init__(self, f: float = 0.5, cr: float = 0.9):
        self.f = f
        self.cr = cr

    def __call__(self, seed, p1, p2, p3, u=None, jrand=None):
        return differential_evolve(seed, p1, p2, p3, self.f, self.cr, u=u, jrand=jrand)

