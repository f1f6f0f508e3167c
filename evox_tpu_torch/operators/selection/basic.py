"""Basic parent-selection operators — the port of
``evox_tpu/operators/selection/basic.py``.

Each takes an integer ``seed`` where the JAX function takes a key, and its
random draw as an optional argument (``contestants``, ``idx``, ``choice``),
so a test can hand it the JAX package's draw. ``topk_fit`` and
``select_rand_pbest`` always go through
:func:`~evox_tpu_torch.kernels.topk.partial_topk` (the CUDA kernel for
tensors on the card); the JAX functions' ``use_kernel`` and ``interpret``
chose between its kernel and XLA, whose outputs are identical, so the port
drops them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...kernels.topk import partial_topk
from ...utils.common import generator, seeded


def _contestants(seed: int, n: int, n_round: int, size: int, device: torch.device) -> torch.Tensor:
    return seeded(seed, device,
                  lambda g: torch.randint(0, n, (n_round, size), generator=g, device=device))


def tournament(
    seed: int,
    pop: torch.Tensor,
    fitness: torch.Tensor,
    n_round: Optional[int] = None,
    tournament_size: int = 2,
    best_fn: Callable = torch.argmin,
    contestants: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-fitness tournament selection -> selected population.

    ``n_round`` (default: pop size) tournaments of ``tournament_size``
    uniformly drawn contestants (``contestants``, ``(n_round, size)``
    indices, when given); the winner by ``best_fn(values, dim=1)``."""
    n = pop.shape[0]
    n_round = n if n_round is None else n_round
    if contestants is None:
        contestants = _contestants(seed, n, n_round, tournament_size, pop.device)
    winner_col = best_fn(fitness[contestants], dim=1)
    winners = contestants.gather(1, winner_col[:, None])[:, 0]
    return pop[winners]


def tournament_multifit(
    seed: int,
    pop: torch.Tensor,
    fitnesses: torch.Tensor,
    n_round: Optional[int] = None,
    tournament_size: int = 2,
    contestants: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tournament with lexicographic multi-key fitness ``(n, K)``: the winner
    is the contestant whose row is lexicographically smallest, the first
    contestant on a full tie (``jnp.lexsort``'s stable order).
    ``contestants``: ``(n_round, size)`` indices, drawn when not given."""
    n = pop.shape[0]
    n_round = n if n_round is None else n_round
    if contestants is None:
        contestants = _contestants(seed, n, n_round, tournament_size, pop.device)
    fs = fitnesses[contestants]  # (n_round, size, K)
    # a stable lexsort along each row, least significant key first
    order = torch.arange(contestants.shape[1], device=pop.device).expand_as(contestants)
    for j in reversed(range(fs.shape[2])):
        key = fs[:, :, j].gather(1, order)
        order = order.gather(1, torch.argsort(key, dim=1, stable=True))
    winners = contestants.gather(1, order[:, :1])[:, 0]
    return pop[winners]


def roulette_wheel(
    seed: int,
    pop: torch.Tensor,
    fitness: torch.Tensor,
    n: Optional[int] = None,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fitness-proportionate selection (minimisation: lower fitness, higher
    probability, by max-shift inversion). ``idx``: the ``(n,)`` draw."""
    num = pop.shape[0] if n is None else n
    if idx is None:
        weight = torch.max(fitness) - fitness + 1e-9
        idx = torch.multinomial(weight / torch.sum(weight), num, replacement=True,
                                generator=generator(seed, pop.device))
    return pop[idx]


def topk_fit(pop: torch.Tensor, fitness: torch.Tensor, topk: int):
    """Keep the ``topk`` fittest: ``(pop[idx], fitness values)``, ascending,
    ties by lowest index."""
    fit, idx = partial_topk(fitness, topk, device=fitness.device)
    return pop[idx.long()], fit


def uniform_rand(
    seed: int, pop: torch.Tensor, n: int, idx: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``n`` individuals drawn uniformly with replacement (``idx``: the draw)."""
    if idx is None:
        idx = torch.randint(0, pop.shape[0], (n,), generator=generator(seed, pop.device),
                            device=pop.device)
    return pop[idx]


def select_rand_pbest(
    seed: int,
    percent: float,
    pop: torch.Tensor,
    fitness: torch.Tensor,
    choice: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """For each individual, a random member of the best ``percent`` fraction
    (DE current-to-pbest). ``choice``: the ``(n,)`` draw in ``[0, top)``."""
    n = pop.shape[0]
    top = max(1, int(n * percent))
    _, best_idx = partial_topk(fitness, top, device=fitness.device)
    if choice is None:
        choice = torch.randint(0, top, (n,), generator=generator(seed, pop.device),
                               device=pop.device)
    return pop[best_idx.long()[choice]]
