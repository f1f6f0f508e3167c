"""Common utilities — the port of parts of ``evox_tpu/utils/common.py``.

- ``parse_opt_direction``: min/max → ±1 per objective.
- ``rank_based_fitness``: centered ranks in [-0.5, 0.5].
- ``dominate_relation``: the Pareto-dominance matrix (minimisation).
- ``pairwise_euclidean_dist``: ``(n, m)`` distances between two point sets.
- ``lexsort``: ``jnp.lexsort`` from successive stable sorts.
- ``generator``: a ``torch.Generator`` seeded from an integer.
- ``split_seed``/``fold_in_seed``: the integer-seed counterparts of
  ``jax.random.split``/``fold_in``. States hold Python integers, and every
  draw comes from a ``torch.Generator`` seeded with one of them. The port's
  numbers differ from JAX's threefry draws; tests hand both the same
  numbers where they compare the two.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

_SEED_BOUND = 2**62


def split_seed(seed: int, num: int = 2) -> List[int]:
    """``num`` new seeds derived deterministically from ``seed`` (on the
    host: a few microseconds, no device work)."""
    g = torch.Generator().manual_seed(int(seed) % 2**63)
    return torch.randint(0, _SEED_BOUND, (num,), generator=g).tolist()


def fold_in_seed(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` without advancing ``seed``."""
    return split_seed((int(seed) * 1_000_003 + int(data) + 1) % 2**63, 1)[0]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: where every
    draw of the port comes from."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def parse_opt_direction(opt_direction: Union[str, Sequence[str]]) -> torch.Tensor:
    """Map ``"min"``/``"max"`` (or a per-objective list) to a ±1 float32
    vector on the CPU. Workflows multiply fitness by it so algorithms
    always minimize."""
    if isinstance(opt_direction, str):
        opt_direction = [opt_direction]
    signs = []
    for d in opt_direction:
        if d == "min":
            signs.append(1.0)
        elif d == "max":
            signs.append(-1.0)
        else:
            raise ValueError(f"opt_direction must be 'min' or 'max', got {d!r}")
    return torch.tensor(signs, dtype=torch.float32)


def rank_based_fitness(fitness: torch.Tensor) -> torch.Tensor:
    """Centered-rank fitness shaping in [-0.5, 0.5] (OpenAI-ES style).

    The argsort is stable, so tied values rank in index order, as
    ``jnp.argsort`` ranks them."""
    n = fitness.shape[0]
    order = torch.argsort(fitness, stable=True)
    ranks = torch.empty_like(fitness)
    ranks[order] = torch.arange(n, dtype=fitness.dtype, device=fitness.device)
    return ranks / (n - 1) - 0.5


def pairwise_euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(n, d)``, ``(m, d)`` -> ``(n, m)`` Euclidean distances, through one
    matrix product (the JAX package's formulation)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    sq = x2 - 2.0 * (x @ y.T) + y2.T
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def dominate_relation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Boolean ``(n, m)`` matrix: ``out[i, j]`` iff ``x[i]`` Pareto-dominates
    ``y[j]`` (minimisation: no objective worse, at least one better).

    A loop over the small objective axis, each step an ``(n, m)`` compare,
    as in the JAX package. A NaN objective makes every compare false, so a
    row holding one dominates nothing and is dominated by nothing.
    """
    le = torch.ones((x.shape[0], y.shape[0]), dtype=torch.bool, device=x.device)
    lt = torch.zeros_like(le)
    for k in range(x.shape[1]):
        xk = x[:, k, None]
        yk = y[None, :, k]
        le &= xk <= yk
        lt |= xk < yk
    return le & lt


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that sort by ``keys``, the LAST key primary, ties kept in
    index order: ``jnp.lexsort``. Built from one stable sort per key,
    least significant first."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order
