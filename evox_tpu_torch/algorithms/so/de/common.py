"""What the DE family shares in the port: the constructor's bounds and
device, the uniform initial population, the first generation that only
evaluates it (``init_ask``/``init_tell``), the binomial crossover mask, the
greedy slot selection, the external archive of JaDE and SHADE, and their
pbest cut on ``partial_topk`` (B4). The JAX package repeats these lines in
each module."""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....kernels.topk import partial_topk
from ....utils.common import float_vector, seeded

# the positive quiet NaN every NaN of a sort key becomes
_CANONICAL_NAN = np.array(0x7FC00000, dtype=np.uint32).view(np.float32).item()


class DEAlgorithm(Algorithm):
    """Base of the DE family: ``lb``, ``ub`` (float32 ``(dim,)`` on
    ``device``), ``dim`` and ``pop_size``. ``device``: ``None`` means
    ``"cuda"``. The state's ``population`` is drawn uniformly in the box,
    and the first generation evaluates it (``init_ask``/``init_tell``)."""

    def __init__(self, lb: Any, ub: Any, pop_size: int, device: DeviceLike):
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.pop_size = pop_size

    def _uniform_population(self, seed: int) -> torch.Tensor:
        u = seeded(seed, self.device, lambda g: torch.rand((self.pop_size, self.dim), generator=g,
                                                           device=self.device))
        return u * (self.ub - self.lb) + self.lb

    def _inf_fitness(self) -> torch.Tensor:
        return torch.full((self.pop_size,), float("inf"), device=self.device)

    def init_ask(self, state: Any) -> Tuple[torch.Tensor, Any]:
        return state.population, state

    def init_tell(self, state: Any, fitness: torch.Tensor) -> Any:
        return state.replace(fitness=fitness)


def crossover_mask(u: torch.Tensor, cr: Any, j_rand: torch.Tensor) -> torch.Tensor:
    """The binomial crossover's mask: ``u < cr`` (``cr`` a scalar or a
    ``(pop, 1)`` column), or the row's forced column ``j_rand`` (``(pop,
    1)``)."""
    return (u < cr) | (torch.arange(u.shape[-1], device=u.device) == j_rand)


def greedy(improved: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Rows (or entries) of ``new`` where ``improved``, else of ``old``."""
    mask = improved[:, None] if new.ndim == 2 else improved
    return torch.where(mask, new, old)


def update_archive(
    archive: torch.Tensor,
    archive_size: torch.Tensor,
    population: torch.Tensor,
    improved: torch.Tensor,
    slots: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JaDE's and SHADE's archive of replaced parents: the improved rows'
    parents go to the next free slots in row order, and once the archive
    is full to the random ``slots`` (``(pop,)``). Where two parents go to
    one slot the later row wins, as XLA's scatter writes them; the
    ``scatter_reduce`` of the writers' row numbers makes that the same on
    the card. Returns ``(archive, archive_size)``, the size a 0-dim
    tensor (no host read)."""
    cap = archive.shape[0]
    n = population.shape[0]
    seq = torch.cumsum(improved.to(torch.int64), 0) - 1 + archive_size
    target = torch.where(improved, torch.where(seq < cap, seq, slots), cap)  # cap: dropped
    rows = torch.arange(n, dtype=torch.int64, device=population.device)
    writer = torch.full((cap + 1,), -1, dtype=torch.int64, device=population.device)
    writer = writer.scatter_reduce(0, target, rows, reduce="amax")[:cap]
    archive = torch.where((writer >= 0)[:, None], population[writer.clamp_min(0)], archive)
    return archive, torch.clamp_max(archive_size + improved.sum(), cap)


def sort_key(fitness: torch.Tensor) -> torch.Tensor:
    """``fitness`` with ``-0.0`` as ``+0.0`` and every NaN as one positive
    quiet NaN. ``partial_topk`` orders by IEEE totalOrder with ties to the
    lowest index; on this key that is ``jnp.argsort``'s stable order, which
    ties ``±0.0`` and puts every NaN last: the first ``k`` indices of both
    agree whatever the input."""
    key = torch.where(fitness == 0, 0.0, fitness)
    return torch.where(torch.isnan(key), _CANONICAL_NAN, key)


def pbest_cut(fitness: torch.Tensor, k: int) -> torch.Tensor:
    """``argsort(fitness)[:k]`` (stable) through ``partial_topk``: int64
    indices, on the card one B4 launch."""
    _, idx = partial_topk(sort_key(fitness), k, device=fitness.device)
    return idx.long()
