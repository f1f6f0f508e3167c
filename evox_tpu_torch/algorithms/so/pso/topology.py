"""Swarm neighbourhood topologies — the port of
``evox_tpu/algorithms/so/pso/topology.py``.

The constructors return a dense ``(pop, k)`` neighbour-index matrix
(int64) or a boolean ``(pop, pop)`` adjacency. Every sort is stable and every argmin
takes the first minimum (and the first NaN), as in the JAX package, so
neighbour lists and neighbour bests match it index for index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ....core.device import DeviceLike, resolve_device
from ....utils.common import generator, pairwise_euclidean_dist


def ring_neighbours(pop_size: int, k: int = 1, device: DeviceLike = None) -> torch.Tensor:
    """(pop, 2k+1) ring topology: self plus k neighbours on each side."""
    dev = resolve_device(device)
    offsets = torch.arange(-k, k + 1, device=dev)
    return (torch.arange(pop_size, device=dev)[:, None] + offsets[None, :]) % pop_size


def full_neighbours(pop_size: int, device: DeviceLike = None) -> torch.Tensor:
    """(pop, pop) fully connected topology."""
    return torch.arange(pop_size, device=resolve_device(device)).repeat(pop_size, 1)


def square_neighbours(pop_size: int, device: DeviceLike = None) -> torch.Tensor:
    """(pop, 5) von Neumann topology: self + N/S/E/W on a near-square
    wrap-around grid. The grid's row count starts from the float32 square
    root, as in the JAX package."""
    dev = resolve_device(device)
    rows = int(torch.sqrt(torch.tensor(float(pop_size), dtype=torch.float32)).floor())
    while pop_size % rows != 0:
        rows -= 1
    cols = pop_size // rows
    i = torch.arange(pop_size, device=dev)
    r, c = i // cols, i % cols
    north = ((r - 1) % rows) * cols + c
    south = ((r + 1) % rows) * cols + c
    west = r * cols + (c - 1) % cols
    east = r * cols + (c + 1) % cols
    return torch.stack([i, north, south, west, east], dim=1)


def circles_neighbours(pop_size: int, k: int = 2, device: DeviceLike = None) -> torch.Tensor:
    """(pop, k+1) "circles": self plus the k following particles."""
    dev = resolve_device(device)
    offsets = torch.arange(0, k + 1, device=dev)
    return (torch.arange(pop_size, device=dev)[:, None] + offsets[None, :]) % pop_size


def knn_adjacency(positions: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean (pop, pop) adjacency from the k nearest neighbours (self
    included) in decision space, made symmetric. The JAX package takes a
    row-wise ``lax.top_k(-dist, k+1)`` (ties to the lowest index): here a
    stable row-wise argsort, whose first k+1 columns are the same."""
    dist = pairwise_euclidean_dist(positions, positions)
    n = positions.shape[0]
    idx = torch.argsort(dist, dim=1, stable=True)[:, : k + 1]
    adj = torch.zeros((n, n), dtype=torch.bool, device=positions.device)
    adj[torch.arange(n, device=positions.device)[:, None], idx] = True
    return adj | adj.T


def adjacency_to_neighbour_list(adj: torch.Tensor, max_neighbours: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (pop, max_neighbours) neighbour list and validity mask from a
    boolean adjacency: neighbours first, each row in index order."""
    order = torch.argsort((~adj).to(torch.uint8), dim=1, stable=True)
    counts = adj.sum(dim=1)
    idx = order[:, :max_neighbours]
    mask = torch.arange(max_neighbours, device=adj.device)[None, :] < counts[:, None]
    return idx, mask


def mutate_shortcuts(seed: int, adj: torch.Tensor, p: float,
                     flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random small-world rewiring: flip each off-diagonal edge with
    probability p. ``flips`` (a boolean ``(pop, pop)`` draw with
    probability p) replaces the draw from ``seed`` where given (the tests
    hand in JAX's)."""
    n = adj.shape[0]
    if flips is None:
        u = torch.rand((n, n), generator=generator(seed, adj.device), device=adj.device)
        flips = u < p
    flips = torch.triu(flips, 1)
    flips = flips | flips.T
    return torch.where(flips, ~adj, adj)


def neighbour_best(fitness: torch.Tensor, neighbours: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Index of the best (minimal-fitness) neighbour of each particle."""
    nf = fitness[neighbours]
    if mask is not None:
        nf = torch.where(mask, nf, float("inf"))
    best_slot = torch.argmin(nf, dim=1)
    return torch.gather(neighbours, 1, best_slot[:, None])[:, 0]
