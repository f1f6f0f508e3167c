"""SwmmPSO, small-world neighbourhood PSO (Kennedy 1999; Kennedy & Mendes
2002) — the port of ``evox_tpu/algorithms/so/pso/swmmpso.py``.

Constriction PSO (Clerc & Kennedy 2002) in which each particle follows the
best personal best of its ring neighbourhood (self and ``k`` on each
side), optionally rewired at ``init`` with random small-world shortcuts.
With shortcuts the state holds the boolean ``(pop, pop)`` adjacency and the
neighbour best is its masked row-min, so memory grows with pop².
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .common import SwarmAlgorithm
from .topology import mutate_shortcuts, neighbour_best, ring_neighbours


class SwmmPSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    adjacency: torch.Tensor  # bool (pop, pop); (0, 0) without shortcuts
    seed: int


class SwmmPSO(SwarmAlgorithm):
    """Constriction PSO over a small-world swarm topology.

    Args:
        lb, ub: decision-space bounds.
        pop_size: swarm size.
        max_phi_1 / max_phi_2: cognitive / social acceleration caps (each
            velocity term draws uniform [0, max_phi_i) per dimension).
        max_phi: total phi of the constriction coefficient
            chi = 2 / (phi - 2 + sqrt(|phi (phi - 4)|)).
        k: neighbours on each side of the ring.
        shortcut_p: probability of rewiring each edge at init. 0 keeps the
            ring lattice (a static neighbour matrix, no adjacency).
        mean / stdev: optional Gaussian init around ``mean``; default is
            uniform in [lb, ub].
        device: ``None`` means ``"cuda"``.
    """

    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        max_phi_1: float = 2.05,
        max_phi_2: float = 2.05,
        max_phi: float = 4.1,
        k: int = 2,
        shortcut_p: float = 0.0,
        mean: Optional[torch.Tensor] = None,
        stdev: Optional[float] = None,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.max_phi_1 = max_phi_1
        self.max_phi_2 = max_phi_2
        phi = max_phi if max_phi > 0 else (max_phi_1 + max_phi_2)
        self.chi = 2.0 / (phi - 2.0 + (abs(phi * (phi - 4.0))) ** 0.5)
        self.k = k
        self.shortcut_p = shortcut_p
        self.mean = None if mean is None else float_vector(mean, self.device)
        self.stdev = stdev
        self.circles = ring_neighbours(pop_size, k, device=self.device)  # (pop, 2k+1)

    def init(self, seed: int) -> SwmmPSOState:
        seed, init_seed, adj_seed = split_seed(seed, 3)
        shape = (self.pop_size, self.dim)
        if self.mean is not None and self.stdev is not None:
            z = torch.randn((2,) + shape, generator=self._generator(init_seed), device=self.device)
            pop = torch.clamp(self.mean + self.stdev * z[0], self.lb, self.ub)
            v = self.stdev * z[1]
        else:
            span = self.ub - self.lb
            u_pop, u_vel = self._uniform(init_seed, 2)
            pop = u_pop * span + self.lb
            v = (u_vel * 2 - 1) * span
        if self.shortcut_p > 0:
            n = self.pop_size
            rows = torch.arange(n, device=self.device)
            adj = torch.zeros((n, n), dtype=torch.bool, device=self.device)
            adj[rows[:, None], self.circles] = True  # already symmetric (ring)
            adj = mutate_shortcuts(adj_seed, adj, self.shortcut_p)
            adj[rows, rows] = True
        else:
            adj = torch.zeros((0, 0), dtype=torch.bool, device=self.device)
        return SwmmPSOState(
            population=pop,
            velocity=v,
            pbest=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            adjacency=adj,
            seed=seed,
        )

    def ask(self, state: SwmmPSOState) -> Tuple[torch.Tensor, SwmmPSOState]:
        return state.population, state

    def _neighbour_best_idx(self, state: SwmmPSOState, fitness: torch.Tensor) -> torch.Tensor:
        if self.shortcut_p > 0:
            masked = torch.where(state.adjacency, fitness[None, :], float("inf"))
            return torch.argmin(masked, dim=1)
        return neighbour_best(fitness, self.circles)

    def _draw(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A generation's draws: ``phi1`` in [0, max_phi_1) and ``phi2`` in
        [0, max_phi_2), each ``(pop, dim)``."""
        u1, u2 = self._uniform(seed, 2)
        return u1 * self.max_phi_1, u2 * self.max_phi_2

    def tell(self, state: SwmmPSOState, fitness: torch.Tensor) -> SwmmPSOState:
        seed, draw_seed = split_seed(state.seed)
        improved = fitness < state.pbest_fitness
        pbest = torch.where(improved[:, None], state.population, state.pbest)
        pbest_fitness = torch.minimum(state.pbest_fitness, fitness)
        nbest = pbest[self._neighbour_best_idx(state, pbest_fitness)]
        phi1, phi2 = self._draw(draw_seed)
        v = self.chi * (
            state.velocity
            + phi1 * (pbest - state.population)
            + phi2 * (nbest - state.population)
        )
        return state.replace(
            population=self._repair(state.population + v),
            velocity=v,
            pbest=pbest,
            pbest_fitness=pbest_fitness,
            seed=seed,
        )
