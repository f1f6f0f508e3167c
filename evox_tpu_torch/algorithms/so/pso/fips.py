"""FIPS, the Fully Informed Particle Swarm (Mendes, Kennedy & Neves 2004) —
the port of ``evox_tpu/algorithms/so/pso/fips.py``: constriction PSO in
which each particle is pulled toward all its neighbours' personal bests,
over a ring, square or full topology. Its draw is ``(pop, k, dim)``, so
memory grows with the neighbourhood ``k`` (``pop`` for the full one)."""

from __future__ import annotations

from typing import Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm
from .topology import full_neighbours, ring_neighbours, square_neighbours


class FIPSState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    seed: int


class FIPS(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        topology: str = "ring",  # "ring" | "square" | "full"
        phi: float = 4.1,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.phi = phi
        # Clerc's constriction coefficient
        self.chi = 2.0 / abs(2.0 - phi - ((phi**2 - 4 * phi) ** 0.5).real) if phi > 4 else 0.7298
        topologies = {"ring": lambda: ring_neighbours(pop_size, 1, device=self.device),
                    "square": lambda: square_neighbours(pop_size, device=self.device),
                    "full": lambda: full_neighbours(pop_size, device=self.device)}
        if topology not in topologies:
            raise ValueError(f"unknown topology {topology!r}")
        self.neighbours = topologies[topology]()

    def init(self, seed: int) -> FIPSState:
        seed, init_seed = split_seed(seed)
        u_pop, u_vel = self._uniform(init_seed, 2)
        span = self.ub - self.lb
        pop = u_pop * span + self.lb
        return FIPSState(
            population=pop,
            velocity=(u_vel * 2 - 1) * span * 0.1,
            pbest=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            seed=seed,
        )

    def init_ask(self, state: FIPSState) -> Tuple[torch.Tensor, FIPSState]:
        return state.population, state

    def init_tell(self, state: FIPSState, fitness: torch.Tensor) -> FIPSState:
        return state.replace(pbest_fitness=fitness)

    def _draw(self, seed: int) -> torch.Tensor:
        """A generation's draw: ``r``, ``(pop, k, dim)`` uniform."""
        k = self.neighbours.shape[1]
        (r,) = self._uniform(seed, 1, (self.pop_size, k, self.dim))
        return r

    def ask(self, state: FIPSState) -> Tuple[torch.Tensor, FIPSState]:
        seed, draw_seed = split_seed(state.seed)
        k = self.neighbours.shape[1]
        # phi split uniformly across neighbours, with random per-neighbour dims
        r = self._draw(draw_seed) * (self.phi / k)
        nbr_pbest = state.pbest[self.neighbours]  # (n, k, d)
        social = torch.sum(r * (nbr_pbest - state.population[:, None, :]), dim=1)
        v = self.chi * (state.velocity + social)
        pop = self._repair(state.population + v)
        return pop, state.replace(population=pop, velocity=v, seed=seed)

    def tell(self, state: FIPSState, fitness: torch.Tensor) -> FIPSState:
        improved = fitness < state.pbest_fitness
        return state.replace(
            pbest=torch.where(improved[:, None], state.population, state.pbest),
            pbest_fitness=torch.where(improved, fitness, state.pbest_fitness),
        )
