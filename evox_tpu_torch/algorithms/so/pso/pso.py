"""Particle Swarm Optimization — the port of
``evox_tpu/algorithms/so/pso/pso.py``: classic inertia-weight PSO with
cognitive and social terms, and ``migrate``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .common import SwarmAlgorithm


class PSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest_position: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    gbest_position: torch.Tensor
    gbest_fitness: torch.Tensor  # 0-d
    seed: int


class PSO(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        inertia_weight: float = 0.6,
        cognitive_coef: float = 2.5,
        social_coef: float = 0.8,
        mean: Optional[torch.Tensor] = None,
        stdev: Optional[torch.Tensor] = None,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.w = inertia_weight
        self.phi_p = cognitive_coef
        self.phi_g = social_coef
        self.mean = None if mean is None else float_vector(mean, self.device)
        self.stdev = None if stdev is None else float_vector(stdev, self.device)

    def init(self, seed: int) -> PSOState:
        seed, pop_seed = split_seed(seed)
        shape = (self.pop_size, self.dim)
        if self.mean is not None and self.stdev is not None:
            z = torch.randn((2,) + shape, generator=self._generator(pop_seed), device=self.device)
            pop = torch.clamp(self.stdev * z[0] + self.mean, self.lb, self.ub)
            velocity = self.stdev * z[1]
        else:
            span = self.ub - self.lb
            u_pop, u_vel = self._uniform(pop_seed, 2)
            pop = u_pop * span + self.lb
            velocity = (u_vel * 2.0 - 1.0) * span
        return PSOState(
            population=pop,
            velocity=velocity,
            pbest_position=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            gbest_position=pop[0],
            gbest_fitness=torch.tensor(float("inf"), device=self.device),
            seed=seed,
        )

    def ask(self, state: PSOState) -> Tuple[torch.Tensor, PSOState]:
        return state.population, state

    def _draw(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A generation's draws: ``rp``, ``rg``, each ``(pop, dim)`` uniform."""
        return tuple(self._uniform(seed, 2))

    def tell(self, state: PSOState, fitness: torch.Tensor) -> PSOState:
        seed, draw_seed = split_seed(state.seed)
        rp, rg = self._draw(draw_seed)
        improved = fitness < state.pbest_fitness
        pbest_fitness = torch.where(improved, fitness, state.pbest_fitness)
        pbest_position = torch.where(improved[:, None], state.population, state.pbest_position)
        best_i = torch.argmin(pbest_fitness)
        gbest_fitness = torch.minimum(state.gbest_fitness, pbest_fitness[best_i])
        gbest_position = torch.where(
            pbest_fitness[best_i] <= state.gbest_fitness, pbest_position[best_i],
            state.gbest_position,
        )
        velocity = (
            self.w * state.velocity
            + self.phi_p * rp * (pbest_position - state.population)
            + self.phi_g * rg * (gbest_position[None, :] - state.population)
        )
        return state.replace(
            population=self._repair(state.population + velocity),
            velocity=velocity,
            pbest_position=pbest_position,
            pbest_fitness=pbest_fitness,
            gbest_position=gbest_position,
            gbest_fitness=gbest_fitness,
            seed=seed,
        )

    def migrate(self, state: PSOState, pop: torch.Tensor, fitness: torch.Tensor) -> PSOState:
        """Replace the worst personal bests (and their particles) with the
        migrants and refresh the global best."""
        k = fitness.shape[0]
        worst = torch.argsort(-state.pbest_fitness, stable=True)[:k]
        pbest_fitness = state.pbest_fitness.index_put((worst,), fitness)
        pbest_position = state.pbest_position.index_put((worst,), pop)
        best_i = torch.argmin(pbest_fitness)
        improved = pbest_fitness[best_i] <= state.gbest_fitness
        return state.replace(
            population=state.population.index_put((worst,), pop),
            pbest_position=pbest_position,
            pbest_fitness=pbest_fitness,
            gbest_position=torch.where(improved, pbest_position[best_i], state.gbest_position),
            gbest_fitness=torch.minimum(state.gbest_fitness, pbest_fitness[best_i]),
        )
