"""FS-PSO, Feature-Selection PSO — the port of
``evox_tpu/algorithms/so/pso/fs_pso.py``: inertia-weight PSO whose
particles live in [0, 1]^d (thresholded into feature masks by the
evaluation side), with a mutation that kicks particles out of saturated
positions."""

from __future__ import annotations

from typing import Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm


class FSPSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    gbest: torch.Tensor
    gbest_fitness: torch.Tensor  # 0-d
    seed: int


class FSPSO(SwarmAlgorithm):
    def __init__(
        self,
        pop_size: int,
        dim: int,
        inertia_weight: float = 0.7298,
        cognitive_coefficient: float = 1.49445,
        social_coefficient: float = 1.49445,
        mutate_rate: float = 0.01,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(torch.zeros(dim), torch.ones(dim), pop_size, bound_handling, device)
        self.w = inertia_weight
        self.phi_p = cognitive_coefficient
        self.phi_g = social_coefficient
        self.mutate_rate = mutate_rate

    def init(self, seed: int) -> FSPSOState:
        seed, init_seed = split_seed(seed)
        pop, u_vel = self._uniform(init_seed, 2)
        return FSPSOState(
            population=pop,
            velocity=(u_vel * 2 - 1) * 0.2,
            pbest=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            gbest=pop[0],
            gbest_fitness=torch.tensor(float("inf"), device=self.device),
            seed=seed,
        )

    def init_ask(self, state: FSPSOState) -> Tuple[torch.Tensor, FSPSOState]:
        return state.population, state

    def init_tell(self, state: FSPSOState, fitness: torch.Tensor) -> FSPSOState:
        best = torch.argmin(fitness)
        return state.replace(
            pbest_fitness=fitness,
            gbest=state.population[best],
            gbest_fitness=fitness[best],
        )

    def _draw(self, seed: int) -> Tuple[torch.Tensor, ...]:
        """A generation's draws, each ``(pop, dim)``: ``rp``, ``rg``
        (uniform), the mutation mask (probability ``mutate_rate``) and the
        mutated values (uniform)."""
        rp, rg, u_mut, values = self._uniform(seed, 4)
        return rp, rg, u_mut < self.mutate_rate, values

    def ask(self, state: FSPSOState) -> Tuple[torch.Tensor, FSPSOState]:
        seed, draw_seed = split_seed(state.seed)
        rp, rg, mutate, values = self._draw(draw_seed)
        v = (
            self.w * state.velocity
            + self.phi_p * rp * (state.pbest - state.population)
            + self.phi_g * rg * (state.gbest - state.population)
        )
        # bit-flip style mutation in the continuous relaxation
        pop = torch.where(mutate, values, state.population + v)
        pop = self._repair(pop)
        return pop, state.replace(population=pop, velocity=v, seed=seed)

    def tell(self, state: FSPSOState, fitness: torch.Tensor) -> FSPSOState:
        improved = fitness < state.pbest_fitness
        pbest = torch.where(improved[:, None], state.population, state.pbest)
        pbest_fitness = torch.where(improved, fitness, state.pbest_fitness)
        best = torch.argmin(pbest_fitness)
        return state.replace(
            pbest=pbest,
            pbest_fitness=pbest_fitness,
            gbest=pbest[best],
            gbest_fitness=pbest_fitness[best],
        )
