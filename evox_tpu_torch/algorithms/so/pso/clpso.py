"""CLPSO, Comprehensive Learning PSO (Liang et al. 2006) — the port of
``evox_tpu/algorithms/so/pso/clpso.py``. Each dimension of each particle
learns from its own personal best or from a tournament-picked exemplar's,
with a per-particle learning probability on an increasing schedule."""

from __future__ import annotations

from typing import Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm


class CLPSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    seed: int


class CLPSO(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        inertia_weight: float = 0.7298,
        const_coefficient: float = 1.49445,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.w = inertia_weight
        self.c = const_coefficient
        # per-particle learning probability (CLPSO eq. 5): exponential ramp
        i = torch.arange(pop_size, dtype=torch.float32, device=self.device)
        ten = torch.tensor(10.0, device=self.device)
        self.Pc = 0.05 + 0.45 * (torch.exp(10 * i / (pop_size - 1)) - 1) / (torch.exp(ten) - 1)
        self.vmax = 0.2 * (self.ub - self.lb)

    def init(self, seed: int) -> CLPSOState:
        seed, init_seed = split_seed(seed)
        u_pop, u_vel = self._uniform(init_seed, 2)
        pop = u_pop * (self.ub - self.lb) + self.lb
        return CLPSOState(
            population=pop,
            velocity=(u_vel * 2 - 1) * self.vmax,
            pbest=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            seed=seed,
        )

    def init_ask(self, state: CLPSOState) -> Tuple[torch.Tensor, CLPSOState]:
        return state.population, state

    def init_tell(self, state: CLPSOState, fitness: torch.Tensor) -> CLPSOState:
        return state.replace(pbest_fitness=fitness)

    def _draw(self, seed: int) -> Tuple[torch.Tensor, ...]:
        """A generation's draws, each ``(pop, dim)``: the two tournament
        contestants ``t1``, ``t2`` (int64 in [0, pop)), the learn mask
        (uniform < ``Pc`` of the row) and ``r`` (uniform)."""
        n, d = self.pop_size, self.dim
        g = self._generator(seed)
        t = torch.randint(0, n, (2, n, d), generator=g, device=self.device)
        u = torch.rand((2, n, d), generator=g, device=self.device)
        return t[0], t[1], u[0] < self.Pc[:, None], u[1]

    def ask(self, state: CLPSOState) -> Tuple[torch.Tensor, CLPSOState]:
        seed, draw_seed = split_seed(state.seed)
        t1, t2, learn_other, r = self._draw(draw_seed)
        n, d = self.pop_size, self.dim
        # per-dimension exemplar: tournament of two random particles' pbests
        winner = torch.where(state.pbest_fitness[t1] < state.pbest_fitness[t2], t1, t2)
        own = torch.arange(n, device=self.device)[:, None]
        exemplar_idx = torch.where(learn_other, winner, own)
        exemplar = state.pbest[exemplar_idx, torch.arange(d, device=self.device)[None, :]]
        v = self.w * state.velocity + self.c * r * (exemplar - state.population)
        v = torch.clamp(v, -self.vmax, self.vmax)
        pop = self._repair(state.population + v)
        return pop, state.replace(population=pop, velocity=v, seed=seed)

    def tell(self, state: CLPSOState, fitness: torch.Tensor) -> CLPSOState:
        improved = fitness < state.pbest_fitness
        return state.replace(
            pbest=torch.where(improved[:, None], state.population, state.pbest),
            pbest_fitness=torch.where(improved, fitness, state.pbest_fitness),
        )
