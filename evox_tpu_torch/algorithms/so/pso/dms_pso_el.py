"""DMS-PSO-EL, Dynamic Multi-Swarm PSO with Enhanced Learning — the port of
``evox_tpu/algorithms/so/pso/dms_pso_el.py``. Small sub-swarms run
local-best PSO and are regrouped at random every ``regroup_period``
generations; after ``dynamic_ratio`` of ``max_iteration`` the whole swarm
follows the global best.

The generation counter is a Python int here, so the regroup and the phase
are chosen on the host: the JAX package computes both velocity forms and
selects one with ``jnp.where``, which gives the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm


class DMSPSOELState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    pbest: torch.Tensor = field(storage=True)
    pbest_fitness: torch.Tensor = field(storage=True)
    swarm_of: torch.Tensor = field(storage=True)  # (pop,) sub-swarm id of each particle, int64
    gen: int
    seed: int


class DMSPSOEL(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        sub_swarm_size: int = 10,
        regroup_period: int = 10,
        max_iteration: int = 1000,
        dynamic_ratio: float = 0.9,
        inertia_weight: float = 0.7298,
        c_pbest: float = 1.49445,
        c_lbest: float = 1.49445,
        c_gbest: float = 1.49445,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        if pop_size % sub_swarm_size:
            raise ValueError("pop_size must be a multiple of sub_swarm_size")
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.m = sub_swarm_size
        self.n_swarms = pop_size // sub_swarm_size
        self.regroup_period = regroup_period
        self.phase_switch = int(max_iteration * dynamic_ratio)
        self.w = inertia_weight
        self.c1, self.c2, self.c3 = c_pbest, c_lbest, c_gbest
        self.vmax = 0.2 * (self.ub - self.lb)

    def init(self, seed: int) -> DMSPSOELState:
        seed, init_seed = split_seed(seed)
        u_pop, u_vel = self._uniform(init_seed, 2)
        pop = u_pop * (self.ub - self.lb) + self.lb
        return DMSPSOELState(
            population=pop,
            velocity=(u_vel * 2 - 1) * self.vmax,
            pbest=pop,
            pbest_fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            swarm_of=torch.arange(self.pop_size, device=self.device) // self.m,
            gen=0,
            seed=seed,
        )

    def init_ask(self, state: DMSPSOELState) -> Tuple[torch.Tensor, DMSPSOELState]:
        return state.population, state

    def init_tell(self, state: DMSPSOELState, fitness: torch.Tensor) -> DMSPSOELState:
        return state.replace(pbest_fitness=fitness)

    def _lbest(self, state: DMSPSOELState) -> torch.Tensor:
        """Each particle's local best: the best pbest of its sub-swarm (the
        first, on ties)."""
        swarms = torch.arange(self.n_swarms, device=self.device)
        masked = torch.where(state.swarm_of[None, :] == swarms[:, None],
                             state.pbest_fitness[None, :], float("inf"))  # (n_swarms, pop)
        best_idx = torch.argmin(masked, dim=1)
        return state.pbest[best_idx[state.swarm_of]]

    def _draw(self, seed: int) -> Tuple[torch.Tensor, ...]:
        """A generation's draws: the regroup permutation ``(pop,)`` and
        ``r1``, ``r2``, ``r3``, each ``(pop, dim)`` uniform."""
        g = self._generator(seed)
        perm = torch.randperm(self.pop_size, generator=g, device=self.device)
        r = torch.rand((3, self.pop_size, self.dim), generator=g, device=self.device)
        return (perm, *r.unbind(0))

    def ask(self, state: DMSPSOELState) -> Tuple[torch.Tensor, DMSPSOELState]:
        seed, draw_seed = split_seed(state.seed)
        perm, r1, r2, r3 = self._draw(draw_seed)
        dynamic = state.gen < self.phase_switch
        if dynamic and state.gen % self.regroup_period == 0:  # periodic random regroup
            state = state.replace(swarm_of=torch.argsort(perm) // self.m)
        inertia = self.w * state.velocity + self.c1 * r1 * (state.pbest - state.population)
        if dynamic:
            v = inertia + self.c2 * r2 * (self._lbest(state) - state.population)
        else:
            gbest = state.pbest[torch.argmin(state.pbest_fitness)]
            v = inertia + self.c3 * r3 * (gbest - state.population)
        v = torch.clamp(v, -self.vmax, self.vmax)
        pop = self._repair(state.population + v)
        return pop, state.replace(population=pop, velocity=v, gen=state.gen + 1, seed=seed)

    def tell(self, state: DMSPSOELState, fitness: torch.Tensor) -> DMSPSOELState:
        improved = fitness < state.pbest_fitness
        return state.replace(
            pbest=torch.where(improved[:, None], state.population, state.pbest),
            pbest_fitness=torch.where(improved, fitness, state.pbest_fitness),
        )
