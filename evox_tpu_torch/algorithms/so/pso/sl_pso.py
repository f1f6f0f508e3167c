"""SL-PSO, Social Learning PSO (Cheng & Jin 2015), in its two sampling
flavours, Gaussian (SLPSOGS) and uniform (SLPSOUS) — the port of
``evox_tpu/algorithms/so/pso/sl_pso.py``.

Every particle but the swarm best imitates a demonstrator drawn from the
better-ranked part of the swarm, plus an attraction to the swarm mean. The
ranks come from stable sorts, as ``jnp.argsort``'s, so tied fitness ranks
in index order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm


class SLPSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    seed: int


class _SLPSOBase(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        social_influence_factor: float = 0.01,  # epsilon ~ dim/pop * beta
        demonstrator_choice_factor: float = 0.7,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.epsilon = social_influence_factor * self.dim / pop_size
        self.dcf = demonstrator_choice_factor

    def init(self, seed: int) -> SLPSOState:
        seed, pop_seed = split_seed(seed)
        return SLPSOState(
            population=self._uniform_population(pop_seed),
            velocity=torch.zeros((self.pop_size, self.dim), device=self.device),
            fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            seed=seed,
        )

    def init_ask(self, state: SLPSOState) -> Tuple[torch.Tensor, SLPSOState]:
        return state.population, state

    def init_tell(self, state: SLPSOState, fitness: torch.Tensor) -> SLPSOState:
        return state.replace(fitness=fitness)

    def _demonstrator_draw(self, g: torch.Generator) -> torch.Tensor:  # per variant
        raise NotImplementedError

    def _demonstrators(self, draw: torch.Tensor, rank_of: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _draw(self, seed: int) -> Tuple[torch.Tensor, ...]:
        """A generation's draws: the demonstrator draw ``(pop,)`` (normal for
        SLPSOGS, uniform for SLPSOUS), then ``r1``, ``r2``, ``r3``, each
        ``(pop, dim)`` uniform."""
        g = self._generator(seed)
        demo = self._demonstrator_draw(g)
        r = torch.rand((3, self.pop_size, self.dim), generator=g, device=self.device)
        return (demo, *r.unbind(0))

    def ask(self, state: SLPSOState) -> Tuple[torch.Tensor, SLPSOState]:
        seed, draw_seed = split_seed(state.seed)
        demo_draw, r1, r2, r3 = self._draw(draw_seed)
        order = torch.argsort(state.fitness, stable=True)  # order[0] = best
        rank_of = torch.argsort(order, stable=True)  # rank of each particle
        demo = state.population[order[self._demonstrators(demo_draw, rank_of)]]
        mean = torch.mean(state.population, dim=0)
        v = (
            r1 * state.velocity
            + r2 * (demo - state.population)
            + r3 * self.epsilon * (mean - state.population)
        )
        # the swarm best does not move (no demonstrator better than itself)
        v = torch.where((rank_of == 0)[:, None], 0.0, v)
        pop = self._repair(state.population + v)
        return pop, state.replace(population=pop, velocity=v, seed=seed)

    def tell(self, state: SLPSOState, fitness: torch.Tensor) -> SLPSOState:
        # the fitness of the positions ask moved to
        return state.replace(fitness=fitness)


class SLPSOGS(_SLPSOBase):
    """Gaussian demonstrator sampling: rank ~ |N(0, (dcf * own_rank)²)|."""

    def _demonstrator_draw(self, g: torch.Generator) -> torch.Tensor:
        return torch.randn((self.pop_size,), generator=g, device=self.device)

    def _demonstrators(self, draw: torch.Tensor, rank_of: torch.Tensor) -> torch.Tensor:
        rank = rank_of.to(torch.float32)
        sigma = torch.clamp_min(self.dcf * rank, 1.0)
        demo = torch.minimum(torch.abs(draw) * sigma, rank - 1.0)
        return torch.clamp(demo, 0, self.pop_size - 1).to(torch.int64)


class SLPSOUS(_SLPSOBase):
    """Uniform demonstrator sampling over the better-ranked prefix."""

    def _demonstrator_draw(self, g: torch.Generator) -> torch.Tensor:
        return torch.rand((self.pop_size,), generator=g, device=self.device)

    def _demonstrators(self, draw: torch.Tensor, rank_of: torch.Tensor) -> torch.Tensor:
        rank = rank_of.to(torch.float32)
        demo = torch.minimum(draw * torch.clamp_min(self.dcf * rank, 1.0), rank - 1.0)
        return torch.clamp(demo, 0, self.pop_size - 1).to(torch.int64)
