"""Competitive Swarm Optimizer (Cheng & Jin 2015) — the port of
``evox_tpu/algorithms/so/pso/cso.py``.

Each generation the population is permuted once into pair-major layout:
pair ``i`` is permuted rows ``i`` and ``half + i``. In each pair the
loser learns from the winner and from the swarm center, and only the
updated losers are evaluated (half the population a generation after the
first, the ``init_ask``/``init_tell`` pattern). On equal fitness the
*second* row of the pair wins. The next generation is ``cat(winners,
updated losers)``. The swarm center is the sum of the two halves, each
taken on its own, times ``1/pop``, in the JAX package's order.

``ask`` keeps its pass (winners, candidates, new velocities) in the state
and ``tell`` concatenates it: the JAX package instead replays ``ask``'s
pass from the carried key in ``tell``, which costs nothing there because
XLA merges the two passes under ``jit``; eagerly a replay would redo the
gathers and the three uniform planes, so the port carries (PERF.md §5 has
both timed). The numbers are the same either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....utils.common import split_seed
from .common import SwarmAlgorithm


class CSOPass(PyTreeNode):
    """What ``ask`` computed for ``tell``: the winners' rows and the
    updated losers."""

    winner_x: torch.Tensor  # (half, dim)
    winner_v: torch.Tensor  # (half, dim)
    winner_f: torch.Tensor  # (half,)
    candidates: torch.Tensor  # (half, dim): the losers' new positions
    new_velocity: torch.Tensor  # (half, dim)


class CSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    seed: int
    pair_seed: int = 0  # the generation seed of the last ``ask``'s draws
    pending: Optional[CSOPass] = None  # set by ``ask``, taken by ``tell``


class CSO(SwarmAlgorithm):
    def __init__(
        self,
        lb,
        ub,
        pop_size: int,
        phi: float = 0.0,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError("CSO needs an even population size")
        super().__init__(lb, ub, pop_size, bound_handling, device)
        self.phi = phi

    def init(self, seed: int) -> CSOState:
        seed, pop_seed = split_seed(seed)
        return CSOState(
            population=self._uniform_population(pop_seed),
            fitness=torch.full((self.pop_size,), float("inf"), device=self.device),
            velocity=torch.zeros((self.pop_size, self.dim), device=self.device),
            seed=seed,
        )

    # first generation: evaluate everyone once
    def init_ask(self, state: CSOState) -> Tuple[torch.Tensor, CSOState]:
        return state.population, state

    def init_tell(self, state: CSOState, fitness: torch.Tensor) -> CSOState:
        return state.replace(fitness=fitness)

    def _draw(self, seed: int) -> Tuple[torch.Tensor, ...]:
        """The one draw of a generation: the pairing permutation ``(pop,)``
        and ``r1``, ``r2``, ``r3``, each ``(pop/2, dim)`` uniform."""
        g = self._generator(seed)
        perm = torch.randperm(self.pop_size, generator=g, device=self.device)
        r = torch.rand((3, self.pop_size // 2, self.dim), generator=g, device=self.device)
        return (perm, *r.unbind(0))

    def _pair_pass(self, state: CSOState, perm: torch.Tensor, r1: torch.Tensor,
                   r2: torch.Tensor, r3: torch.Tensor) -> CSOPass:
        half = self.pop_size // 2
        pair_x = state.population.index_select(0, perm).view(2, half, self.dim)
        pair_v = state.velocity.index_select(0, perm).view(2, half, self.dim)
        pair_f = state.fitness.index_select(0, perm).view(2, half)
        center = (pair_x[0].sum(0) + pair_x[1].sum(0))[None, :] * (1.0 / self.pop_size)
        a_wins = pair_f[0] < pair_f[1]
        w = a_wins[:, None]
        x_w = torch.where(w, pair_x[0], pair_x[1])
        x_s = torch.where(w, pair_x[1], pair_x[0])
        v_s = torch.where(w, pair_v[1], pair_v[0])
        new_v = r1 * v_s + r2 * (x_w - x_s) + self.phi * r3 * (center - x_s)
        return CSOPass(
            winner_x=x_w,
            winner_v=torch.where(w, pair_v[0], pair_v[1]),
            winner_f=torch.where(a_wins, pair_f[0], pair_f[1]),
            candidates=self._repair(x_s + new_v),
            new_velocity=new_v,
        )

    def ask(self, state: CSOState) -> Tuple[torch.Tensor, CSOState]:
        seed, pair_seed = split_seed(state.seed)
        done = self._pair_pass(state, *self._draw(pair_seed))
        return done.candidates, state.replace(seed=seed, pair_seed=pair_seed, pending=done)

    def tell(self, state: CSOState, fitness: torch.Tensor) -> CSOState:
        done = state.pending
        if done is None:
            raise ValueError("CSO.tell needs the state that CSO.ask returned")
        return state.replace(
            population=torch.cat([done.winner_x, done.candidates]),
            velocity=torch.cat([done.winner_v, done.new_velocity]),
            fitness=torch.cat([done.winner_f, fitness]),
            pending=None,
        )
