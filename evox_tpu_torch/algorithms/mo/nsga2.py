"""NSGA-II (Deb et al. 2002) — the port of ``evox_tpu/algorithms/mo/nsga2.py``.

Merge parents and offspring, then (rank, crowding) environmental
selection; mating by binary tournament on (rank, -crowding). The selection's
non-dominated sort already gives the survivors' ranks, so they are carried
in the state for the next mating tournament: one O(n²) sort per
generation (one ``packed_dominance`` launch), plus one in ``init_tell``.
"""

from __future__ import annotations

from typing import Any

import torch

from ...core.struct import field
from ...operators.selection.basic import tournament_multifit
from ...operators.selection.non_dominate import (
    crowding_distance,
    non_dominated_sort,
    rank_crowding_truncate,
)
from .common import GAMOAlgorithm, MOState


class NSGA2State(MOState):
    rank: torch.Tensor = field(storage=True)  # survivors' Pareto rank from the last selection, int32
    crowd: torch.Tensor = field(storage=True)  # survivors' crowding distance over the survivors


class NSGA2(GAMOAlgorithm):
    def __init__(self, *args: Any, use_kernel: Any = None, topk_interpret: bool = False, **kwargs: Any):
        """``use_kernel``: take the environmental truncation's last front
        through :func:`~evox_tpu_torch.kernels.topk.partial_topk` (the CUDA
        kernel for tensors on the card) instead of the full ``lexsort``.
        The survivor set is the same; the survivor order is index order
        (mating re-keys from the carried rank and crowd). ``None``: off,
        as in the JAX package. ``topk_interpret`` ran the JAX package's
        Pallas kernel in interpreter mode on the CPU; it is accepted and
        ignored."""
        super().__init__(*args, **kwargs)
        self.use_kernel = use_kernel
        self.topk_interpret = topk_interpret

    def init(self, seed: int) -> NSGA2State:
        base = super().init(seed)
        return NSGA2State(
            population=base.population,
            fitness=base.fitness,
            offspring=base.offspring,
            seed=base.seed,
            rank=torch.zeros((self.pop_size,), dtype=torch.int32, device=self.device),
            crowd=torch.zeros((self.pop_size,), device=self.device),
        )

    def init_tell(self, state: NSGA2State, fitness: torch.Tensor) -> NSGA2State:
        return state.replace(
            fitness=fitness,
            rank=non_dominated_sort(fitness, mesh=self.mesh),
            crowd=crowding_distance(fitness),
        )

    def mate(self, seed: int, state: NSGA2State) -> torch.Tensor:
        keys = torch.stack([state.rank.to(torch.float32), -state.crowd], dim=1)
        return tournament_multifit(seed, state.population, keys)

    def tell(self, state: NSGA2State, fitness: torch.Tensor) -> NSGA2State:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        order, ranks = rank_crowding_truncate(
            merged_fit, self.pop_size, mesh=self.mesh, use_kernel=self.use_kernel
        )
        fit_sel = merged_fit[order]
        return state.replace(
            population=merged_pop[order],
            fitness=fit_sel,
            rank=ranks,
            # the next mating tournament's crowding, over the survivors (the
            # cut's crowding is masked to the worst front)
            crowd=crowding_distance(fit_sel),
        )
