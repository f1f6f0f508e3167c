"""DES, the "Discovered Evolution Strategy" (Lange et al. 2023,
arXiv:2211.11260) — the port of ``evox_tpu/algorithms/so/es/des.py``:
temperature-softmax recombination weights over fitness ranks, with
separate learning rates for the mean and the stdev.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .common import standard_normal


class DESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    population: torch.Tensor = field(storage=True)
    seed: int


class DES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float = 1.0,
        pop_size: int = 16,
        temperature: float = 12.5,
        lr_mean: float = 1.0,
        lr_sigma: float = 0.1,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size
        self.lr_mean = lr_mean
        self.lr_sigma = lr_sigma
        # softmax(-temp * rank) over ascending ranks, best first
        ranks = torch.arange(pop_size, dtype=torch.float32) / (pop_size - 1) - 0.5
        self.weights = torch.softmax(-temperature * ranks, dim=0).to(self.device)

    def init(self, seed: int) -> DESState:
        dev = self.device
        return DESState(
            mean=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.init_stdev, dtype=torch.float32, device=dev),
            population=torch.zeros((self.pop_size, self.dim), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: DESState) -> Tuple[torch.Tensor, DESState]:
        seed, k = split_seed(state.seed)
        pop = state.mean + state.sigma * self._draw(k)
        return pop, state.replace(population=pop, seed=seed)

    def tell(self, state: DESState, fitness: torch.Tensor) -> DESState:
        x = state.population[torch.argsort(fitness, stable=True)]
        w = self.weights
        weighted_mean = w @ x
        weighted_std = torch.sqrt(w @ (x - state.mean) ** 2 + 1e-12)
        mean = state.mean + self.lr_mean * (weighted_mean - state.mean)
        sigma = state.sigma + self.lr_sigma * (weighted_std - state.sigma)
        return state.replace(mean=mean, sigma=sigma)
