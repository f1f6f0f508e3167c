"""SNES, the Separable Natural Evolution Strategy (Schaul et al. 2011) — the
port of ``evox_tpu/algorithms/so/es/snes.py``: SeparableNES's update with
the NES utilities or temperature-softmax recombination weights.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .common import standard_normal
from .nes import nes_utilities


class SNESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    z: torch.Tensor = field(storage=True)
    seed: int


class SNES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        weight_type: str = "recomb",  # "recomb" | "temp"
        temperature: float = 12.5,
        lr_mean: float = 1.0,
        lr_sigma: Optional[float] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = d = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = lam = pop_size or (4 + 3 * math.floor(math.log(d)))
        self.lr_mean = lr_mean
        self.lr_sigma = (3 + math.log(d)) / (5 * math.sqrt(d)) if lr_sigma is None else lr_sigma
        if weight_type == "recomb":
            w = nes_utilities(lam)
        elif weight_type == "temp":
            ranks = torch.arange(lam, dtype=torch.float32) / (lam - 1) - 0.5
            w = torch.softmax(-ranks * temperature, dim=0) - 1.0 / lam  # best heaviest
        else:
            raise ValueError(f"unknown weight_type {weight_type!r}")
        self.weights = w.to(self.device)

    def init(self, seed: int) -> SNESState:
        dev = self.device
        return SNESState(
            mean=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.init_stdev, dtype=torch.float32, device=dev),
            z=torch.zeros((self.pop_size, self.dim), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: SNESState) -> Tuple[torch.Tensor, SNESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        return state.mean + state.sigma * z, state.replace(z=z, seed=seed)

    def tell(self, state: SNESState, fitness: torch.Tensor) -> SNESState:
        z = state.z[torch.argsort(fitness, stable=True)]
        w = self.weights
        mean = state.mean + self.lr_mean * state.sigma * (w @ z)
        sigma = state.sigma * torch.exp(self.lr_sigma / 2.0 * (w @ (z**2 - 1.0)))
        return state.replace(mean=mean, sigma=sigma)
