"""ESMC, an Evolution Strategy with Momentum and a Centered baseline
(Merchant et al. 2021, "Learn2Hop", PMLR v139) — the port of
``evox_tpu/algorithms/so/es/esmc.py``: antithetic sampling whose first
member is the mean itself, its fitness the generation's baseline.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode
from ....utils.common import float_vector, split_seed
from ....utils.optimizers import make_optimizer
from .common import standard_normal


class ESMCState(PyTreeNode):
    center: torch.Tensor
    opt_state: Any
    noise: torch.Tensor
    seed: int


class ESMC(Algorithm):
    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.1,
        optimizer: Any = None,
        device: DeviceLike = None,
    ):
        if pop_size % 2 != 1:
            raise ValueError("ESMC's pop is the mean and antithetic pairs: pop_size must be odd")
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.pop_size = pop_size
        self.n_pairs = (pop_size - 1) // 2
        self.noise_stdev = noise_stdev
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def init(self, seed: int) -> ESMCState:
        return ESMCState(
            center=self.center_init.clone(),
            opt_state=self.optimizer.init(self.center_init),
            noise=torch.zeros((self.n_pairs, self.dim), device=self.device),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.n_pairs, self.dim), self.device)

    def ask(self, state: ESMCState) -> Tuple[torch.Tensor, ESMCState]:
        seed, k = split_seed(state.seed)
        noise = self._draw(k)
        step = self.noise_stdev * noise
        pop = torch.cat([state.center[None, :], state.center + step, state.center - step], dim=0)
        return pop, state.replace(noise=noise, seed=seed)

    def tell(self, state: ESMCState, fitness: torch.Tensor) -> ESMCState:
        f_base = fitness[0]
        f_pos = fitness[1 : 1 + self.n_pairs]
        f_neg = fitness[1 + self.n_pairs :]
        # baseline-relative pair differences, signed toward the better side
        delta = torch.minimum(f_pos, f_neg) - f_base
        signed = torch.where(f_pos < f_neg, 1.0, -1.0)
        grad = (delta * signed) @ state.noise / (self.n_pairs * self.noise_stdev)
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        return state.replace(center=state.center + updates, opt_state=opt_state)
