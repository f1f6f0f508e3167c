"""PGPE, Policy Gradients with Parameter-based Exploration (Sehnke et al.
2010), with the ClipUp optimizer (Toklu et al. 2020, arXiv:2008.02387) —
the port of ``evox_tpu/algorithms/so/es/pgpe.py``.

Symmetric sampling ``center ± delta``, the center's gradient from the
paired fitness differences, and the stdev's gradient from the
baseline-relative term. The ``(pop/2, dim)`` delta batch is not stored, as
in the JAX package: ``tell`` draws it again from ``delta_seed`` with the
ask-time stdev (only ``tell`` changes the stdev), so the dominant buffer
lives only inside ``ask`` and ``tell``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode
from ....utils.common import float_vector, split_seed
from ....utils.optimizers import ClipUp, make_optimizer
from .common import standard_normal

__all__ = ["PGPE", "PGPEState", "ClipUp"]


class PGPEState(PyTreeNode):
    center: torch.Tensor
    stdev: torch.Tensor
    opt_state: Any
    delta_seed: int
    seed: int


class PGPE(Algorithm):
    def __init__(
        self,
        pop_size: int,
        center_init: Any,
        optimizer: Any = "clipup",
        stdev_init: float = 0.1,
        center_learning_rate: float = 0.15,
        stdev_learning_rate: float = 0.1,
        stdev_max_change: float = 0.2,
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError("PGPE samples symmetrically: pop_size must be even")
        self.device = resolve_device(device)
        self.pop_size = pop_size
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.stdev_init = stdev_init
        self.stdev_lr = stdev_learning_rate
        self.stdev_max_change = stdev_max_change
        self.optimizer = make_optimizer(optimizer, center_learning_rate)

    def init(self, seed: int) -> PGPEState:
        seed, k = split_seed(seed)
        return PGPEState(
            center=self.center_init.clone(),
            stdev=torch.full((self.dim,), self.stdev_init, dtype=torch.float32, device=self.device),
            opt_state=self.optimizer.init(self.center_init),
            delta_seed=k,
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        """The one draw of a generation, made in ``ask`` and again in
        ``tell``: ``(pop/2, dim)`` standard normals."""
        return standard_normal(seed, (self.pop_size // 2, self.dim), self.device)

    def _delta(self, state: PGPEState) -> torch.Tensor:
        return self._draw(state.delta_seed) * state.stdev

    def ask(self, state: PGPEState) -> Tuple[torch.Tensor, PGPEState]:
        seed, k = split_seed(state.seed)
        state = state.replace(delta_seed=k, seed=seed)
        delta = self._delta(state)
        return torch.cat([state.center + delta, state.center - delta], dim=0), state

    def tell(self, state: PGPEState, fitness: torch.Tensor) -> PGPEState:
        half = self.pop_size // 2
        f_pos, f_neg = fitness[:half], fitness[half:]
        delta = self._delta(state)  # the ask-time draw and stdev
        center_grad = ((f_pos - f_neg) / 2.0) @ delta / half  # a descent direction
        updates, opt_state = self.optimizer.update(center_grad, state.opt_state, state.center)
        center = state.center + updates

        baseline = torch.mean(fitness)
        s = (delta**2 - state.stdev**2) / state.stdev
        del delta
        stdev_grad = ((f_pos + f_neg) / 2.0 - baseline) @ s / half
        allowed = self.stdev_max_change * state.stdev
        stdev = state.stdev - torch.clamp(self.stdev_lr * stdev_grad, -allowed, allowed)
        stdev = torch.clamp_min(stdev, 1e-8)
        return state.replace(center=center, stdev=stdev, opt_state=opt_state)
