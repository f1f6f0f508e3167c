"""Persistent ES and Noise-Reuse ES — the port of
``evox_tpu/algorithms/so/es/persistent_es.py``.

- PersistentES (Vicol, Metz & Sohl-Dickstein 2021, PMLR v139): antithetic
  ES for truncated unrolls that accumulates the perturbations of a window,
  so the gradient estimate stays unbiased across the unroll.
- NoiseReuseES (Li et al. 2023, arXiv:2304.12180): one noise draw reused
  for a whole window, redrawn at its start.

The step within a window is a host integer, so the window's end needs no
read of the device.
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


class _AntitheticES(Algorithm):
    """Constructor and sampling shared by the two: ``pop`` is ``center ±
    noise_stdev * noise`` over ``pop/2`` pairs."""

    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        truncation_length: int = 100,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.1,
        optimizer: Any = None,
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError(f"{type(self).__name__} uses antithetic pairs: pop_size must be even")
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.pop_size = pop_size
        self.n_pairs = pop_size // 2
        self.T = truncation_length
        self.noise_stdev = noise_stdev
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.n_pairs, self.dim), self.device)

    def _pairs(self, center: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        step = self.noise_stdev * noise
        return torch.cat([center + step, center - step], dim=0)


class PersistentESState(PyTreeNode):
    center: torch.Tensor
    pert_accum: torch.Tensor  # (pairs, dim) accumulated perturbations
    opt_state: Any
    noise: torch.Tensor
    inner_step: int
    seed: int


class PersistentES(_AntitheticES):
    def init(self, seed: int) -> PersistentESState:
        dev = self.device
        return PersistentESState(
            center=self.center_init.clone(),
            pert_accum=torch.zeros((self.n_pairs, self.dim), device=dev),
            opt_state=self.optimizer.init(self.center_init),
            noise=torch.zeros((self.n_pairs, self.dim), device=dev),
            inner_step=0,
            seed=seed,
        )

    def ask(self, state: PersistentESState) -> Tuple[torch.Tensor, PersistentESState]:
        seed, k = split_seed(state.seed)
        noise = self._draw(k)
        return self._pairs(state.center, noise), state.replace(noise=noise, seed=seed)

    def tell(self, state: PersistentESState, fitness: torch.Tensor) -> PersistentESState:
        pert_accum = state.pert_accum + self.noise_stdev * state.noise
        f_pos, f_neg = fitness[: self.n_pairs], fitness[self.n_pairs :]
        # the pair differences against the accumulated perturbation
        grad = ((f_pos - f_neg) / 2.0) @ pert_accum / (self.n_pairs * self.noise_stdev**2)
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        inner = state.inner_step + 1
        reset = inner >= self.T
        return state.replace(
            center=state.center + updates,
            pert_accum=torch.zeros_like(pert_accum) if reset else pert_accum,
            opt_state=opt_state,
            inner_step=0 if reset else inner,
        )


class NoiseReuseESState(PyTreeNode):
    center: torch.Tensor
    noise: torch.Tensor
    opt_state: Any
    inner_step: int
    seed: int


class NoiseReuseES(_AntitheticES):
    def init(self, seed: int) -> NoiseReuseESState:
        return NoiseReuseESState(
            center=self.center_init.clone(),
            noise=torch.zeros((self.n_pairs, self.dim), device=self.device),
            opt_state=self.optimizer.init(self.center_init),
            inner_step=0,
            seed=seed,
        )

    def ask(self, state: NoiseReuseESState) -> Tuple[torch.Tensor, NoiseReuseESState]:
        seed, k = split_seed(state.seed)
        # a fresh draw at a window's start, the frozen one within it
        noise = self._draw(k) if state.inner_step == 0 else state.noise
        return self._pairs(state.center, noise), state.replace(noise=noise, seed=seed)

    def tell(self, state: NoiseReuseESState, fitness: torch.Tensor) -> NoiseReuseESState:
        f_pos, f_neg = fitness[: self.n_pairs], fitness[self.n_pairs :]
        grad = ((f_pos - f_neg) / 2.0) @ state.noise / (self.n_pairs * self.noise_stdev)
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        inner = state.inner_step + 1
        return state.replace(
            center=state.center + updates,
            opt_state=opt_state,
            inner_step=0 if inner >= self.T else inner,
        )
