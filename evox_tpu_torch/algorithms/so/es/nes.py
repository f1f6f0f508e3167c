"""Exponential and Separable Natural Evolution Strategies (Wierstra et al.
2014, JMLR "Natural Evolution Strategies"; Glasmachers et al. 2010) — the
port of ``evox_tpu/algorithms/so/es/nes.py`` (XNES, SeparableNES).
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


def nes_utilities(pop_size: int) -> torch.Tensor:
    """Rank-based fitness-shaping utilities, best first (NES eq. 15):
    u_i ∝ max(0, ln(λ/2+1) − ln i), shifted to sum to zero; float32, on the
    CPU."""
    ranks = torch.arange(1, pop_size + 1, dtype=torch.float32)
    raw = torch.clamp_min(math.log(pop_size / 2 + 1) - torch.log(ranks), 0.0)
    return raw / torch.sum(raw) - 1.0 / pop_size


def _expm_sym(M: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of a symmetric matrix through its
    eigendecomposition, ``V exp(w) V^T`` (invariant to the signs and the
    degenerate-eigenspace basis of ``V``). A matrix with a non-finite entry
    gives NaN, as ``jnp.linalg.eigh`` does, in place of the exception of
    ``torch.linalg.eigh``."""
    M = (M + M.T) / 2.0
    finite = torch.isfinite(M).all()
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    w, V = torch.linalg.eigh(torch.where(finite, M, eye))
    return torch.where(finite, (V * torch.exp(w)) @ V.T, torch.nan)


class XNESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    B: torch.Tensor  # normalised shape matrix; the full transform is sigma * B
    z: torch.Tensor = field(storage=True)
    seed: int


class XNES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        lr_mean: float = 1.0,
        lr_sigma: Optional[float] = None,
        lr_B: Optional[float] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = d = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size or (4 + 3 * math.floor(math.log(d)))
        default_lr = (9 + 3 * math.log(d)) / (5 * d * math.sqrt(d))
        self.lr_mean = lr_mean
        self.lr_sigma = default_lr if lr_sigma is None else lr_sigma
        self.lr_B = default_lr if lr_B is None else lr_B
        self.utilities = nes_utilities(self.pop_size).to(self.device)

    def init(self, seed: int) -> XNESState:
        dev = self.device
        return XNESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            B=torch.eye(self.dim, device=dev),
            z=torch.zeros((self.pop_size, self.dim), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: XNESState) -> Tuple[torch.Tensor, XNESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        pop = state.mean + state.sigma * (z @ state.B.T)
        return pop, state.replace(z=z, seed=seed)

    def tell(self, state: XNESState, fitness: torch.Tensor) -> XNESState:
        z = state.z[torch.argsort(fitness, stable=True)]  # best first
        u = self.utilities
        eye = torch.eye(self.dim, device=self.device)
        g_delta = u @ z
        g_M = (z * u[:, None]).T @ z - torch.sum(u) * eye
        g_sigma = torch.trace(g_M) / self.dim
        g_B = g_M - g_sigma * eye
        mean = state.mean + self.lr_mean * state.sigma * (state.B @ g_delta)
        sigma = state.sigma * torch.exp(self.lr_sigma / 2.0 * g_sigma)
        B = state.B @ _expm_sym(self.lr_B / 2.0 * g_B)
        return state.replace(mean=mean, sigma=sigma, B=B)


class SeparableNESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor  # per-dimension stdev
    z: torch.Tensor = field(storage=True)
    seed: int


class SeparableNES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        lr_mean: float = 1.0,
        lr_sigma: Optional[float] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = d = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size or (4 + 3 * math.floor(math.log(d)))
        self.lr_mean = lr_mean
        self.lr_sigma = (3 + math.log(d)) / (5 * math.sqrt(d)) if lr_sigma is None else lr_sigma
        self.utilities = nes_utilities(self.pop_size).to(self.device)

    def init(self, seed: int) -> SeparableNESState:
        dev = self.device
        return SeparableNESState(
            mean=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.init_stdev, dtype=torch.float32, device=dev),
            z=torch.zeros((self.pop_size, self.dim), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: SeparableNESState) -> Tuple[torch.Tensor, SeparableNESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        return state.mean + state.sigma * z, state.replace(z=z, seed=seed)

    def tell(self, state: SeparableNESState, fitness: torch.Tensor) -> SeparableNESState:
        z = state.z[torch.argsort(fitness, stable=True)]
        u = self.utilities
        mean = state.mean + self.lr_mean * state.sigma * (u @ z)
        sigma = state.sigma * torch.exp(self.lr_sigma / 2.0 * (u @ (z**2 - 1.0)))
        return state.replace(mean=mean, sigma=sigma)
