"""Guided ES (Maheswaranathan et al. 2018, arXiv:1806.10230) — the port of
``evox_tpu/algorithms/so/es/guided_es.py``.

Antithetic ES whose search covariance mixes an isotropic part with the
subspace of recent gradients, Sigma = alpha/d I + (1-alpha)/k U U^T. The
subspace is fed by the algorithm's own ES gradients, or by a surrogate's
through ``tell_gradient``. Its basis comes from ``_basis`` (a reduced QR),
which the tests replace with the JAX package's, as in ASEBO.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode
from ....utils.common import float_vector, split_seed
from ....utils.optimizers import make_optimizer
from .common import f32_sqrt, standard_normal


class GuidedESState(PyTreeNode):
    center: torch.Tensor
    grad_subspace: torch.Tensor  # (k, dim) recent gradients
    opt_state: Any
    noise: torch.Tensor
    seed: int


class GuidedES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        subspace_dims: int = 1,
        alpha: float = 0.5,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.1,
        optimizer: Any = None,
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError("GuidedES uses antithetic pairs: pop_size must be even")
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.pop_size = pop_size
        self.n_pairs = pop_size // 2
        self.k = subspace_dims
        self.alpha = alpha
        self.noise_stdev = noise_stdev
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def init(self, seed: int) -> GuidedESState:
        dev = self.device
        return GuidedESState(
            center=self.center_init.clone(),
            grad_subspace=torch.zeros((self.k, self.dim), device=dev),
            opt_state=self.optimizer.init(self.center_init),
            noise=torch.zeros((self.n_pairs, self.dim), device=dev),
            seed=seed,
        )

    def _basis(self, archive: torch.Tensor) -> torch.Tensor:
        """``(dim, k)`` orthonormal basis of the archive's rows (reduced QR)."""
        return torch.linalg.qr(archive.T, mode="reduced").Q

    def _draw(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The one draw of a generation: ``(pairs, dim)`` and ``(pairs, k)``
        standard normals."""
        k_full, k_sub = split_seed(seed)
        return (standard_normal(k_full, (self.n_pairs, self.dim), self.device),
                standard_normal(k_sub, (self.n_pairs, self.k), self.device))

    def ask(self, state: GuidedESState) -> Tuple[torch.Tensor, GuidedESState]:
        seed, k = split_seed(state.seed)
        z_full, z_sub = self._draw(k)
        Q = self._basis(state.grad_subspace)
        noise = (f32_sqrt(self.alpha / self.dim) * z_full
                 + f32_sqrt((1 - self.alpha) / self.k) * (z_sub @ Q.T))
        step = self.noise_stdev * noise
        pop = torch.cat([state.center + step, state.center - step], dim=0)
        return pop, state.replace(noise=noise, seed=seed)

    def tell(self, state: GuidedESState, fitness: torch.Tensor) -> GuidedESState:
        f_pos, f_neg = fitness[: self.n_pairs], fitness[self.n_pairs :]
        grad = ((f_pos - f_neg) / 2.0) @ state.noise / (self.n_pairs * self.noise_stdev)
        # the newest gradient replaces the oldest
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        return state.replace(
            center=state.center + updates,
            grad_subspace=torch.cat([state.grad_subspace[1:], grad[None, :]], dim=0),
            opt_state=opt_state,
        )

    def tell_gradient(self, state: GuidedESState, grad: torch.Tensor) -> GuidedESState:
        """Push an external surrogate gradient into the guiding subspace."""
        return state.replace(
            grad_subspace=torch.cat([state.grad_subspace[1:], grad[None, :]], dim=0)
        )
