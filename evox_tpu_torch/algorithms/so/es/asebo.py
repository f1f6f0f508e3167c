"""ASEBO, Adaptive ES-Active Subspaces for Blackbox Optimization
(Choromanski et al. 2019, arXiv:1903.04268) — the port of
``evox_tpu/algorithms/so/es/asebo.py``.

An archive of recent ES gradients spans a subspace; perturbations mix it
with the full space, weighted by how much of the gradient falls outside
it. The subspace's orthonormal basis comes from a reduced QR through one
method, ``_basis``: a QR's column signs are not unique, and the sampled
perturbations depend on them (their law does not), so the tests replace it
with the JAX package's basis to compare generations field by field.
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


class ASEBOState(PyTreeNode):
    center: torch.Tensor
    grad_archive: torch.Tensor  # (k, dim), decayed
    alpha: torch.Tensor  # the isotropic mixture weight, in [0.1, 1]
    opt_state: Any
    noise: torch.Tensor
    iteration: int
    seed: int


class ASEBO(Algorithm):
    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        subspace_dims: int = 10,
        decay: float = 0.99,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.1,
        optimizer: Any = None,
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError("ASEBO uses antithetic pairs: pop_size must be even")
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.pop_size = pop_size
        self.n_pairs = pop_size // 2
        self.k = min(subspace_dims, self.dim)  # the subspace fits in the space
        self.decay = decay
        self.noise_stdev = noise_stdev
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def init(self, seed: int) -> ASEBOState:
        dev = self.device
        return ASEBOState(
            center=self.center_init.clone(),
            grad_archive=torch.zeros((self.k, self.dim), device=dev),
            alpha=torch.ones((), device=dev),
            opt_state=self.optimizer.init(self.center_init),
            noise=torch.zeros((self.n_pairs, self.dim), device=dev),
            iteration=0,
            seed=seed,
        )

    def _basis(self, archive: torch.Tensor) -> torch.Tensor:
        """``(dim, k)`` orthonormal basis of the archive's rows (reduced QR)."""
        return torch.linalg.qr(archive.T, mode="reduced").Q

    def _draw(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The one draw of a generation: ``(pairs, dim)`` and ``(pairs, k)``
        standard normals."""
        k_iso, k_sub = split_seed(seed)
        return (standard_normal(k_iso, (self.n_pairs, self.dim), self.device),
                standard_normal(k_sub, (self.n_pairs, self.k), self.device))

    def ask(self, state: ASEBOState) -> Tuple[torch.Tensor, ASEBOState]:
        seed, k = split_seed(state.seed)
        z_iso, z_sub = self._draw(k)
        z_sub = z_sub @ self._basis(state.grad_archive).T
        a = torch.ones_like(state.alpha) if state.iteration < self.k else state.alpha
        noise = torch.sqrt(a) * z_iso + torch.sqrt(torch.clamp_min(1.0 - a, 0.0)) * z_sub
        step = self.noise_stdev * noise
        pop = torch.cat([state.center + step, state.center - step], dim=0)
        return pop, state.replace(noise=noise, seed=seed)

    def tell(self, state: ASEBOState, fitness: torch.Tensor) -> ASEBOState:
        f_pos, f_neg = fitness[: self.n_pairs], fitness[self.n_pairs :]
        grad = ((f_pos - f_neg) / 2.0) @ state.noise / (self.n_pairs * self.noise_stdev)
        # the share of the gradient outside the subspace sets the mixture
        Q = self._basis(state.grad_archive)
        g_proj = (grad @ Q) @ Q.T
        ratio = torch.linalg.vector_norm(grad - g_proj) / (torch.linalg.vector_norm(grad) + 1e-12)
        grad_archive = torch.cat([self.decay * state.grad_archive[1:], grad[None, :]], dim=0)
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        return state.replace(
            center=state.center + updates,
            grad_archive=grad_archive,
            alpha=torch.clamp(ratio, 0.1, 1.0),
            opt_state=opt_state,
            iteration=state.iteration + 1,
        )
