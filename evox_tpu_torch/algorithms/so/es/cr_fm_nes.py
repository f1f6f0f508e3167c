"""CR-FM-NES, the Cost-Reduction Fast-Moving Natural Evolution Strategy
(Nomura & Ono 2022, arXiv:2201.11422) — the port of
``evox_tpu/algorithms/so/es/cr_fm_nes.py``.

The search covariance is ``C = sigma^2 D (I + v v^T) D`` with D diagonal
and v one learned direction, sampled antithetically; v follows the
weighted step and D takes an SNES-style exponential update, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .common import clamp_step_size, standard_normal
from .nes import nes_utilities


class CRFMNESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    D: torch.Tensor
    v: torch.Tensor
    ps: torch.Tensor
    z: torch.Tensor = field(storage=True)
    seed: int


class CR_FM_NES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        sigma_floor: float = 1e-20,
        sigma_ceiling: float = 1e20,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.sigma_floor = sigma_floor
        self.sigma_ceiling = sigma_ceiling
        self.center_init = float_vector(center_init, self.device)
        self.dim = d = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        lam = pop_size or (4 + 3 * math.floor(math.log(d)))
        if lam % 2 == 1:
            lam += 1  # antithetic pairs
        self.pop_size = lam
        u = nes_utilities(lam)
        me = 1.0 / float(torch.sum(torch.clamp_min(u + 1.0 / lam, 0.0) ** 2))
        self.cs = (me + 2.0) / (d + me + 5.0)
        self.chiN = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d**2))
        self.lr_mean = 1.0
        self.lr_v = (d + me) / (d * (d + me + 10.0))  # O(1/d) rank-one rate
        self.lr_D = (3 + math.log(d)) / (5 * math.sqrt(d)) / 2.0
        self.lr_sigma = (3 + math.log(d)) / (5 * math.sqrt(d))
        self.me_sqrt = math.sqrt(max(1.0 / float(torch.sum(u**2)), 1e-8))
        self.utilities = u.to(self.device)

    def _draw_init(self, seed: int) -> torch.Tensor:
        """``init``'s draw: the ``(dim,)`` standard normals of v."""
        return standard_normal(seed, (self.dim,), self.device)

    def init(self, seed: int) -> CRFMNESState:
        seed, kv = split_seed(seed)
        d, dev = self.dim, self.device
        return CRFMNESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            D=torch.ones(d, device=dev),
            v=self._draw_init(kv) / math.sqrt(d),
            ps=torch.zeros(d, device=dev),
            z=torch.zeros((self.pop_size, d), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        """The one draw of a generation: ``(pop/2, dim)`` standard normals."""
        return standard_normal(seed, (self.pop_size // 2, self.dim), self.device)

    def _shape(self, z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """y = z + (sqrt(1 + |v|^2) - 1) (z · v̂) v̂, so y ~ N(0, I + v v^T)."""
        vnorm2 = torch.sum(v**2)
        vbar = v / torch.sqrt(vnorm2 + 1e-20)
        coeff = torch.sqrt(1.0 + vnorm2) - 1.0
        return z + coeff * (z @ vbar)[:, None] * vbar

    def ask(self, state: CRFMNESState) -> Tuple[torch.Tensor, CRFMNESState]:
        seed, k = split_seed(state.seed)
        half = self._draw(k)
        z = torch.cat([half, -half], dim=0)
        pop = state.mean + state.sigma * self._shape(z, state.v) * state.D
        return pop, state.replace(z=z, seed=seed)

    def tell(self, state: CRFMNESState, fitness: torch.Tensor) -> CRFMNESState:
        z = state.z[torch.argsort(fitness, stable=True)]
        u = self.utilities
        y_w = u @ self._shape(z, state.v)
        mean = state.mean + self.lr_mean * state.sigma * state.D * y_w
        # the cumulative path of sigma, on the standardised coordinates
        ps = (1 - self.cs) * state.ps + math.sqrt(self.cs * (2 - self.cs)) * self.me_sqrt * (u @ z)
        sigma = clamp_step_size(
            state.sigma * torch.exp(self.cs / 2.0 * (torch.sum(ps**2) / self.dim - 1.0)),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        # the rank-one direction moves toward the weighted step, its length
        # capped at 2
        v_new = (1 - self.lr_v) * state.v + self.lr_v * y_w
        vn = torch.linalg.vector_norm(v_new)
        v_new = torch.where(vn > 2.0, v_new * (2.0 / vn), v_new)
        D = clamp_step_size(
            state.D * torch.exp(self.lr_D / 2.0 * (u @ (z**2 - 1.0))),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        return state.replace(mean=mean, sigma=sigma, D=D, v=v_new, ps=ps)
