"""MA-ES and LM-MA-ES (Beyer & Sendhoff 2017, "Simplify Your Covariance
Matrix Adaptation Evolution Strategy"; Loshchilov, Glasmachers & Beyer 2017,
arXiv:1705.06693) — the port of ``evox_tpu/algorithms/so/es/ma_es.py``.

MA-ES adapts a transformation matrix M in place of CMA-ES's covariance and
its eigendecomposition: matrix products only. LM-MA-ES keeps m = O(log d)
direction vectors; its ``tell`` goes through the weighted moment of the
selected samples (``pop_moments``, then ``tell_with_moments``), as in the
JAX package. The state's ``iteration`` is a host integer, so the transform
loops over the vectors already updated without reading the device.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.distributed import POP_AXIS, P
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .cma_es import _default_pop_size
from .common import (
    bounded_sigma_step,
    capped_mu_weights,
    clamp_step_size,
    mueff_of,
    recombination_weights,
    sorted_selection_moments,
    standard_normal,
    weights_at_ranks,
)


class MAESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    ps: torch.Tensor
    M: torch.Tensor
    z: torch.Tensor = field(storage=True)
    seed: int


class MAES(Algorithm):
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
        self.dim = n = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = lam = pop_size or _default_pop_size(n)
        mu = lam // 2
        w = recombination_weights(mu, (lam + 1) / 2)
        self.mu = mu
        self.mueff = me = mueff_of(w)
        self.weights = w.to(self.device)
        self.cs = (me + 2) / (n + me + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + me)
        self.cmu = min(1 - self.c1, 2 * (me - 2 + 1 / me) / ((n + 2) ** 2 + me))
        self.damps = 1 + 2 * max(0.0, math.sqrt((me - 1) / (n + 1)) - 1) + self.cs
        self.chiN = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))

    def init(self, seed: int) -> MAESState:
        n, dev = self.dim, self.device
        return MAESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            ps=torch.zeros(n, device=dev),
            M=torch.eye(n, device=dev),
            z=torch.zeros((self.pop_size, n), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: MAESState) -> Tuple[torch.Tensor, MAESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        pop = state.mean + state.sigma * (z @ state.M.T)
        return pop, state.replace(z=z, seed=seed)

    def tell(self, state: MAESState, fitness: torch.Tensor) -> MAESState:
        order = torch.argsort(fitness, stable=True)
        z_sel = state.z[order[: self.mu]]
        z_w = self.weights @ z_sel
        mean = state.mean + state.sigma * (state.M @ z_w)
        ps = (1 - self.cs) * state.ps + math.sqrt(self.cs * (2 - self.cs) * self.mueff) * z_w
        eye = torch.eye(self.dim, device=self.device)
        zz = (z_sel * self.weights[:, None]).T @ z_sel
        M = state.M @ (
            eye + self.c1 / 2 * (torch.outer(ps, ps) - eye) + self.cmu / 2 * (zz - eye)
        )
        sigma = clamp_step_size(
            state.sigma
            * torch.exp(self.cs / self.damps * (torch.linalg.vector_norm(ps) / self.chiN - 1)),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        return state.replace(mean=mean, sigma=sigma, ps=ps, M=M)


class LMMAESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    ps: torch.Tensor
    M: torch.Tensor  # (m, dim) direction vectors
    z: torch.Tensor = field(storage=True, sharding=P(POP_AXIS))
    iteration: int
    seed: int


class LMMAES(Algorithm):
    """Limited-memory MA-ES: m = O(log d) direction vectors, O(d log d)
    memory and work. The transform ``d = prod_j ((1 - cd_j) I + cd_j m_j
    m_j^T) z`` is linear per row, so the update needs only ``z_w``, the
    weighted sum of the selected samples, and LMMAES speaks
    :class:`~evox_tpu_torch.core.distributed.ShardedES`'s protocol."""

    pop_fields = ("z",)
    pop_shard_capable = True
    sharded_pop_fields = ("z",)

    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        memory_size: Optional[int] = None,
        mu: Optional[int] = None,
        sigma_floor: float = 1e-20,
        sigma_ceiling: float = 1e20,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.sigma_floor = sigma_floor
        self.sigma_ceiling = sigma_ceiling
        self.center_init = float_vector(center_init, self.device)
        self.dim = n = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = lam = pop_size or _default_pop_size(n)
        self.m = memory_size or max(1, 4 + int(3 * math.log(n)))
        mu, w = capped_mu_weights(lam, mu)
        self.mu = mu
        self.mueff = mueff_of(w)
        self.weights = w.to(self.device)
        self.cs = 2 * lam / n
        self.chiN = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))
        # per-vector transform and path rates, in float32 as the JAX package
        # computes them
        i = torch.arange(self.m, dtype=torch.float32)
        self.cd = (1.0 / (torch.pow(torch.tensor(1.5), i) * n)).to(self.device)
        cc = lam / (torch.pow(torch.tensor(4.0), i) * n)
        self.cc = torch.clamp_max(cc, 0.99).to(self.device)

    def init(self, seed: int) -> LMMAESState:
        n, dev = self.dim, self.device
        return LMMAESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            ps=torch.zeros(n, device=dev),
            M=torch.zeros((self.m, n), device=dev),
            z=torch.zeros((self.pop_size, n), device=dev),
            iteration=0,
            seed=seed,
        )

    def _transform(self, z: torch.Tensor, M: torch.Tensor, it: int) -> torch.Tensor:
        """d = prod_j ((1 - cd_j) I + cd_j m_j m_j^T) z over the vectors
        already updated (the first ``min(it, m)``)."""
        d = z
        for j in range(min(it, self.m)):
            mj = M[j]
            d = (1 - self.cd[j]) * d + self.cd[j] * torch.outer(d @ mj, mj)
        return d

    def _draw(self, seed: int, rows: Optional[int] = None) -> torch.Tensor:
        return standard_normal(seed, (rows or self.pop_size, self.dim), self.device)

    def ask(self, state: LMMAESState) -> Tuple[torch.Tensor, LMMAESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        pop = state.mean + state.sigma * self._transform(z, state.M, state.iteration)
        return pop, state.replace(z=z, seed=seed)

    def ask_rows(self, state: LMMAESState, seed: int, n_rows: int):
        """One shard's block of the sampling law (``ShardedES``)."""
        z = self._draw(seed, n_rows)
        return state.mean + state.sigma * self._transform(z, state.M, state.iteration), {"z": z}

    def rank_weights(self, ranks: torch.Tensor) -> torch.Tensor:
        return weights_at_ranks(self.weights, ranks, self.mu)

    def pop_moments(self, rows: dict, weights: torch.Tensor) -> dict:
        return {"zw": weights @ rows["z"]}

    def tell_with_moments(self, state: LMMAESState, moments: dict,
                          fitness: torch.Tensor) -> LMMAESState:
        z_w = moments["zw"]
        # linear per row: transform(weights @ z_sel) == weights @ transform(z_sel)
        d_w = self._transform(z_w[None, :], state.M, state.iteration)[0]
        mean = state.mean + state.sigma * d_w
        cs = min(self.cs, 0.999)
        # the path drive sqrt(mueff) z_w, its length railed at 2 chiN (the
        # identity at conventional population sizes)
        v = torch.sqrt(torch.tensor(self.mueff, dtype=torch.float32)) * z_w
        v = v * torch.clamp_max(
            2.0 * self.chiN / torch.clamp_min(torch.linalg.vector_norm(v), 1e-20), 1.0
        )
        ps = (1 - cs) * state.ps + math.sqrt(cs * (2 - cs)) * v
        M = (1 - self.cc[:, None]) * state.M + torch.sqrt(self.cc * (2 - self.cc))[:, None] * v[None, :]
        sigma = bounded_sigma_step(
            state.sigma,
            (cs / 2.0) * (torch.sum(ps**2) / self.dim - 1.0),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        return state.replace(mean=mean, sigma=sigma, ps=ps, M=M, iteration=state.iteration + 1)

    def tell(self, state: LMMAESState, fitness: torch.Tensor) -> LMMAESState:
        moments, _ = sorted_selection_moments(self, state, fitness)
        return self.tell_with_moments(state, moments, fitness)
