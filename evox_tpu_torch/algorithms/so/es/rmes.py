"""RM-ES, the Rank-m Evolution Strategy (Li & Zhang 2018, IEEE TEVC, "A
Simple Yet Efficient Evolution Strategy for Large-Scale Black-Box
Optimization") — the port of ``evox_tpu/algorithms/so/es/rmes.py``.

m stored evolution paths make a low-rank covariance model (O(m·d) memory),
with population-success-rule step-size adaptation. The state's ``z`` holds
the composed directions y, so ``tell`` needs only ``y_w``, their weighted
sum over the selected samples (``pop_moments``, then
``tell_with_moments``), and the sorted top-µ fitness.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.distributed import POP_AXIS
from ....core.distributed import P as PartitionSpec
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, split_seed
from .cma_es import _default_pop_size
from .common import (
    capped_mu_weights,
    clamp_step_size,
    mueff_of,
    sorted_selection_moments,
    standard_normal,
    weights_at_ranks,
)


class RMESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    pc: torch.Tensor
    P: torch.Tensor  # (m, dim) stored evolution paths
    p_iters: torch.Tensor  # (m,) int32: the generation each path was stored
    prev_fitness: torch.Tensor
    s: torch.Tensor  # smoothed success measure
    iteration: int
    # the composed directions y of the current generation
    z: torch.Tensor = field(storage=True, sharding=PartitionSpec(POP_AXIS))
    seed: int


class RMES(Algorithm):
    """RM-ES. It speaks :class:`~evox_tpu_torch.core.distributed.
    ShardedES`'s POP-sharded protocol."""

    pop_fields = ("z",)
    pop_shard_capable = True
    sharded_pop_fields = ("z",)

    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        memory_size: int = 2,
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
        self.m = memory_size
        mu, w = capped_mu_weights(lam, mu, mu_half_prefactor=True)
        self.mu = mu
        self.mueff = mueff_of(w)
        self.weights = w.to(self.device)
        self.ccov = 1.0 / (3 * math.sqrt(n) + 5)  # rank-one mixing weight
        self.cc = 2.0 / (n + 7)
        self.c_sigma = 0.3
        self.q_star = 0.3
        self.d_sigma = 1.0
        self.T = n  # least generation gap between stored paths

    def init(self, seed: int) -> RMESState:
        n, dev = self.dim, self.device
        return RMESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            pc=torch.zeros(n, device=dev),
            P=torch.zeros((self.m, n), device=dev),
            p_iters=torch.zeros(self.m, dtype=torch.int32, device=dev),
            prev_fitness=torch.full((self.mu,), math.inf, device=dev),
            s=torch.zeros((), device=dev),
            iteration=0,
            z=torch.zeros((self.pop_size, n), device=dev),
            seed=seed,
        )

    def _compose(self, z: torch.Tensor, r: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
        """y = sqrt(1-ccov)^m z + sum_i sqrt(ccov (1-ccov)^(m-1-i)) r_i P_i."""
        a = math.sqrt(1 - self.ccov)
        y = (a**self.m) * z
        for i in range(self.m):
            coef = math.sqrt(self.ccov) * (a ** (self.m - 1 - i))
            y = y + coef * r[:, i : i + 1] * P[i]
        return y

    def _draw(self, seed: int, rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The one draw of a generation: ``z`` ``(rows, dim)`` and ``r``
        ``(rows, m)``, standard normals (``pop_size`` rows by default)."""
        kz, kr = split_seed(seed)
        rows = rows or self.pop_size
        return (standard_normal(kz, (rows, self.dim), self.device),
                standard_normal(kr, (rows, self.m), self.device))

    def ask(self, state: RMESState) -> Tuple[torch.Tensor, RMESState]:
        seed, k = split_seed(state.seed)
        z, r = self._draw(k)
        y = self._compose(z, r, state.P)
        pop = state.mean + state.sigma * y
        return pop, state.replace(z=y, seed=seed)

    def ask_rows(self, state: RMESState, seed: int, n_rows: int):
        """One shard's block of the sampling law (``ShardedES``); the
        artifact is the composed directions, as ``ask`` stores them."""
        z, r = self._draw(seed, n_rows)
        y = self._compose(z, r, state.P)
        return state.mean + state.sigma * y, {"z": y}

    def rank_weights(self, ranks: torch.Tensor) -> torch.Tensor:
        return weights_at_ranks(self.weights, ranks, self.mu)

    def pop_moments(self, rows: dict, weights: torch.Tensor) -> dict:
        return {"yw": weights @ rows["z"]}

    def tell_with_moments(self, state: RMESState, moments: dict,
                          fitness: torch.Tensor) -> RMESState:
        y_w = moments["yw"]
        f_sel = moments.get("f_sel")
        if f_sel is None:
            f_sel = torch.sort(fitness, stable=True).values[: self.mu]
        mean = state.mean + state.sigma * y_w
        pc = (1 - self.cc) * state.pc + math.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w

        it = state.iteration + 1
        # the path archive: shift out the oldest when the newest stored pair
        # is far enough apart in generations, else replace the newest
        it_t = torch.full((1,), it, dtype=torch.int32, device=self.device)
        shifted_P = torch.cat([state.P[1:], pc[None, :]], dim=0)
        shifted_it = torch.cat([state.p_iters[1:], it_t], dim=0)
        if self.m > 1:
            gap_ok = (it - state.p_iters[-1]) > self.T
            replaced_P = torch.cat([state.P[:-1], pc[None, :]], dim=0)
            replaced_it = torch.cat([state.p_iters[:-1], it_t], dim=0)
            P = torch.where(gap_ok, shifted_P, replaced_P)
            p_iters = torch.where(gap_ok, shifted_it, replaced_it)
        else:
            P, p_iters = shifted_P, shifted_it

        # population success rule: the ranks of this generation's top-µ
        # among them and the last generation's (stable, ties in index order)
        merged = torch.cat([f_sel, state.prev_fitness])
        ranks = torch.argsort(torch.argsort(merged, stable=True), stable=True).to(torch.float32)
        q = (torch.mean(ranks[self.mu :]) - torch.mean(ranks[: self.mu])) / self.mu
        s = (1 - self.c_sigma) * state.s + self.c_sigma * (q - self.q_star)
        sigma = clamp_step_size(
            state.sigma * torch.exp(s / self.d_sigma), self.sigma_floor, self.sigma_ceiling
        )
        return state.replace(
            mean=mean, sigma=sigma, pc=pc, P=P, p_iters=p_iters,
            prev_fitness=f_sel, s=s, iteration=it,
        )

    def tell(self, state: RMESState, fitness: torch.Tensor) -> RMESState:
        moments, order = sorted_selection_moments(self, state, fitness)
        moments = dict(moments, f_sel=fitness[order[: self.mu]])
        return self.tell_with_moments(state, moments, fitness)
