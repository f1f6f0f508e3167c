"""AMaLGaM, the Adapted Maximum-Likelihood Gaussian Model IDEA (Bosman et
al. 2013), full-covariance and independent (diagonal) — the port of
``evox_tpu/algorithms/so/es/amalgam.py``.

A Gaussian estimation-of-distribution algorithm: fit a Gaussian to the
selected elite, shift part of the next sample along the anticipated mean
shift, and adapt a distribution multiplier. ``jnp.linalg.cholesky`` returns
NaN for a matrix that is not positive definite; ``torch.linalg.cholesky``
raises (and on the card waits for the host). The port calls
``cholesky_ex`` and sets the factor to NaN where it failed, on the device:
JAX's result, with no exception and no host read.
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


class AMaLGaMState(PyTreeNode):
    mean: torch.Tensor
    C: torch.Tensor  # the covariance (full) or its diagonal (independent)
    mean_shift: torch.Tensor
    c_mult: torch.Tensor
    best_fitness: torch.Tensor
    no_improvement: torch.Tensor  # int32, 0-d
    population: torch.Tensor = field(storage=True)
    seed: int


class _AMaLGaMBase(Algorithm):
    full_cov: bool = True

    def __init__(
        self,
        center_init: Any,
        init_stdev: float = 1.0,
        pop_size: Optional[int] = None,
        tau: float = 0.35,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = n = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        if pop_size is None:
            pop_size = int(17 + 3 * n**1.5) if self.full_cov else int(10 * math.sqrt(n))
            pop_size = max(pop_size, 16)
        self.pop_size = pop_size
        self.n_elite = max(2, int(tau * pop_size))
        self.n_ams = max(1, int(0.5 * tau * pop_size))
        # parameter-free learning rates (Bosman 2013)
        self.eta_shift = 0.1
        self.eta_dec = 0.9

    def init(self, seed: int) -> AMaLGaMState:
        n, dev = self.dim, self.device
        var = self.init_stdev**2
        C = torch.eye(n, device=dev) * var if self.full_cov else torch.full((n,), var, device=dev)
        return AMaLGaMState(
            mean=self.center_init.clone(),
            C=C,
            mean_shift=torch.zeros(n, device=dev),
            c_mult=torch.ones((), device=dev),
            best_fitness=torch.tensor(math.inf, device=dev),
            no_improvement=torch.zeros((), dtype=torch.int32, device=dev),
            population=torch.zeros((self.pop_size, n), device=dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: AMaLGaMState) -> Tuple[torch.Tensor, AMaLGaMState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        if self.full_cov:
            # sample through the Cholesky factor of the regularised covariance
            eye = torch.eye(self.dim, device=self.device)
            L, info = torch.linalg.cholesky_ex(state.C + 1e-10 * eye)
            L = torch.where(info == 0, L, torch.nan)
            step = z @ L.T
        else:
            step = z * torch.sqrt(torch.clamp_min(state.C, 1e-20))
        pop = state.mean + torch.sqrt(state.c_mult) * step
        # the anticipated mean shift on the first n_ams samples
        ams = pop[: self.n_ams] + 2.0 * state.c_mult * state.mean_shift
        pop = torch.cat([ams, pop[self.n_ams :]], dim=0)
        return pop, state.replace(population=pop, seed=seed)

    def tell(self, state: AMaLGaMState, fitness: torch.Tensor) -> AMaLGaMState:
        order = torch.argsort(fitness, stable=True)
        elite = state.population[order[: self.n_elite]]
        mean = torch.mean(elite, dim=0)
        centered = elite - mean
        if self.full_cov:
            C_hat = centered.T @ centered / self.n_elite
            C = (1 - self.eta_shift) * state.C + self.eta_shift * C_hat
            C = (C + C.T) / 2.0  # Cholesky's symmetry, exactly
        else:
            C_hat = torch.mean(centered**2, dim=0)
            C = (1 - self.eta_shift) * state.C + self.eta_shift * C_hat
        mean_shift = (1 - self.eta_shift) * state.mean_shift + self.eta_shift * (mean - state.mean)

        # the multiplier grows on an improvement and decays on stagnation
        best = fitness[order[0]]
        improved = best < state.best_fitness
        c_mult = torch.where(improved, torch.clamp_min(state.c_mult, 1.0),
                             state.c_mult * self.eta_dec)
        no_improvement = torch.where(improved, 0, state.no_improvement + 1).to(torch.int32)
        c_mult = torch.where(no_improvement > 25, 1.0, c_mult)  # restart pressure
        return state.replace(
            mean=mean,
            C=C,
            mean_shift=mean_shift,
            c_mult=clamp_step_size(c_mult, 1e-10, 1e10),
            best_fitness=torch.minimum(best, state.best_fitness),
            no_improvement=no_improvement,
        )


class AMaLGaM(_AMaLGaMBase):
    full_cov = True


class IndependentAMaLGaM(_AMaLGaMBase):
    full_cov = False
