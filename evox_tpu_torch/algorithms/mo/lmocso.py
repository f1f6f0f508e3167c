"""LMOCSO (Tian et al. 2020): large-scale multi-objective competitive swarm
optimizer — the port of ``evox_tpu/algorithms/mo/lmocso.py``. Pairwise
competitions on a shift-based fitness; losers learn from winners by the
two-stage velocity update; environmental selection by reference-vector
guided (APD) selection. The draws of a generation come from one ``_draw``
method; the generation counter is a host integer."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode, field
from ...operators.mutation.ops import polynomial
from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.rvea_selection import ref_vec_guided_indices
from ...utils.common import float_vector, generator, row_norm, split_seed
from .common import uniform_init
from .rvea import apd_theta


def sde_density(fit: torch.Tensor) -> torch.Tensor:
    """Shift-based density (the JAX package's ``sra._sde_density``): each
    row's distance to its nearest other row after that row is shifted up to
    at least this row's objectives (larger = sparser)."""
    shifted = torch.maximum(fit[None, :, :], fit[:, None, :])  # (i, j, m)
    d = torch.linalg.norm(shifted - fit[:, None, :], dim=-1)
    d = torch.where(torch.eye(fit.shape[0], dtype=torch.bool, device=fit.device), torch.inf, d)
    return torch.amin(d, dim=1)


class LMOCSOState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    velocity: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    offspring: torch.Tensor
    off_velocity: torch.Tensor
    gen: int
    seed: int


class LMOCSO(Algorithm):
    """The population is the number of reference vectors, rounded up to an
    even count. ``device``: ``None`` means ``"cuda"``."""

    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, max_gen: int = 100,
                 alpha: float = 2.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.n_objs = n_objs
        v, n = UniformSampling(pop_size, n_objs, device=self.device)()
        self.vectors = v / row_norm(v)[:, None]
        self.pop_size = n + n % 2
        self.nv = n
        self.max_gen = max_gen
        self.alpha = alpha

    def _init_population(self, seed: int) -> torch.Tensor:
        """The initial population's one draw."""
        return uniform_init(seed, self.lb, self.ub, self.pop_size)

    def init(self, seed: int) -> LMOCSOState:
        seed, pop_seed = split_seed(seed)
        pop = self._init_population(pop_seed)
        half = self.pop_size // 2
        return LMOCSOState(
            population=pop,
            velocity=torch.zeros_like(pop),
            fitness=torch.full((self.pop_size, self.n_objs), torch.inf, device=self.device),
            offspring=torch.zeros((half, self.dim), device=self.device),
            off_velocity=torch.zeros((half, self.dim), device=self.device),
            gen=0,
            seed=seed,
        )

    def init_ask(self, state: LMOCSOState) -> Tuple[torch.Tensor, LMOCSOState]:
        return state.population, state

    def init_tell(self, state: LMOCSOState, fitness: torch.Tensor) -> LMOCSOState:
        return state.replace(fitness=fitness)

    def _draw(self, seed: int) -> dict:
        """``perm`` ``(pop,)``, the pairing; ``r0``, ``r1`` ``(pop/2, dim)``
        uniform; the mutation's ``site`` and ``u_pm``."""
        n, half, d = self.pop_size, self.pop_size // 2, self.dim
        g = generator(seed, self.device)
        return {
            "perm": torch.randperm(n, generator=g, device=self.device),
            "r0": torch.rand((half, d), generator=g, device=self.device),
            "r1": torch.rand((half, d), generator=g, device=self.device),
            "site": torch.rand((half, d), generator=g, device=self.device) < 1.0 / d,
            "u_pm": torch.rand((half, d), generator=g, device=self.device),
        }

    def ask(self, state: LMOCSOState) -> Tuple[torch.Tensor, LMOCSOState]:
        seed, draw_seed = split_seed(state.seed)
        dr = self._draw(draw_seed)
        half = self.pop_size // 2
        # shift-based fitness: sparser and closer is better
        fmin = torch.amin(state.fitness, dim=0)
        fmax = torch.amax(state.fitness, dim=0)
        fn = (state.fitness - fmin) / torch.clamp_min(fmax - fmin, 1e-12)
        score = torch.sum(fn, dim=1) - sde_density(state.fitness)

        perm = dr["perm"].reshape(2, half)
        a_wins = score[perm[0]] < score[perm[1]]
        winners = torch.where(a_wins, perm[0], perm[1])
        losers = torch.where(a_wins, perm[1], perm[0])
        r0, r1 = dr["r0"], dr["r1"]
        xw, xl = state.population[winners], state.population[losers]
        v_loser = state.velocity[losers]
        # the two-stage update (eq. 6-7): accelerate, then move twice
        v_new = r0 * v_loser + r1 * (xw - xl)
        x_new = xl + v_new + r0 * (v_new - v_loser)
        x_new = polynomial(0, x_new, (self.lb, self.ub), site=dr["site"], u=dr["u_pm"])
        x_new = torch.clamp(x_new, self.lb, self.ub)
        # winners keep their velocity; the updated losers take the new one
        velocity = state.velocity.clone()
        velocity[losers] = v_new
        return x_new, state.replace(offspring=x_new, off_velocity=v_new, velocity=velocity,
                                    seed=seed)

    def tell(self, state: LMOCSOState, fitness: torch.Tensor) -> LMOCSOState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_v = torch.cat([state.velocity, state.off_velocity])
        merged_fit = torch.cat([state.fitness, fitness])
        winner, has = ref_vec_guided_indices(
            merged_fit, self.vectors, apd_theta(state.gen, self.max_gen, self.alpha, self.device))
        keep = has[:, None]
        sel_pop = torch.where(keep, merged_pop[winner], 0.0)
        sel_fit = torch.where(keep, merged_fit[winner], torch.inf)
        sel_v = torch.where(keep, merged_v[winner], 0.0)  # survivors keep momentum
        reps = -(-self.pop_size // sel_pop.shape[0])
        n = self.pop_size
        return state.replace(
            population=sel_pop.repeat(reps, 1)[:n],
            fitness=sel_fit.repeat(reps, 1)[:n],
            velocity=sel_v.repeat(reps, 1)[:n],
            gen=state.gen + 1,
        )
