"""JaDE, Adaptive Differential Evolution (Zhang & Sanderson 2009) — the
port of ``evox_tpu/algorithms/so/de/jade.py``.

current-to-pbest/1 with an external archive of replaced parents;
per-individual F ~ Cauchy(mu_F, 0.1) and CR ~ N(mu_CR, 0.1), the means
adapted from the successful values (Lehmer and arithmetic means). The
pbest set, ``argsort(fitness)[:p_num]`` in the JAX package, is
``partial_topk`` (B4) on the sort key of ``common.sort_key``: the same
indices, one kernel launch a generation on the card. The archive's size
stays on the card (no host read).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ....core.attribution import (
    OP_DE_CUR_TO_PBEST_1,
    Attribution,
    arithmetic_mean_of_successful,
    lehmer_mean_of_successful,
    slot_attribution,
    success_mask,
)
from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....operators.sanitize import sanitize_bounds, validate_bound_handling
from ....utils.common import generator, split_seed
from .common import DEAlgorithm, crossover_mask, greedy, pbest_cut, update_archive
from .de import select_rand_indices


class JaDEState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    trials: torch.Tensor = field(storage=True)
    F: torch.Tensor = field(storage=True)  # (pop,) this generation's
    CR: torch.Tensor = field(storage=True)
    mu_F: torch.Tensor  # 0-dim
    mu_CR: torch.Tensor
    archive: torch.Tensor = field(storage=True)  # (pop, dim) replaced parents
    archive_size: torch.Tensor  # 0-dim int64
    attrib: Attribution
    seed: int
    slots: Optional[torch.Tensor] = None  # the archive's random slots for the next tell


def cauchy(g: torch.Generator, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Standard Cauchy draws."""
    return torch.empty(shape, device=device).cauchy_(generator=g)


def current_to_pbest(pop: torch.Tensor, pbest: torch.Tensor, x_r1: torch.Tensor, x_r2: torch.Tensor,
                     F: torch.Tensor) -> torch.Tensor:
    """``x + F (x_pbest - x) + F (x_r1 - x~_r2)``."""
    return pop + F[:, None] * (pbest - pop) + F[:, None] * (x_r1 - x_r2)


def archive_partner(pop: torch.Tensor, archive: torch.Tensor, archive_size: torch.Tensor,
                    r2_raw: torch.Tensor, use_archive: bool = True) -> torch.Tensor:
    """The rows ``x~_r2`` from the population united with the archive:
    ``r2_raw`` in ``[0, 2 pop)``; at or past ``pop`` it names archive row
    ``r2_raw - pop`` while that row is filled, else the population's."""
    n = pop.shape[0]
    in_archive = (r2_raw >= n) & ((r2_raw - n) < archive_size) & use_archive
    r2 = torch.remainder(torch.where(r2_raw >= n, r2_raw - n, r2_raw), n)
    return torch.where(in_archive[:, None], archive[r2], pop[r2])


class JaDE(DEAlgorithm):
    def __init__(self, lb: Any, ub: Any, pop_size: int, p_best: float = 0.05, c: float = 0.1,
                 use_archive: bool = True, bound_handling: str = "clip", device: DeviceLike = None):
        self.bound_handling = validate_bound_handling(bound_handling)
        super().__init__(lb, ub, pop_size, device)
        self.p_num = max(1, int(p_best * pop_size))
        self.c = c
        self.use_archive = use_archive

    def init(self, seed: int) -> JaDEState:
        seed, pop_seed = split_seed(seed)
        pop = self._uniform_population(pop_seed)
        n, dev = self.pop_size, self.device
        return JaDEState(
            population=pop,
            fitness=self._inf_fitness(),
            trials=pop,
            F=torch.full((n,), 0.5, device=dev),
            CR=torch.full((n,), 0.5, device=dev),
            mu_F=torch.tensor(0.5, device=dev),
            mu_CR=torch.tensor(0.5, device=dev),
            archive=pop,
            archive_size=torch.zeros((), dtype=torch.int64, device=dev),
            attrib=Attribution.empty(n, dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws: ``cauchy`` and ``z_CR`` ``(pop,)``,
        ``pbest_pick`` ``(pop,)`` ranks in ``[0, p_num)``, ``r1`` ``(pop,)``
        other rows, ``r2_raw`` ``(pop,)`` in ``[0, 2 pop)``, ``u_cr`` ``(pop,
        dim)``, ``j_rand`` ``(pop, 1)``, and the tell's ``slots`` ``(pop,)``
        in ``[0, pop)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        return {
            "cauchy": cauchy(g, (n,), dev),
            "z_CR": torch.randn((n,), generator=g, device=dev),
            "pbest_pick": torch.randint(0, self.p_num, (n,), generator=g, device=dev),
            "r1": select_rand_indices(s_idx, n, 1, dev)[:, 0],
            "r2_raw": torch.randint(0, 2 * n, (n,), generator=g, device=dev),
            "u_cr": torch.rand((n, d), generator=g, device=dev),
            "j_rand": torch.randint(0, d, (n, 1), generator=g, device=dev),
            "slots": torch.randint(0, n, (n,), generator=g, device=dev),
        }

    def ask(self, state: JaDEState) -> Tuple[torch.Tensor, JaDEState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop = state.population
        F = torch.clamp(state.mu_F + 0.1 * draws["cauchy"], 0.0, 1.0)
        F = torch.where(F <= 0.0, 0.1, F)  # the degenerate draw's guard
        CR = torch.clamp(state.mu_CR + 0.1 * draws["z_CR"], 0.0, 1.0)
        pbest = pop[pbest_cut(state.fitness, self.p_num)[draws["pbest_pick"]]]
        x_r2 = archive_partner(pop, state.archive, state.archive_size, draws["r2_raw"],
                               self.use_archive)
        mutant = current_to_pbest(pop, pbest, pop[draws["r1"]], x_r2, F)
        mask = crossover_mask(draws["u_cr"], CR[:, None], draws["j_rand"])
        trials = sanitize_bounds(torch.where(mask, mutant, pop), self.lb, self.ub,
                                 self.bound_handling)
        return trials, state.replace(trials=trials, F=F, CR=CR, seed=seed, slots=draws["slots"])

    def tell(self, state: JaDEState, fitness: torch.Tensor) -> JaDEState:
        if state.slots is None:
            raise ValueError("JaDE.tell needs the state that JaDE.ask returned")
        improved = success_mask(fitness, state.fitness)
        n_success = torch.sum(improved)
        lehmer = lehmer_mean_of_successful(state.F, improved)
        arith = arithmetic_mean_of_successful(state.CR, improved, n_success)
        any_s = n_success > 0
        mu_F = torch.where(any_s, (1 - self.c) * state.mu_F + self.c * lehmer, state.mu_F)
        mu_CR = torch.where(any_s, (1 - self.c) * state.mu_CR + self.c * arith, state.mu_CR)
        archive, archive_size = update_archive(state.archive, state.archive_size, state.population,
                                               improved, state.slots)
        return state.replace(
            population=greedy(improved, state.trials, state.population),
            fitness=greedy(improved, fitness, state.fitness),
            mu_F=mu_F,
            mu_CR=mu_CR,
            archive=archive,
            archive_size=archive_size,
            attrib=slot_attribution(fitness, state.fitness, OP_DE_CUR_TO_PBEST_1),
            slots=None,
        )
