"""SaDE, Self-adaptive Differential Evolution (Qin, Huang & Suganthan 2009)
— the port of ``evox_tpu/algorithms/so/de/sade.py``.

Four strategies (rand/1/bin, rand-to-best/2/bin, rand/2/bin,
current-to-rand/1), chosen per individual with probabilities learnt from
the successes and failures of the last ``learning_period`` generations; a
CR memory per strategy. The strategy draw is ``weighted_indices`` over
the probabilities on the generation's uniforms (``jax.random.choice(p=)``
on the same uniforms gives the same indices); the memories are rows of
``strategy_success_counts``. The generation counter is a host integer.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ....core.attribution import (
    SADE_STRATEGY_TAGS,
    Attribution,
    improvement_mass,
    strategy_success_counts,
    success_mask,
)
from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....operators.sanitize import sanitize_bounds, validate_bound_handling
from ....utils.common import generator, split_seed, weighted_indices
from .common import DEAlgorithm, crossover_mask, greedy
from .de import select_rand_indices

N_STRATEGY = 4


class SaDEState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    trials: torch.Tensor = field(storage=True)
    strategy: torch.Tensor = field(storage=True)  # (pop,) the strategy chosen this generation
    CR: torch.Tensor = field(storage=True)  # (pop,) the crossover rate drawn this generation
    probs: torch.Tensor  # (4,) strategy probabilities
    success_mem: torch.Tensor  # (LP, 4) success counts, a ring
    failure_mem: torch.Tensor
    CRm: torch.Tensor  # (4,) CR memory per strategy
    gen: int
    attrib: Attribution
    seed: int


class SaDE(DEAlgorithm):
    def __init__(self, lb: Any, ub: Any, pop_size: int, learning_period: int = 50,
                 bound_handling: str = "clip", device: DeviceLike = None):
        self.bound_handling = validate_bound_handling(bound_handling)
        super().__init__(lb, ub, pop_size, device)
        self.LP = learning_period
        self.tags = torch.tensor(SADE_STRATEGY_TAGS, dtype=torch.int32, device=self.device)

    def init(self, seed: int) -> SaDEState:
        seed, pop_seed = split_seed(seed)
        pop = self._uniform_population(pop_seed)
        n, dev = self.pop_size, self.device
        return SaDEState(
            population=pop,
            fitness=self._inf_fitness(),
            trials=pop,
            strategy=torch.zeros((n,), dtype=torch.int64, device=dev),
            CR=torch.full((n,), 0.5, device=dev),
            probs=torch.full((N_STRATEGY,), 1.0 / N_STRATEGY, device=dev),
            success_mem=torch.zeros((self.LP, N_STRATEGY), device=dev),
            failure_mem=torch.zeros((self.LP, N_STRATEGY), device=dev),
            CRm=torch.full((N_STRATEGY,), 0.5, device=dev),
            gen=0,
            attrib=Attribution.empty(n, dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws: ``u_strategy`` ``(pop,)`` uniforms (the
        strategy draw's), ``z_F`` and ``z_CR`` ``(pop, 1)`` standard normals,
        ``idx`` ``(pop, 5)``, ``u_rec`` ``(pop, 1)``, ``u_cr`` ``(pop, dim)``,
        ``j_rand`` ``(pop, 1)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        return {
            "u_strategy": torch.rand((n,), generator=g, device=dev),
            "z_F": torch.randn((n, 1), generator=g, device=dev),
            "z_CR": torch.randn((n, 1), generator=g, device=dev),
            "idx": select_rand_indices(s_idx, n, 5, dev),
            "u_rec": torch.rand((n, 1), generator=g, device=dev),
            "u_cr": torch.rand((n, d), generator=g, device=dev),
            "j_rand": torch.randint(0, d, (n, 1), generator=g, device=dev),
        }

    def ask(self, state: SaDEState) -> Tuple[torch.Tensor, SaDEState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop = state.population
        strategy = weighted_indices(state.probs, draws["u_strategy"])
        F = torch.clamp(0.5 + 0.3 * draws["z_F"], 1e-3, 2.0)
        CR = torch.clamp(state.CRm[strategy][:, None] + 0.1 * draws["z_CR"], 0.0, 1.0)
        r1, r2, r3, r4, r5 = (draws["idx"][:, i] for i in range(5))
        best = pop.index_select(0, torch.argmin(state.fitness).view(1))  # (1, dim): no host read
        rec = draws["u_rec"]
        v0 = pop[r1] + F * (pop[r2] - pop[r3])  # rand/1
        v1 = pop + F * (best - pop) + F * (pop[r1] - pop[r2]) + F * (pop[r3] - pop[r4])  # rand-to-best/2
        v2 = pop[r1] + F * (pop[r2] - pop[r3]) + F * (pop[r4] - pop[r5])  # rand/2
        v3 = pop + rec * (pop[r1] - pop) + F * (pop[r2] - pop[r3])  # current-to-rand/1
        mask = crossover_mask(draws["u_cr"], CR, draws["j_rand"])
        s = strategy[:, None]
        trials = torch.where(s == 3, v3, torch.where(mask, torch.where(
            s == 0, v0, torch.where(s == 1, v1, v2)), pop))
        trials = sanitize_bounds(trials, self.lb, self.ub, self.bound_handling)
        return trials, state.replace(trials=trials, strategy=strategy, CR=CR[:, 0], seed=seed)

    def tell(self, state: SaDEState, fitness: torch.Tensor) -> SaDEState:
        improved = success_mask(fitness, state.fitness)
        succ, fail, onehot = strategy_success_counts(improved, state.strategy, N_STRATEGY)
        slot = state.gen % self.LP
        success_mem = state.success_mem.clone()
        failure_mem = state.failure_mem.clone()
        success_mem[slot] = succ
        failure_mem[slot] = fail
        probs, CRm = state.probs, state.CRm
        if state.gen >= self.LP:  # a host integer: no device read
            S = success_mem.sum(dim=0)
            Fl = failure_mem.sum(dim=0)
            rate = S / torch.clamp_min(S + Fl, 1.0) + 0.01
            probs = rate / rate.sum()
            # the mean of the CR values that succeeded, per strategy
            succ_cr = (improved[:, None] * onehot) * state.CR[:, None]
            mean_cr = torch.sum(succ_cr, dim=0) / torch.clamp_min(succ, 1.0)
            CRm = torch.where(succ > 0, mean_cr, state.CRm)
        attrib = Attribution(
            parent_idx=torch.arange(self.pop_size, dtype=torch.int32, device=self.device),
            op_tag=self.tags[state.strategy],
            success=improved,
            improvement=improvement_mass(fitness, state.fitness, improved),
        )
        return state.replace(
            population=greedy(improved, state.trials, state.population),
            fitness=greedy(improved, fitness, state.fitness),
            probs=probs,
            success_mem=success_mem,
            failure_mem=failure_mem,
            CRm=CRm,
            gen=state.gen + 1,
            attrib=attrib,
        )
