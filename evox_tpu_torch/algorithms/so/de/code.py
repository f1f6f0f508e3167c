"""CoDE, Composite Differential Evolution (Wang, Cai & Zhang 2011) — the
port of ``evox_tpu/algorithms/so/de/code.py``.

Each parent makes three trials, one per strategy (rand/1/bin, rand/2/bin,
current-to-rand/1), each with an [F, CR] pair drawn from the paper's pool;
the workflow evaluates all ``3 * pop_size`` and ``tell`` keeps each
parent's best trial (``torch.argmin`` over the strategy axis: the first
minimum, a NaN counting as the minimum, as ``jnp.argmin``), then selects
greedily against the parent.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ....core.attribution import CODE_STRATEGY_TAGS, Attribution, improvement_mass, success_mask
from ....core.device import DeviceLike
from ....core.struct import PyTreeNode, field
from ....operators.sanitize import sanitize_bounds, validate_bound_handling
from ....utils.common import generator, split_seed
from .common import DEAlgorithm, crossover_mask, greedy
from .de import select_rand_indices

# [F, CR] parameter pool (Wang et al. 2011, §III)
PARAM_POOL = ((1.0, 0.1), (1.0, 0.9), (0.8, 0.2))


class CoDEState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    trials: torch.Tensor = field(storage=True)  # (3 * pop, dim)
    # the three trials a parent folded to the best one's strategy tag
    attrib: Attribution
    seed: int


class CoDE(DEAlgorithm):
    def __init__(self, lb: Any, ub: Any, pop_size: int, bound_handling: str = "clip",
                 device: DeviceLike = None):
        self.bound_handling = validate_bound_handling(bound_handling)
        super().__init__(lb, ub, pop_size, device)
        self.pool = torch.tensor(PARAM_POOL, dtype=torch.float32, device=self.device)
        self.tags = torch.tensor(CODE_STRATEGY_TAGS, dtype=torch.int32, device=self.device)

    def init(self, seed: int) -> CoDEState:
        seed, pop_seed = split_seed(seed)
        pop = self._uniform_population(pop_seed)
        return CoDEState(
            population=pop,
            fitness=self._inf_fitness(),
            trials=pop.repeat(3, 1),
            attrib=Attribution.empty(self.pop_size, self.device),
            seed=seed,
        )

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws: ``idx`` ``(pop, 5)``, ``pool_rows`` ``(3,
        pop)`` rows of the pool, ``u_rec`` ``(pop, 1)``, ``u_cr`` ``(2, pop,
        dim)`` and ``j_rand`` ``(2, pop, 1)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        return {
            "idx": select_rand_indices(s_idx, n, 5, dev),
            "pool_rows": torch.randint(0, len(PARAM_POOL), (3, n), generator=g, device=dev),
            "u_rec": torch.rand((n, 1), generator=g, device=dev),
            "u_cr": torch.rand((2, n, d), generator=g, device=dev),
            "j_rand": torch.randint(0, d, (2, n, 1), generator=g, device=dev),
        }

    def ask(self, state: CoDEState) -> Tuple[torch.Tensor, CoDEState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop = state.population
        r1, r2, r3, r4, r5 = (draws["idx"][:, i] for i in range(5))
        F = self.pool[draws["pool_rows"], 0][:, :, None]
        CR = self.pool[draws["pool_rows"], 1][:, :, None]
        v1 = pop[r1] + F[0] * (pop[r2] - pop[r3])  # rand/1
        v2 = pop[r1] + F[1] * (pop[r2] - pop[r3]) + F[1] * (pop[r4] - pop[r5])  # rand/2
        v3 = pop + draws["u_rec"] * (pop[r1] - pop) + F[2] * (pop[r2] - pop[r3])  # cur-to-rand
        u, j = draws["u_cr"], draws["j_rand"]
        t1 = torch.where(crossover_mask(u[0], CR[0], j[0]), v1, pop)
        t2 = torch.where(crossover_mask(u[1], CR[1], j[1]), v2, pop)
        trials = sanitize_bounds(torch.cat([t1, t2, v3]), self.lb, self.ub, self.bound_handling)
        return trials, state.replace(trials=trials, seed=seed)

    def tell(self, state: CoDEState, fitness: torch.Tensor) -> CoDEState:
        n = self.pop_size
        trial_fit = fitness.reshape(3, n)
        best_strat = torch.argmin(trial_fit, dim=0)
        best_fit = torch.amin(trial_fit, dim=0)
        best_trial = state.trials.reshape(3, n, self.dim)[best_strat, torch.arange(n, device=self.device)]
        improved = success_mask(best_fit, state.fitness)
        attrib = Attribution(
            parent_idx=torch.arange(n, dtype=torch.int32, device=self.device),
            op_tag=self.tags[best_strat],
            success=improved,
            improvement=improvement_mass(best_fit, state.fitness, improved),
        )
        return state.replace(
            population=greedy(improved, best_trial, state.population),
            fitness=greedy(improved, best_fit, state.fitness),
            attrib=attrib,
        )
