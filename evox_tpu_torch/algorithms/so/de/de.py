"""Differential Evolution (Storn & Price 1997) — the port of
``evox_tpu/algorithms/so/de/de.py``.

rand or best base vector, ``num_difference_vectors`` difference pairs,
binomial crossover and the ``bound_handling`` repair of
``operators/sanitize.py``; greedy selection slot by slot. Every draw of a
generation comes from one ``_draw`` method, which the tests replace with
the JAX package's draws.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ....core.attribution import Attribution, de_variant_tag, slot_attribution
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode, field
from ....operators.sanitize import sanitize_bounds, validate_bound_handling
from ....utils.common import generator, split_seed
from .common import DEAlgorithm, crossover_mask, greedy


def select_rand_indices(seed: int, pop_size: int, n: int, device: DeviceLike = None) -> torch.Tensor:
    """``(pop_size, n)`` int64 random indices, distinct within each row and
    never the row's own index, every such choice equally likely: the
    distribution of the JAX function (a per-row ``jax.random.choice``
    without replacement over the other rows). Drawn in ``n`` rounds: round
    ``j`` draws an integer below ``pop_size - 1 - j`` and shifts it past the
    row's index and its earlier picks in ascending order. No permutation
    per row (a sort of a ``(pop, pop - 1)`` matrix at every generation).
    ``device``: ``None`` means ``"cuda"``."""
    if not 0 < n < pop_size:
        raise ValueError(f"cannot pick {n} distinct other rows among {pop_size}")
    dev = resolve_device(device)
    g = generator(seed, dev)
    taken = torch.arange(pop_size, device=dev)[:, None]  # excluded so far, ascending per row
    picks = []
    for j in range(n):
        v = torch.randint(0, pop_size - 1 - j, (pop_size, 1), generator=g, device=dev)
        for c in range(taken.shape[1]):
            v = v + (v >= taken[:, c : c + 1])
        picks.append(v)
        taken = torch.sort(torch.cat([taken, v], dim=1), dim=1).values
    return torch.cat(picks, dim=1)


class DEState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    trials: torch.Tensor = field(storage=True)
    # this generation's operator attribution (core/attribution.py)
    attrib: Attribution
    seed: int


class DE(DEAlgorithm):
    def __init__(
        self,
        lb: Any,
        ub: Any,
        pop_size: int,
        base_vector: str = "rand",  # "rand" | "best"
        num_difference_vectors: int = 1,
        differential_weight: float = 0.5,
        cross_probability: float = 0.9,
        bound_handling: str = "clip",
        device: DeviceLike = None,
    ):
        if base_vector not in ("rand", "best"):
            raise ValueError(f"base_vector must be 'rand' or 'best', got {base_vector!r}")
        self.bound_handling = validate_bound_handling(bound_handling)
        super().__init__(lb, ub, pop_size, device)
        self.base_vector = base_vector
        self.n_diff = num_difference_vectors
        self.F = differential_weight
        self.CR = cross_probability
        self.op_tag = de_variant_tag(base_vector, self.n_diff)

    def init(self, seed: int) -> DEState:
        seed, pop_seed = split_seed(seed)
        pop = self._uniform_population(pop_seed)
        return DEState(
            population=pop,
            fitness=self._inf_fitness(),
            trials=pop,
            attrib=Attribution.empty(self.pop_size, self.device),
            seed=seed,
        )

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws: ``idx`` ``(pop, 2 n_diff + 1)`` (the base
        and difference rows), ``u_cr`` ``(pop, dim)`` uniforms and
        ``j_rand`` ``(pop, 1)`` forced columns."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        return {
            "idx": select_rand_indices(s_idx, n, 2 * self.n_diff + 1, dev),
            "u_cr": torch.rand((n, d), generator=g, device=dev),
            "j_rand": torch.randint(0, d, (n, 1), generator=g, device=dev),
        }

    def _mutate(self, state: Any, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        idx = draws["idx"]
        pop = state.population
        if self.base_vector == "best":
            base = pop.index_select(0, torch.argmin(state.fitness).view(1))  # (1, dim): no host read
        else:
            base = pop[idx[:, 0]]
        diff = torch.zeros_like(pop)
        for d in range(self.n_diff):
            diff = diff + pop[idx[:, 2 * d + 1]] - pop[idx[:, 2 * d + 2]]
        mutant = base + self.F * diff
        mask = crossover_mask(draws["u_cr"], self.CR, draws["j_rand"])
        return sanitize_bounds(torch.where(mask, mutant, pop), self.lb, self.ub,
                               self.bound_handling)

    def ask(self, state: DEState) -> Tuple[torch.Tensor, DEState]:
        seed, k = split_seed(state.seed)
        trials = self._mutate(state, self._draw(k))
        return trials, state.replace(trials=trials, seed=seed)

    def tell(self, state: DEState, fitness: torch.Tensor) -> DEState:
        attrib = slot_attribution(fitness, state.fitness, self.op_tag)
        improved = attrib.success
        return state.replace(
            population=greedy(improved, state.trials, state.population),
            fitness=greedy(improved, fitness, state.fitness),
            attrib=attrib,
        )
