"""RVEA* (RVEAa): RVEA with reference-vector regeneration for irregular
Pareto fronts (Cheng et al. 2016, §V) — the port of
``evox_tpu/algorithms/mo/rveaa.py``. A second, adaptive vector set is
regenerated every adaptation cycle from random directions scaled by the
objective ranges; selection runs over both sets (2 × the vectors rows)."""

from __future__ import annotations

import torch

from ...utils.common import generator, row_norm, split_seed
from .common import uniform_init
from ...operators.selection.rvea_selection import ref_vec_guided
from .rvea import RVEA, RVEAState, apd_theta, finite_range


class RVEAa(RVEA):
    def init(self, seed: int) -> RVEAState:
        seed, pop_seed = split_seed(seed)
        nv = self.v0.shape[0]
        pop = uniform_init(pop_seed, self.lb, self.ub, 2 * nv)
        return RVEAState(
            population=pop,
            fitness=torch.full((2 * nv, self.n_objs), torch.inf, device=self.device),
            vectors=torch.cat([self.v0, self.v0]),  # [fixed, adaptive]
            offspring=pop,
            gen=0,
            seed=seed,
        )

    def _draw_directions(self, seed: int) -> torch.Tensor:
        """``tell``'s draw: ``(nv, m)`` uniform, the adaptive half's raw
        directions."""
        return torch.rand((self.v0.shape[0], self.n_objs), generator=generator(seed, self.device),
                          device=self.device)

    def tell(self, state: RVEAState, fitness: torch.Tensor) -> RVEAState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        pop, fit = ref_vec_guided(merged_pop, merged_fit, state.vectors,
                                  apd_theta(state.gen, self.max_gen, self.alpha, self.device))
        seed, regen_seed = split_seed(state.seed)
        vectors = state.vectors
        if state.gen % self.adapt_every == 0:
            # random unit directions scaled by the objective ranges
            rand = self._draw_directions(regen_seed) * finite_range(fit)
            rand = rand / torch.clamp_min(row_norm(rand), 1e-12)[:, None]
            vectors = torch.cat([self.v0, rand])
        return state.replace(population=pop, fitness=fit, vectors=vectors, gen=state.gen + 1,
                             seed=seed)
