"""RVEA (Cheng, Jin, Olhofer & Sendhoff 2016): reference-vector guided EA —
the port of ``evox_tpu/algorithms/mo/rvea.py``. Angle-penalised distance
(APD) selection, one row per reference vector, and the vectors adapted to
the objective ranges every ``fr · max_gen`` generations. Mating draws
uniformly among the rows of finite fitness (empty niches hold +inf).

The generation counter is a host integer; ``theta = (gen / max_gen) **
alpha`` is computed in float32, as the JAX package computes it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.struct import PyTreeNode, field
from ...operators.crossover.sbx import simulated_binary
from ...operators.mutation.ops import polynomial
from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.rvea_selection import ref_vec_guided
from ...utils.common import generator, row_norm, split_seed
from .common import GAMOAlgorithm, draw_variation, uniform_init, weighted_indices

class RVEAState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    vectors: torch.Tensor = field(storage=True)
    offspring: torch.Tensor = field(storage=True)
    gen: int
    seed: int


def apd_theta(gen: int, max_gen: int, alpha: float, device: torch.device) -> torch.Tensor:
    """The APD penalty's ``(gen / max_gen) ** alpha``, in float32."""
    return (torch.tensor(float(gen), device=device) / max_gen) ** alpha


def finite_range(fit: torch.Tensor) -> torch.Tensor:
    """``(m,)``: the range of each objective over the rows of finite
    fitness, at least 1e-6."""
    finite = torch.all(torch.isfinite(fit), dim=1)[:, None]
    fmax = torch.amax(torch.where(finite, fit, -torch.inf), dim=0)
    fmin = torch.amin(torch.where(finite, fit, torch.inf), dim=0)
    return torch.clamp_min(fmax - fmin, 1e-6)


class RVEA(GAMOAlgorithm):
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, alpha: float = 2.0,
                 fr: float = 0.1, max_gen: int = 100, mesh: Any = None, device: Any = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        v, n = UniformSampling(pop_size, n_objs, device=self.device)()
        self.v0 = v / row_norm(v)[:, None]
        self.pop_size = n
        self.alpha = alpha
        self.fr = fr
        self.max_gen = max_gen
        self.adapt_every = max(1, int(fr * max_gen))

    def init(self, seed: int) -> RVEAState:
        seed, pop_seed = split_seed(seed)
        pop = uniform_init(pop_seed, self.lb, self.ub, self.pop_size)
        return RVEAState(
            population=pop,
            fitness=torch.full((self.pop_size, self.n_objs), torch.inf, device=self.device),
            vectors=self.v0,
            offspring=pop,
            gen=0,
            seed=seed,
        )

    def _draw(self, seed: int, rows: int) -> dict:
        """``u_mate`` ``(rows,)``, the uniform draw of the mating pool, and
        the variation's draws."""
        g = generator(seed, self.device)
        u_mate = torch.rand((rows,), generator=g, device=self.device)
        return {"u_mate": u_mate, **draw_variation(g, rows // 2, rows, self.dim, self.device)}

    def ask(self, state: RVEAState) -> Tuple[torch.Tensor, RVEAState]:
        seed, draw_seed = split_seed(state.seed)
        rows = state.population.shape[0]
        d = self._draw(draw_seed, rows)
        # mate only among the niche winners (finite fitness)
        valid = torch.all(torch.isfinite(state.fitness), dim=1)
        p = valid.to(torch.float32) / torch.clamp_min(valid.sum(), 1)
        mate = weighted_indices(p, d["u_mate"])
        # SBX over consecutive pairs of the pool (both children), then
        # polynomial mutation
        off = simulated_binary(0, state.population[mate], u=d["u_sbx"])
        off = polynomial(0, off, (self.lb, self.ub), site=d["site"], u=d["u_pm"])
        return off, state.replace(offspring=off, seed=seed)

    def tell(self, state: RVEAState, fitness: torch.Tensor) -> RVEAState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        pop, fit = ref_vec_guided(merged_pop, merged_fit, state.vectors,
                                  apd_theta(state.gen, self.max_gen, self.alpha, self.device))
        gen = state.gen + 1
        vectors = state.vectors
        if gen % self.adapt_every == 0:  # adapt to the objective ranges
            adapted = self.v0 * finite_range(fit)
            vectors = adapted / row_norm(adapted)[:, None]
        return state.replace(population=pop, fitness=fit, vectors=vectors, gen=gen)
