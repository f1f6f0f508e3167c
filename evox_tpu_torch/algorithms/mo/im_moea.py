"""IM-MOEA (Cheng, Jin, Narukawa & Sendhoff 2015), the inverse-model MOEA
— the port of ``evox_tpu/algorithms/mo/im_moea.py``.

The population is grouped by reference direction into ``K`` clusters of
``S`` members; in each cluster a univariate GP learns the inverse map from
one objective to one decision variable, for every variable, and sampling
those models (with their predictive noise) at jittered objective values
gives the offspring. The JAX package ``vmap``s the ``K × d`` fits; here
they are one batched :meth:`~evox_tpu_torch.operators.gaussian_process.
GPRegression.fit` over ``(K, d)`` GPs of ``S`` points and one batched
``sample``. ``tell`` is ``non_dominate`` (one ``packed_dominance`` launch).

Every draw of ``ask`` comes from one ``_draw`` (the objective each model
reads, the target jitter, the posterior normals, the polynomial
mutation's sites and uniforms), which tests replace with the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode, field
from ...operators.gaussian_process import GPRegression
from ...operators.mutation.ops import polynomial
from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.non_dominate import non_dominate
from ...utils.common import cos_dist, float_vector, generator, row_norm, split_seed
from .common import uniform_init


class IMMOEAState(PyTreeNode):
    population: torch.Tensor = field(storage=True)
    fitness: torch.Tensor = field(storage=True)
    offspring: torch.Tensor = field(storage=True)
    seed: int


class IMMOEA(Algorithm):
    """``pop_size`` is rounded down to ``K * S`` (``K = min(k_clusters,
    the UniformSampling count)``, ``S = max(2, pop_size // K)``).
    ``mesh``: a :class:`~evox_tpu_torch.core.distributed.Mesh`; the tell's
    environmental selection then sorts row-sharded over its ``"pop"``
    axis, with the same survivors. ``device``: ``None`` means ``"cuda"``."""

    # not under torch.func.vmap: its tell fits Gaussian processes with autograd,
    # which torch.func.vmap refuses; stacked members run one by one
    stackable = False

    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, k_clusters: int = 5,
                 gp_fit_steps: int = 10, mesh: Any = None, device: DeviceLike = None):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.n_objs = n_objs
        w, nk = UniformSampling(k_clusters, n_objs, device=self.device)()
        self.K = min(k_clusters, nk)
        self.dirs = (w / row_norm(w)[:, None])[: self.K]
        self.S = max(2, pop_size // self.K)
        self.pop_size = self.K * self.S
        self.gp = GPRegression(fit_steps=gp_fit_steps, device=self.device)

    def init(self, seed: int) -> IMMOEAState:
        seed, pop_seed = split_seed(seed)
        pop = uniform_init(pop_seed, self.lb, self.ub, self.pop_size)
        return IMMOEAState(
            population=pop,
            fitness=torch.full((self.pop_size, self.n_objs), float("inf"), device=self.device),
            offspring=pop,
            seed=seed,
        )

    def init_ask(self, state: IMMOEAState) -> Tuple[torch.Tensor, IMMOEAState]:
        return state.population, state

    def init_tell(self, state: IMMOEAState, fitness: torch.Tensor) -> IMMOEAState:
        return state.replace(fitness=fitness)

    def _draw(self, seed: int) -> dict:
        """A generation's draws: ``obj_pick`` ``(K, d)``, the objective each
        model reads; ``u_target`` and ``z_post`` ``(K, d, S)``, the target
        jitter's uniforms and the posterior normals; ``site`` and ``u_pm``
        ``(pop, d)``, the polynomial mutation's."""
        g, dev = generator(seed, self.device), self.device
        K, S, d, n = self.K, self.S, self.dim, self.pop_size
        return {
            "obj_pick": torch.randint(0, self.n_objs, (K, d), generator=g, device=dev),
            "u_target": torch.rand((K, d, S), generator=g, device=dev),
            "z_post": torch.randn((K, d, S), generator=g, device=dev),
            "site": torch.rand((n, d), generator=g, device=dev) < 1.0 / d,
            "u_pm": torch.rand((n, d), generator=g, device=dev),
        }

    def inverse_data(self, state: IMMOEAState, obj_pick: torch.Tensor):
        """``(fx, x)``, each ``(K, d, S)``: for cluster ``c`` and variable
        ``i``, the objective ``obj_pick[c, i]`` of the cluster's members
        (the GP's input) and their variable ``i`` (its target). A cluster
        is the ``S`` members of best cosine to its reference direction."""
        K, S, d = self.K, self.S, self.dim
        pop, fit = state.population, state.fitness
        cos = cos_dist(fit - fit.amin(0) + 1e-9, self.dirs)  # (n, K)
        members = torch.argsort(-cos, dim=0, stable=True)[:S].T  # (K, S)
        x = pop[members].transpose(1, 2)
        f = fit[members]  # (K, S, m)
        pick = obj_pick.to(torch.int64)[:, None, :].expand(K, S, d)
        return torch.gather(f, 2, pick).transpose(1, 2), x

    def sample(self, model, fx: torch.Tensor, draws: dict) -> torch.Tensor:
        """Offspring ``(pop, d)`` from the fitted inverse models, sampled at
        the members' objective values jittered by a tenth of each model's
        range, before mutation."""
        span = fx.amax(-1, keepdim=True) - fx.amin(-1, keepdim=True)
        targets = fx + 0.1 * span * (draws["u_target"] - 0.5)
        cols = self.gp.sample(0, model, targets, z=draws["z_post"])  # (K, d, S)
        return cols.transpose(1, 2).reshape(self.pop_size, self.dim)

    def mutate(self, offspring: torch.Tensor, draws: dict) -> torch.Tensor:
        offspring = polynomial(0, offspring, (self.lb, self.ub), site=draws["site"],
                               u=draws["u_pm"])
        return torch.clamp(offspring, self.lb, self.ub)

    def ask(self, state: IMMOEAState) -> Tuple[torch.Tensor, IMMOEAState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        fx, x = self.inverse_data(state, draws["obj_pick"])
        # one inverse GP per (cluster, variable), all in one batched fit
        model = self.gp.fit(fx, x)
        offspring = self.mutate(self.sample(model, fx, draws), draws)
        return offspring, state.replace(offspring=offspring, seed=seed)

    def tell(self, state: IMMOEAState, fitness: torch.Tensor) -> IMMOEAState:
        merged_pop = torch.cat([state.population, state.offspring])
        merged_fit = torch.cat([state.fitness, fitness])
        pop, fit = non_dominate(merged_pop, merged_fit, self.pop_size, mesh=self.mesh)
        return state.replace(population=pop, fitness=fit)
