"""θ-DEA (Yuan, Xu, Wang & Yao 2016): theta-dominance based EA — the port of
``evox_tpu/algorithms/mo/tdea.py``.

Rows are clustered to their reference direction of largest cosine (after
NSGA-III's normalisation); inside a cluster, PBI (``d1 + theta d2``) ranks
them. Selection keeps the best by (Pareto rank, theta-rank, PBI). The sort
stops once the survivors are ranked (``until=k``): the rows it leaves
unranked sort after every ranked row, as under a full peel.
"""

from __future__ import annotations

from typing import Any

import torch

from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import lexsort, row_norm, sqrt_rn
from .common import GAMOAlgorithm, MOState
from .nsga3 import associate, normalize


class TDEA(GAMOAlgorithm):

    # not under torch.func.vmap: its selection scatters in place into unbatched
    # tensors; stacked members run one by one
    stackable = False
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, theta: float = 5.0,
                 mesh: Any = None, device: Any = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        refs, n = UniformSampling(pop_size, n_objs, device=self.device)()
        self.refs = refs / row_norm(refs)[:, None]
        # boundary directions (one nonzero component) take a huge theta, so
        # their clusters select by perpendicular distance: the extremes stay
        boundary = torch.sum(refs > 1e-4, dim=1) == 1
        self.theta_vec = torch.where(boundary, 1e6, theta)
        self.pop_size = n

    def select(self, state: MOState, pop: torch.Tensor, fit: torch.Tensor):
        norm, best, cluster = associate(normalize(fit), self.refs)
        d1 = norm * best
        d2 = norm * sqrt_rn(torch.clamp_min(1.0 - best * best, 0.0))
        pbi = d1 + self.theta_vec[cluster] * d2
        # theta-rank: each row's place inside its cluster by pbi
        n = fit.shape[0]
        ar = torch.arange(n, device=fit.device)
        order = lexsort((pbi, cluster))  # cluster-major, pbi ascending
        sorted_cluster = cluster[order]
        new_cluster = torch.cat([torch.ones((1,), dtype=torch.bool, device=fit.device),
                                 sorted_cluster[1:] != sorted_cluster[:-1]])
        pos = ar - torch.cummax(torch.where(new_cluster, ar, 0), dim=0).values
        theta_rank = torch.zeros_like(ar).scatter_(0, order, pos)
        # Pareto rank first, theta-rank to fill the niches evenly
        rank = non_dominated_sort(fit, until=self.pop_size)
        idx = lexsort((pbi, theta_rank, rank))[: self.pop_size]
        return pop[idx], fit[idx]
