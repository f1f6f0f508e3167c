"""IBEA (Zitzler & Künzli 2004): indicator-based EA with the additive
epsilon indicator and exponential fitness assignment — the port of
``evox_tpu/algorithms/mo/ibea.py``.

The ``(n, n)`` indicator matrix is built with a running maximum over the
objectives (no ``(n, n, m)`` broadcast, m times its size), and turned into
the exponential terms in place, in row blocks. Selection removes the worst row ``n - pop`` times, one after
another; the loop stays on the device: dead rows carry a ``+inf`` score, so
each removal is an ``argmin``, a row gather and a subtraction, three
launches and no host read.

Rounding: the column sums that seed the scores are added in a fixed order
(``halving_sum``) and ``exp`` is rounded once from float64 (``exp_rn``), so
the card and the CPU compute the same scores bit for bit. The JAX package
adds the sums in XLA's order and uses XLA's ``exp``, so the port's scores
differ from its by a few float32 ulps (``tests/test_torch_mo_indicator.py``
states the tolerance); the removal order is the same wherever the scores
at each removal are apart by more than that.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ...core.device import DeviceLike
from ...operators.selection.basic import tournament
from ...utils.common import exp_rn, halving_sum
from .common import DrawnGAMOAlgorithm, MOState

EXPO_BLOCK_ROWS = 2048  # rows of the (n, n) matrix exponentiated at once


def eps_indicator_matrix(fit: torch.Tensor) -> torch.Tensor:
    """``I[i, j]``: the least epsilon by which row ``i`` must shift to
    weakly dominate row ``j``, on objectives normalised to ``[0, 1]``: the
    maximum over objectives of ``f[i] - f[j]``, kept as a running maximum."""
    fmin = torch.amin(fit, dim=0)
    fmax = torch.amax(fit, dim=0)
    f = (fit - fmin) / torch.clamp_min(fmax - fmin, 1e-12)
    out = f[:, None, 0] - f[None, :, 0]
    tmp = torch.empty_like(out)
    for k in range(1, fit.shape[1]):
        torch.sub(f[:, None, k], f[None, :, k], out=tmp)
        torch.maximum(out, tmp, out=out)
    return out


def indicator_terms(fit: torch.Tensor, kappa: float) -> torch.Tensor:
    """The ``(n, n)`` terms ``-exp(-I / (c kappa))``, ``c = max |I|``
    (floored at 1e-12), made in place over the indicator matrix."""
    expo = eps_indicator_matrix(fit)
    ck = torch.clamp_min(torch.amax(torch.abs(expo)), 1e-12) * kappa
    for block in expo.split(EXPO_BLOCK_ROWS):
        block.copy_(exp_rn(-(block / ck)).neg_())
    return expo


def initial_scores(expo: torch.Tensor) -> torch.Tensor:
    """Each column's sum over the other rows: ``sum_j expo[j, i] -
    expo[i, i]``, the sum in ``halving_sum``'s fixed order."""
    return halving_sum(expo, 0) - torch.diagonal(expo)


def ibea_fitness(fit: torch.Tensor, kappa: float) -> torch.Tensor:
    """Exponential indicator fitness (higher is better)."""
    return initial_scores(indicator_terms(fit, kappa))


def worst_removal(expo: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the ``keep`` rows left after removing, ``n - keep`` times,
    the row of least score (the first on ties) and subtracting its row of
    ``expo`` from every score; ascending. Three launches a removal and no
    host read: with the diagonal of ``expo`` set to ``-inf`` for the loop,
    the subtraction of the removed row sends that row's own score to
    ``+inf``, where it stays. A NaN matrix (a NaN or infinite objective,
    which makes every term NaN) removes rows in index order, as the JAX
    package's ``argmin`` over NaN scores does: its NaNs are set to 0 in
    place. The diagonal is put back before returning."""
    n = expo.shape[0]
    expo.nan_to_num_(nan=0.0, posinf=torch.inf, neginf=-torch.inf)
    scores = initial_scores(expo)
    diagonal = expo.diagonal()
    own = diagonal.clone()
    diagonal.fill_(-torch.inf)
    row = torch.empty((1, n), dtype=expo.dtype, device=expo.device)
    worst = torch.empty((1,), dtype=torch.int64, device=expo.device)
    for _ in range(n - keep):
        torch.argmin(scores, dim=0, keepdim=True, out=worst)
        torch.index_select(expo, 0, worst, out=row)
        scores.sub_(row[0])
    diagonal.copy_(own)
    return torch.argsort(torch.isinf(scores).to(torch.int8), stable=True)[:keep]


def worst_removal_stepwise(expo: torch.Tensor, keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's loop step by step (a live mask, ``argmin`` over
    ``where(alive, scores, inf)``, the row subtracted from every score):
    ``(survivors ascending, the removal order)``. The plain version that
    :func:`worst_removal` is held against."""
    n = expo.shape[0]
    alive = torch.ones((n,), dtype=torch.bool, device=expo.device)
    scores = initial_scores(expo)
    order = []
    for _ in range(n - keep):
        worst = torch.argmin(torch.where(alive, scores, torch.inf))
        alive[worst] = False
        scores = scores - expo[worst]
        order.append(worst)
    removed = torch.stack(order) if order else torch.zeros((0,), dtype=torch.int64,
                                                           device=expo.device)
    return torch.argsort((~alive).to(torch.int8), stable=True)[:keep], removed


class IBEA(DrawnGAMOAlgorithm):

    # not under torch.func.vmap: its removal loop writes through out= arguments,
    # which vmap has no rule for; stacked members run one by one
    stackable = False
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, kappa: float = 0.05,
                 mesh: Any = None, device: DeviceLike = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        self.kappa = kappa

    def mate_with(self, state: MOState, draws: dict) -> torch.Tensor:
        score = ibea_fitness(state.fitness, self.kappa)
        return tournament(0, state.population, -score, contestants=draws["contestants"])

    def select(self, state: Optional[MOState], pop: torch.Tensor, fit: torch.Tensor):
        idx = worst_removal(indicator_terms(fit, self.kappa), self.pop_size)
        return pop[idx], fit[idx]
