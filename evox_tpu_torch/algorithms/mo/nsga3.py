"""NSGA-III (Deb & Jain 2014) — the port of ``evox_tpu/algorithms/mo/nsga3.py``.

Reference-point NSGA: normalisation by the ideal point and the hyperplane
through the extreme points (the nadir when it is degenerate), association
of each row with the Das-Dennis reference direction of largest cosine, and
niching that fills the split front from the least crowded references.

Three choices keep it on the card and equal to the JAX package:

- **The sort** stops peeling once the survivors are ranked
  (``non_dominated_sort(fit, until=k)``): the rows it leaves unranked get the
  sentinel n, above the cut rank, so they are neither survivors nor
  candidates, as in the JAX package's full peel.
- **The normalisation** solves the m × m intercept system and takes its
  determinant by Gaussian elimination with partial pivoting in elementwise
  steps (:func:`solve_and_det`), where the JAX package calls ``solve`` and
  ``det`` under a ``lax.cond``: both branches are computed and a
  ``torch.where`` picks one, and cuSOLVER and LAPACK, which could round the
  solve differently, are not involved. With the associations'
  fixed-order products the whole selection has the same bits on the card
  and on the CPU.
- **The niching** is a closed form (:func:`niche`) of the JAX package's
  ``lax.while_loop``, which takes one candidate an iteration (thousands at
  pop 10000). The loop always takes, among the references with candidates
  left, the one of least niche count (then lowest index), and its candidate
  of least distance (NaN first, then lowest index). Reference ``r``'s
  ``t``-th candidate in that order is therefore taken at key ``(rho₀[r] +
  t, r)``, and the loop is a merge of these increasing keys: it takes the
  ``need`` smallest. Two stable sorts and no host read.
  :func:`niche_sequential` is the loop itself, the plain version the tests
  hold the closed form against.

  One case differs: when every candidate left to the chosen reference has
  distance +inf, the loop's ``argmin`` over a row of +inf returns index 0,
  which need not be a candidate, and the loop selects row 0 (ROADMAP C).
  The closed form takes the reference's next candidate instead.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import inner_products, lexsort, row_norm, sqrt_rn
from .common import GAMOAlgorithm, MOState

INT32_MAX = 2**31 - 1


def solve_and_det(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, det)`` for the ``(m, m)`` system ``a x = b``: Gaussian
    elimination with partial pivoting (pivot of largest magnitude, the
    lowest row on ties), one elementwise step at a time, so the card and
    the CPU round alike. A singular ``a`` gives ``det`` 0 and a non-finite
    ``x``; no error is raised and nothing is read on the host."""
    m = a.shape[0]
    dev = a.device
    rows = torch.arange(m, device=dev)
    aug = torch.cat([a, b[:, None]], dim=1)  # (m, m + 1)
    det = torch.ones((), dtype=a.dtype, device=dev)
    for c in range(m):
        p = c + torch.argmax(torch.abs(aug[c:, c]))
        swap = torch.where(rows == c, p, torch.where(rows == p, c, rows))
        aug = aug[swap]
        det = torch.where(p != c, -det, det) * aug[c, c]
        below = aug[c + 1:]
        factor = below[:, c] / aug[c, c]
        aug = torch.cat([aug[: c + 1], below - factor[:, None] * aug[c]])
    x = [None] * m
    for i in range(m - 1, -1, -1):
        acc = aug[i, m]
        for j in range(i + 1, m):
            acc = acc - aug[i, j] * x[j]
        x[i] = acc / aug[i, i]
    return torch.stack(x), det


def normalize(fit: torch.Tensor) -> torch.Tensor:
    """Objectives less the ideal point, over the intercepts of the
    hyperplane through the per-axis extreme points (by achievement
    scalarizing function); over the nadir where the plane is degenerate
    (``|det| <= 1e-10``) or an intercept is not finite and positive."""
    m = fit.shape[1]
    f = fit - torch.amin(fit, dim=0)
    w = torch.eye(m, device=fit.device) + 1e-6
    asf = torch.amax(f[:, None, :] / w[None, :, :], dim=-1)  # (n, m)
    extreme = f[torch.argmin(asf, dim=0)]  # (m, m)
    plane, det = solve_and_det(extreme, torch.ones((m,), device=fit.device))
    nadir = torch.amax(f, dim=0)
    a = torch.where(torch.abs(det) > 1e-10, 1.0 / plane, nadir)
    a = torch.where((a > 1e-10) & torch.isfinite(a), a, nadir)
    return f / torch.clamp_min(a, 1e-10)


def associate(fn: torch.Tensor, refs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(norm, cos, pi)``: each row's norm, its largest cosine with a
    reference direction and that direction's index (the first on ties,
    NaN first)."""
    norm = row_norm(fn)
    cos = inner_products(fn, refs) / torch.clamp_min(norm[:, None], 1e-12)
    best, pi = torch.max(cos, dim=1)
    return norm, best, pi


def _niche_inputs(candidate: torch.Tensor, pi: torch.Tensor, dist: torch.Tensor,
                  nref: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(group, t)``: each candidate's reference (non-candidates: ``nref``)
    and its place among its reference's candidates by distance, NaN first,
    then index."""
    n = pi.shape[0]
    dev = pi.device
    group = torch.where(candidate, pi, nref)
    # dist is >= 0 or NaN: NaN sorts first as -inf
    order = lexsort((torch.where(torch.isnan(dist), -torch.inf, dist), group))
    g_sorted = group[order]
    new_group = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), g_sorted[1:] != g_sorted[:-1]])
    ar = torch.arange(n, device=dev)
    start = torch.cummax(torch.where(new_group, ar, 0), dim=0).values
    t = torch.empty_like(order).scatter_(0, order, ar - start)
    return group, t


def niche(selected: torch.Tensor, candidate: torch.Tensor, pi: torch.Tensor, dist: torch.Tensor,
          rho: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """The closed form of NSGA-III's niching loop: ``selected`` with the
    ``need`` candidates the loop takes added (module docstring).
    ``rho`` ``(nref,)``: the niche counts of the selected rows."""
    n, nref = pi.shape[0], rho.shape[0]
    group, t = _niche_inputs(candidate, pi, dist, nref)
    # non-candidates sort after every candidate
    rho_ext = torch.cat([rho.to(torch.int64), torch.full((1,), 2 * n + nref, device=pi.device)])
    key = rho_ext[group] + t
    order = lexsort((group, key))
    place = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=pi.device))
    return selected | (candidate & (place < need))


def niching_inputs(fit: torch.Tensor, refs: torch.Tensor, k: int) -> Tuple[torch.Tensor, tuple]:
    """``(rank, args)`` for keeping ``k`` rows of ``fit``: the ranks of the
    sort to the cut (``n`` where left unranked), and the arguments of
    :func:`niche` (and of :func:`niche_sequential`): the whole fronts that
    fit, the split front's candidates, each row's reference and distance to
    it, the niche counts of the fronts that fit and the number still
    needed. ``refs``: unit reference directions."""
    rank, last_rank = non_dominated_sort(fit, until=k, return_cut_rank=True)
    selected = rank < last_rank  # whole fronts that fit
    candidate = rank == last_rank  # the split front
    norm, best, pi = associate(normalize(fit), refs)
    dist = norm * sqrt_rn(torch.clamp_min(1.0 - best * best, 0.0))
    nref = refs.shape[0]
    rho = torch.zeros((nref + 1,), dtype=torch.int32, device=fit.device).index_add_(
        0, torch.where(selected, pi, nref), torch.ones_like(pi, dtype=torch.int32))[:nref]
    return rank, (selected, candidate, pi, dist, rho, k - selected.sum())


def niche_sequential(selected: torch.Tensor, candidate: torch.Tensor, pi: torch.Tensor,
                     dist: torch.Tensor, rho: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """The JAX package's niching loop, one pick an iteration: the plain
    version of :func:`niche`, for the tests (it reads ``need`` on the host)."""
    nref = rho.shape[0]
    selected, candidate, rho = selected.clone(), candidate.clone(), rho.clone()
    for _ in range(int(need)):
        has_cand = torch.zeros((nref + 1,), dtype=torch.bool, device=pi.device)
        has_cand[torch.where(candidate, pi, nref)] = True
        j = torch.argmin(torch.where(has_cand[:nref], rho, INT32_MAX))
        i = torch.argmin(torch.where(candidate & (pi == j), dist, torch.inf))
        selected[i] = True
        candidate[i] = False
        rho[j] += 1
    return selected


class NSGA3(GAMOAlgorithm):
    """``pop_size`` is a request: the population is the number of Das-Dennis
    reference points (9870 for 10000 at m = 3)."""

    # not under torch.func.vmap: its niching writes with in-place index_add_
    # into unbatched tensors; stacked members run one by one
    stackable = False

    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, mesh: Any = None,
                 device: Any = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        refs, n = UniformSampling(pop_size, n_objs, device=self.device)()
        self.refs = refs / row_norm(refs)[:, None]
        self.pop_size = n

    def select_mask(self, fit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(selected, rank)``: the ``pop_size`` survivors of ``fit`` as a
        mask, and the ranks of the sort (``n`` where left unranked)."""
        rank, args = niching_inputs(fit, self.refs, self.pop_size)
        return niche(*args), rank

    def select(self, state: MOState, pop: torch.Tensor, fit: torch.Tensor):
        selected, _ = self.select_mask(fit)
        idx = torch.argsort(~selected, stable=True)[: self.pop_size]
        return pop[idx], fit[idx]
