"""Reference-vector guided (APD) environmental selection — the port of
``evox_tpu/operators/selection/rvea_selection.py``. RVEA and RVEAa use
:func:`ref_vec_guided`, LMOCSO the indices form."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ...utils.common import cos_dist, row_norm

INF = float("inf")


def ref_vec_guided_indices(
    fitness: torch.Tensor,
    vectors: torch.Tensor,
    theta: Union[float, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """APD selection's winners: for each reference vector, the index of the
    row of least angle-penalised distance among the rows assigned to it.
    Returns ``(winner, has)``: ``(n_vectors,)`` int64 indices (0 where
    empty) and the mask of non-empty niches."""
    n, m = fitness.shape
    nv = vectors.shape[0]
    dev = fitness.device
    translated = fitness - torch.amin(fitness, dim=0)
    cos = torch.clamp(cos_dist(translated, vectors), -1.0, 1.0)  # (n, nv)
    assigned = torch.argmax(cos, dim=1)

    # each vector's least angle to another (the gamma normaliser)
    vcos = torch.clamp(cos_dist(vectors, vectors), -1.0, 1.0)
    vcos = vcos - 2.0 * torch.eye(nv, device=dev)
    gamma = torch.clamp_min(torch.arccos(torch.clamp(torch.amax(vcos, dim=1), -1.0, 1.0)), 1e-6)

    ar = torch.arange(n, device=dev)
    angle = torch.arccos(torch.clamp(cos[ar, assigned], -1.0, 1.0))
    norm = row_norm(translated)
    apd = (1.0 + m * theta * angle / gamma[assigned]) * norm

    # segment argmin over the assigned vectors; all-zero rows never win
    val = torch.where(norm > 0, apd, INF)
    best_val = torch.full((nv,), INF, device=dev).scatter_reduce(
        0, assigned, val, reduce="amin", include_self=True)
    is_best = val == best_val[assigned]
    winner = torch.full((nv,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, assigned, torch.where(is_best, ar, n), reduce="amin", include_self=True)
    has = winner < n
    return torch.where(has, winner, 0), has


def ref_vec_guided(
    pop: torch.Tensor,
    fitness: torch.Tensor,
    vectors: torch.Tensor,
    theta: Union[float, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """APD selection: at most one row per reference vector. Returns
    ``(pop_out, fit_out)`` with ``len(vectors)`` rows; an empty niche gives
    a row of zeros with +inf fitness."""
    winner, has = ref_vec_guided_indices(fitness, vectors, theta)
    pop_out = torch.where(has[:, None], pop[winner], 0.0)
    fit_out = torch.where(has[:, None], fitness[winner], INF)
    return pop_out, fit_out
