"""Operator attribution — the port of ``evox_tpu/core/attribution.py``.

An :class:`Attribution` is what an algorithm's ``tell`` already knows the
moment it selects survivors: which slot each candidate targets
(``parent_idx``), which variation operator produced it (``op_tag``),
whether it replaced its parent (``success``), and how much fitness it
gained (``improvement``, minimisation, 0 for a candidate that did not
improve). The adaptive DE variants (SaDE, JaDE, CoDE, SHADE) compute this
bookkeeping for their own adaptation; the helpers here are those
expressions, shared. The tag vocabulary is the JAX package's, number for
number, so ledgers of the two packages compare.

Every helper is plain tensor code with no host read.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .struct import PyTreeNode, field

__all__ = [
    "OP_NONE",
    "OP_INIT",
    "OP_SAMPLE",
    "OP_VELOCITY",
    "OP_DE_RAND_1",
    "OP_DE_RAND_2",
    "OP_DE_RAND_TO_BEST_2",
    "OP_DE_CUR_TO_RAND_1",
    "OP_DE_CUR_TO_PBEST_1",
    "OP_DE_BEST",
    "OP_CROSSOVER",
    "OP_MUTATION",
    "N_OPS",
    "OP_NAMES",
    "SADE_STRATEGY_TAGS",
    "CODE_STRATEGY_TAGS",
    "Attribution",
    "de_variant_tag",
    "success_mask",
    "improvement_mass",
    "slot_attribution",
    "strategy_success_counts",
    "lehmer_mean_of_successful",
    "arithmetic_mean_of_successful",
    "op_credit",
    "argsort_inverse",
    "find_attribution",
]

# One flat namespace, append-only (tags are persisted in ledgers).
OP_NONE = 0  # no attribution recorded
OP_INIT = 1  # initial population sampling (generation 0)
OP_SAMPLE = 2  # distribution sampling (ES/CMA-family ask)
OP_VELOCITY = 3  # PSO velocity update
OP_DE_RAND_1 = 4  # DE/rand/1/bin
OP_DE_RAND_2 = 5  # DE/rand/2/bin
OP_DE_RAND_TO_BEST_2 = 6  # DE/rand-to-best/2/bin
OP_DE_CUR_TO_RAND_1 = 7  # DE/current-to-rand/1
OP_DE_CUR_TO_PBEST_1 = 8  # DE/current-to-pbest/1 (JaDE/SHADE)
OP_DE_BEST = 9  # DE/best/n/bin
OP_CROSSOVER = 10  # GA crossover
OP_MUTATION = 11  # GA mutation / unclassified variation
N_OPS = 12

OP_NAMES = (
    "none",
    "init",
    "sample",
    "velocity",
    "de_rand_1",
    "de_rand_2",
    "de_rand_to_best_2",
    "de_cur_to_rand_1",
    "de_cur_to_pbest_1",
    "de_best",
    "crossover",
    "mutation",
)
assert len(OP_NAMES) == N_OPS

# SaDE's strategy axis (its ask's v0..v3) in vocabulary terms
SADE_STRATEGY_TAGS = (OP_DE_RAND_1, OP_DE_RAND_TO_BEST_2, OP_DE_RAND_2, OP_DE_CUR_TO_RAND_1)
# CoDE's trial axis (its ask's t1..t3)
CODE_STRATEGY_TAGS = (OP_DE_RAND_1, OP_DE_RAND_2, OP_DE_CUR_TO_RAND_1)


def de_variant_tag(base_vector: str, n_diff: int) -> int:
    """The vocabulary tag of a plain-DE configuration."""
    if base_vector == "best":
        return OP_DE_BEST
    if n_diff == 1:
        return OP_DE_RAND_1
    if n_diff == 2:
        return OP_DE_RAND_2
    return OP_MUTATION


class Attribution(PyTreeNode):
    """Per-slot attribution of one generation's selection: one row per
    surviving slot (``pop_size``; CoDE folds its three trials a parent
    first). Fitness quantities are in the minimising direction."""

    parent_idx: torch.Tensor  # (pop,) int32
    op_tag: torch.Tensor  # (pop,) int32
    success: torch.Tensor  # (pop,) bool
    improvement: torch.Tensor = field(storage=False)  # (pop,) float32, kept at full width

    @staticmethod
    def empty(pop_size: int, device: torch.device) -> "Attribution":
        return Attribution(
            parent_idx=torch.arange(pop_size, dtype=torch.int32, device=device),
            op_tag=torch.full((pop_size,), OP_INIT, dtype=torch.int32, device=device),
            success=torch.zeros((pop_size,), dtype=torch.bool, device=device),
            improvement=torch.zeros((pop_size,), dtype=torch.float32, device=device),
        )


def success_mask(new_fitness: torch.Tensor, prev_fitness: torch.Tensor) -> torch.Tensor:
    """The greedy selection's success: strict improvement over the
    incumbent (a NaN on either side is no success)."""
    return new_fitness < prev_fitness


def improvement_mass(
    new_fitness: torch.Tensor, prev_fitness: torch.Tensor, success: torch.Tensor
) -> torch.Tensor:
    """The clipped per-slot gain. The first greedy tell improves on an
    ``inf`` incumbent: that is the initialisation's credit, not an
    operator's, so non-finite incumbents give 0."""
    gain = prev_fitness - new_fitness
    return torch.where(success & torch.isfinite(prev_fitness), gain, 0.0).to(torch.float32)


def slot_attribution(
    new_fitness: torch.Tensor,
    prev_fitness: torch.Tensor,
    op_tag: Union[int, torch.Tensor],
    parent_idx: Optional[torch.Tensor] = None,
) -> Attribution:
    """Attribution of a 1:1 slot selection (every DE variant: slot ``i``'s
    trial competes only with parent ``i``). ``op_tag`` is one tag for the
    generation or a ``(pop,)`` tensor of tags."""
    n, dev = new_fitness.shape[0], new_fitness.device
    succ = success_mask(new_fitness, prev_fitness)
    if isinstance(op_tag, torch.Tensor):
        tags = op_tag.to(torch.int32).expand(n)
    else:  # a fill, not a copy from the host (which would wait for the card)
        tags = torch.full((n,), int(op_tag), dtype=torch.int32, device=dev)
    if parent_idx is None:
        parent_idx = torch.arange(n, dtype=torch.int32, device=dev)
    return Attribution(
        parent_idx=parent_idx.to(torch.int32),
        op_tag=tags.clone(),
        success=succ,
        improvement=improvement_mass(new_fitness, prev_fitness, succ),
    )


def strategy_success_counts(
    success: torch.Tensor, strategy: torch.Tensor, n_strategy: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SaDE's per-strategy successes and failures: ``(succ, fail,
    onehot)``, the float32 one-hot of the chosen strategies reused for the
    CR memory. Sums of 0s and 1s: exact in any order."""
    onehot = torch.nn.functional.one_hot(strategy.long(), n_strategy).to(torch.float32)
    succ = (success[:, None] * onehot).sum(dim=0)
    fail = ((~success)[:, None] * onehot).sum(dim=0)
    return succ, fail, onehot


def lehmer_mean_of_successful(values: torch.Tensor, success: torch.Tensor) -> torch.Tensor:
    """JaDE's F adaptation: the Lehmer mean over the successful values."""
    s = torch.where(success, values, 0.0)
    return torch.sum(s**2) / torch.clamp_min(torch.sum(s), 1e-12)


def arithmetic_mean_of_successful(
    values: torch.Tensor, success: torch.Tensor, n_success: torch.Tensor
) -> torch.Tensor:
    """JaDE's CR adaptation: the arithmetic mean over the successful
    values; ``n_success`` is the caller's count."""
    s = torch.where(success, values, 0.0)
    return torch.sum(s) / torch.clamp_min(n_success, 1)


def op_credit(attrib: Attribution, n_ops: int = N_OPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One generation's attribution folded into ledger increments per
    operator tag: ``(attempts, successes, improvement)``."""
    onehot = torch.nn.functional.one_hot(attrib.op_tag.long(), n_ops).to(torch.int32)
    attempts = onehot.sum(dim=0, dtype=torch.int32)
    successes = (attrib.success[:, None].to(torch.int32) * onehot).sum(dim=0, dtype=torch.int32)
    improvement = (attrib.improvement[:, None] * onehot.to(torch.float32)).sum(dim=0)
    return attempts, successes, improvement


def argsort_inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of ``order`` (int32): turns "candidate ``i``
    went to slot ``order[i]``" into the slot-to-origin gather."""
    n = order.shape[0]
    out = torch.zeros((n,), dtype=torch.int32, device=order.device)
    out[order.long()] = torch.arange(n, dtype=torch.int32, device=order.device)
    return out


def find_attribution(algo_state):
    """The ``attrib`` field of an algorithm state, unwrapping ``.inner``
    wrappers; ``None`` when the algorithm publishes none."""
    seen = 0
    while algo_state is not None and seen < 8:
        attrib = getattr(algo_state, "attrib", None)
        if attrib is not None:
            return attrib
        algo_state = getattr(algo_state, "inner", None)
        seen += 1
    return None
