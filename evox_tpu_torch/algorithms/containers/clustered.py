"""Clustered decomposition containers — the port of
``evox_tpu/algorithms/containers/clustered.py``: split the decision vector
into ``num_clusters`` contiguous blocks and run one instance of a base
algorithm per block; the evaluated candidate is the concatenation of the
blocks.

The members are a tuple of base states, driven one after another (the
package docstring says why). ``RandomMaskAlgorithm`` changes its mask on a
host integer it already holds, where the JAX package takes a ``lax.cond``
on a device counter, and re-draws the mask every ``change_every``
generations: the JAX package's documented intent (and code), not the
inverted branches of the library it was modelled on.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.struct import PyTreeNode
from ...utils.common import generator, split_seed


def _check_split(dim: int, parts: int, name: str) -> int:
    if parts < 1 or dim % parts != 0:
        raise ValueError(f"dim {dim} must divide evenly into {parts} {name}")
    return dim // parts


class ClusteredAlgorithm(Algorithm):
    """Run ``num_clusters`` copies of ``base_algorithm`` on contiguous
    decision-variable blocks.

    The base algorithm is built for the sub-problem's dimension
    ``dim // num_clusters``; every cluster shares its hyperparameters.
    Every cluster sees the fitness of the whole concatenated batch.
    """

    def __init__(self, base_algorithm: Algorithm, dim: int, num_clusters: int):
        self.sub_dim = _check_split(dim, num_clusters, "clusters")
        self.base = base_algorithm
        self.dim = dim
        self.num_clusters = num_clusters

    def init(self, seed: int) -> Tuple[Any, ...]:
        return tuple(self.base.init(s) for s in split_seed(seed, self.num_clusters))

    def _fan_out(self, call, state) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
        pairs = [call(s) for s in state]
        # (pop, sub_dim) blocks side by side: (pop, clusters * sub_dim)
        return torch.cat([p for p, _ in pairs], dim=1), tuple(s for _, s in pairs)

    def init_ask(self, state):
        return self._fan_out(self.base.init_ask, state)

    def init_tell(self, state, fitness: torch.Tensor):
        return tuple(self.base.init_tell(s, fitness) for s in state)

    def ask(self, state):
        return self._fan_out(self.base.ask, state)

    def tell(self, state, fitness: torch.Tensor):
        return tuple(self.base.tell(s, fitness) for s in state)


class RandomMaskState(PyTreeNode):
    sub_states: Tuple[Any, ...]  # one base state per cluster
    sub_pops: Optional[torch.Tensor]  # (clusters, pop, sub_dim) cached blocks; None until seeded
    active: Tuple[int, ...]  # the unmasked clusters, in the order they were drawn
    count: int  # generations since the mask changed; -1, -2: the cache-seeding phases
    seed: int


class RandomMaskAlgorithm(Algorithm):
    """Clustered container where only a random subset of clusters evolves.

    Each generation the ``num_clusters - num_mask`` active clusters ask and
    tell; masked clusters keep their cached candidate block and frozen
    state. The active set is re-drawn every ``change_every`` generations
    (by :meth:`_draw_active`, the one draw, which the tests replace).
    """

    def __init__(
        self,
        base_algorithm: Algorithm,
        dim: int,
        num_clusters: int,
        num_mask: int = 1,
        change_every: int = 1,
    ):
        self.sub_dim = _check_split(dim, num_clusters, "clusters")
        if not 0 < num_mask < num_clusters:
            raise ValueError(f"num_mask must be in [1, {num_clusters - 1}], got {num_mask}")
        self.base = base_algorithm
        self.dim = dim
        self.num_clusters = num_clusters
        self.num_mask = num_mask
        self.num_active = num_clusters - num_mask
        self.change_every = change_every

    def _draw_active(self, seed: int) -> List[int]:
        """``num_active`` distinct cluster indices (``jax.random.choice``
        without replacement in the JAX package), drawn on the host."""
        perm = torch.randperm(self.num_clusters, generator=generator(seed, torch.device("cpu")))
        return perm[: self.num_active].tolist()

    def init(self, seed: int) -> RandomMaskState:
        s_self, s_mask, *seeds = split_seed(seed, self.num_clusters + 2)
        return RandomMaskState(
            sub_states=tuple(self.base.init(s) for s in seeds),
            sub_pops=None,
            active=tuple(self._draw_active(s_mask)),
            count=-1,  # the cache is not seeded yet
            seed=s_self,
        )

    @staticmethod
    def _concat(sub_pops: torch.Tensor) -> torch.Tensor:
        return torch.cat(tuple(sub_pops), dim=1)

    def init_ask(self, state: RandomMaskState) -> Tuple[torch.Tensor, RandomMaskState]:
        # first generation: the base's own init protocol, every cluster
        pairs = [self.base.init_ask(s) for s in state.sub_states]
        return (torch.cat([p for p, _ in pairs], dim=1),
                state.replace(sub_states=tuple(s for _, s in pairs)))

    def init_tell(self, state: RandomMaskState, fitness: torch.Tensor) -> RandomMaskState:
        return state.replace(sub_states=tuple(self.base.init_tell(s, fitness)
                                              for s in state.sub_states))

    def _maybe_change_mask(self, state: RandomMaskState) -> RandomMaskState:
        if state.count < self.change_every:
            return state
        seed, s_mask = split_seed(state.seed)
        return state.replace(seed=seed, active=tuple(self._draw_active(s_mask)), count=0)

    def ask(self, state: RandomMaskState) -> Tuple[torch.Tensor, RandomMaskState]:
        if state.count < 0:
            # first steady generation: every cluster proposes, seeding the
            # cache that masked clusters contribute from later
            pairs = [self.base.ask(s) for s in state.sub_states]
            state = state.replace(
                sub_states=tuple(s for _, s in pairs),
                sub_pops=torch.stack([p for p, _ in pairs]),
                count=-2,  # tell every cluster once
            )
        else:
            state = self._maybe_change_mask(state)
            subs = list(state.sub_states)
            sub_pops = state.sub_pops.clone()
            for i in state.active:
                sub_pops[i], subs[i] = self.base.ask(subs[i])
            state = state.replace(sub_states=tuple(subs), sub_pops=sub_pops)
        return self._concat(state.sub_pops), state

    def tell(self, state: RandomMaskState, fitness: torch.Tensor) -> RandomMaskState:
        if state.count == -2:  # the cache-seeding generation asked every cluster
            return state.replace(
                sub_states=tuple(self.base.tell(s, fitness) for s in state.sub_states), count=0)
        subs = list(state.sub_states)
        for i in state.active:
            subs[i] = self.base.tell(subs[i], fitness)
        return state.replace(sub_states=tuple(subs), count=state.count + 1)
