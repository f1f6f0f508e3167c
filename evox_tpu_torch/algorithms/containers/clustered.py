"""Clustered decomposition containers — the port of
``evox_tpu/algorithms/containers/clustered.py``: split the decision vector
into ``num_clusters`` contiguous blocks and run one instance of a base
algorithm per block; the evaluated candidate is the concatenation of the
blocks.

The members are stacked base states (a leading cluster axis, the JAX
package's ``vmap(base.init)`` layout), each call one
:func:`~evox_tpu_torch.core.members.member_call` for all clusters (a base
with ``stackable = False`` runs them one by one). ``RandomMaskAlgorithm``
changes its mask on a
host integer it already holds, where the JAX package takes a ``lax.cond``
on a device counter, and re-draws the mask every ``change_every``
generations: the JAX package's documented intent (and code), not the
inverted branches of the library it was modelled on.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.members import member_call, member_route, put_state, stack_states, take_state
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
        self.member_route = member_route(base_algorithm)

    def init(self, seed: int) -> Any:
        return stack_states([self.base.init(s) for s in split_seed(seed, self.num_clusters)])

    def _fan_out(self, call, state) -> Tuple[torch.Tensor, Any]:
        sub_pops, state = member_call(call, state, route=self.member_route)
        # (clusters, pop, sub_dim) blocks side by side: (pop, clusters * sub_dim)
        return _concat(sub_pops), state

    def init_ask(self, state):
        return self._fan_out(self.base.init_ask, state)

    def init_tell(self, state, fitness: torch.Tensor):
        return member_call(self.base.init_tell, state, fitness, in_dims=None,
                           route=self.member_route)

    def ask(self, state):
        return self._fan_out(self.base.ask, state)

    def tell(self, state, fitness: torch.Tensor):
        return member_call(self.base.tell, state, fitness, in_dims=None, route=self.member_route)


def _concat(sub_pops: torch.Tensor) -> torch.Tensor:
    """``(clusters, pop, sub_dim)`` blocks -> ``(pop, clusters * sub_dim)``."""
    return sub_pops.permute(1, 0, 2).reshape(sub_pops.shape[1], -1)


class RandomMaskState(PyTreeNode):
    sub_states: Any  # the base states, stacked on a leading cluster axis
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
        self.member_route = member_route(base_algorithm)

    def _draw_active(self, seed: int) -> List[int]:
        """``num_active`` distinct cluster indices (``jax.random.choice``
        without replacement in the JAX package), drawn on the host."""
        perm = torch.randperm(self.num_clusters, generator=generator(seed, torch.device("cpu")))
        return perm[: self.num_active].tolist()

    def init(self, seed: int) -> RandomMaskState:
        s_self, s_mask, *seeds = split_seed(seed, self.num_clusters + 2)
        return RandomMaskState(
            sub_states=stack_states([self.base.init(s) for s in seeds]),
            sub_pops=None,
            active=tuple(self._draw_active(s_mask)),
            count=-1,  # the cache is not seeded yet
            seed=s_self,
        )

    def _call(self, fn, sub_states, *args, **kwargs):
        return member_call(fn, sub_states, *args, route=self.member_route, **kwargs)

    def init_ask(self, state: RandomMaskState) -> Tuple[torch.Tensor, RandomMaskState]:
        # first generation: the base's own init protocol, every cluster
        sub_pops, subs = self._call(self.base.init_ask, state.sub_states)
        return _concat(sub_pops), state.replace(sub_states=subs)

    def init_tell(self, state: RandomMaskState, fitness: torch.Tensor) -> RandomMaskState:
        return state.replace(sub_states=self._call(self.base.init_tell, state.sub_states,
                                                   fitness, in_dims=None))

    def _maybe_change_mask(self, state: RandomMaskState) -> RandomMaskState:
        if state.count < self.change_every:
            return state
        seed, s_mask = split_seed(state.seed)
        return state.replace(seed=seed, active=tuple(self._draw_active(s_mask)), count=0)

    def ask(self, state: RandomMaskState) -> Tuple[torch.Tensor, RandomMaskState]:
        if state.count < 0:
            # first steady generation: every cluster proposes, seeding the
            # cache that masked clusters contribute from later
            sub_pops, subs = self._call(self.base.ask, state.sub_states)
            state = state.replace(sub_states=subs, sub_pops=sub_pops,
                                  count=-2)  # tell every cluster once
        else:
            state = self._maybe_change_mask(state)
            active = list(state.active)
            # the active clusters, gathered, asked in one call, scattered back
            pops, new = self._call(self.base.ask, take_state(state.sub_states, active))
            index = torch.tensor(active, device=state.sub_pops.device)
            state = state.replace(sub_states=put_state(state.sub_states, active, new),
                                  sub_pops=state.sub_pops.index_copy(0, index, pops))
        return _concat(state.sub_pops), state

    def tell(self, state: RandomMaskState, fitness: torch.Tensor) -> RandomMaskState:
        if state.count == -2:  # the cache-seeding generation asked every cluster
            return state.replace(sub_states=self._call(self.base.tell, state.sub_states, fitness,
                                                       in_dims=None), count=0)
        active = list(state.active)
        new = self._call(self.base.tell, take_state(state.sub_states, active), fitness,
                         in_dims=None)
        return state.replace(sub_states=put_state(state.sub_states, active, new),
                             count=state.count + 1)
