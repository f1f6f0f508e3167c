"""Cooperative co-evolution containers — the port of
``evox_tpu/algorithms/containers/coevolution.py``: the decision vector is
split into ``num_subpops`` blocks, one base-algorithm instance per block;
each block's candidates are spliced into the best-so-far full decision
vector for evaluation, so each member optimizes its block in the context
of the best known values of the others.

- ``VectorizedCoevolution``: every block evolves every generation (the
  evaluated batch is ``num_subpops * ask_size`` rows).
- ``Coevolution``: round robin, one block a generation, chosen by the
  generation counter the state holds on the host (the JAX package gathers
  and scatters by a traced index).

The blocks' base states are stacked (a leading block axis, the JAX
package's ``vmap(base.init)`` layout); ``VectorizedCoevolution`` asks and
tells every block in one :func:`~evox_tpu_torch.core.members.member_call`,
``Coevolution`` gathers its block with ``take_state`` and scatters it back
with ``put_state``.

The best rows are taken with ``index_select`` of the ``argmin``: indexing
by a 0-d CUDA tensor would read it on the host.

``random_subpop=True`` shuffles decision variables across blocks by a
permutation drawn at init (:meth:`_draw_permutation`, the one draw, which
the tests replace); the container works in the permuted layout and
un-permutes candidates just before evaluation.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ...core.algorithm import Algorithm
from ...core.members import member_call, member_route, put_state, stack_states, take_state
from ...core.struct import PyTreeNode
from ...utils.common import generator, split_seed
from .clustered import _check_split


class CoevolutionState(PyTreeNode):
    sub_states: Any  # the base states, stacked on a leading block axis
    best_dec: torch.Tensor  # (dim,) best-so-far full decision vector (permuted layout)
    best_fit: torch.Tensor  # (num_subpops,) best fitness seen per block
    coop_pops: torch.Tensor  # the last evaluated candidates (permuted layout)
    iter_counter: int
    permutation: Optional[torch.Tensor]
    seed: int


class _CoevolutionBase(Algorithm):
    def __init__(
        self,
        base_algorithm: Algorithm,
        dim: int,
        num_subpops: int,
        random_subpop: bool = False,
    ):
        self.sub_dim = _check_split(dim, num_subpops, "subpops")
        self.base = base_algorithm
        self.dim = dim
        self.num_subpops = num_subpops
        self.random_subpop = random_subpop
        self.device = base_algorithm.device
        self.member_route = member_route(base_algorithm)

    def _draw_permutation(self, seed: int) -> torch.Tensor:
        """A permutation of the ``dim`` decision variables."""
        return torch.randperm(self.dim, generator=generator(seed, self.device), device=self.device)

    def init(self, seed: int) -> CoevolutionState:
        s_self, s_perm, *seeds = split_seed(seed, self.num_subpops + 2)
        return CoevolutionState(
            sub_states=stack_states([self.base.init(s) for s in seeds]),
            best_dec=torch.zeros((self.dim,), device=self.device),
            best_fit=torch.full((self.num_subpops,), float("inf"), device=self.device),
            coop_pops=torch.zeros((0, self.dim), device=self.device),
            iter_counter=0,
            permutation=self._draw_permutation(s_perm) if self.random_subpop else None,
            seed=s_self,
        )

    def _unpermute(self, pop: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
        """Permuted (internal) layout -> problem layout, by a gather."""
        if not self.random_subpop:
            return pop
        return pop[:, torch.argsort(perm)]

    def _permute(self, dec: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
        """Problem layout -> permuted (internal) layout."""
        if not self.random_subpop:
            return dec
        return dec[..., perm]

    def _splice(self, best_dec: torch.Tensor, block: torch.Tensor, i: int) -> torch.Tensor:
        """Rows of ``best_dec`` with block ``i`` replaced by ``block``'s rows."""
        rows = best_dec.expand(block.shape[0], self.dim).clone()
        rows[:, i * self.sub_dim:(i + 1) * self.sub_dim] = block
        return rows

    # first generation: every block proposes; row j of the evaluated batch
    # is the concatenation of every block's row j
    def init_ask(self, state: CoevolutionState) -> Tuple[torch.Tensor, CoevolutionState]:
        sub_pops, subs = member_call(self.base.init_ask, state.sub_states, route=self.member_route)
        pop = sub_pops.permute(1, 0, 2).reshape(sub_pops.shape[1], -1)
        return self._unpermute(pop, state.permutation), state.replace(
            sub_states=subs, coop_pops=pop)

    def init_tell(self, state: CoevolutionState, fitness: torch.Tensor) -> CoevolutionState:
        best = torch.argmin(fitness).reshape(1)
        return state.replace(
            sub_states=member_call(self.base.init_tell, state.sub_states, fitness, in_dims=None,
                                   route=self.member_route),
            best_dec=state.coop_pops.index_select(0, best)[0],
            best_fit=fitness.index_select(0, best).expand(self.num_subpops).clone(),
            coop_pops=state.coop_pops.new_zeros((0, self.dim)),
        )


class VectorizedCoevolution(_CoevolutionBase):
    """Every block evolves each generation."""

    def ask(self, state: CoevolutionState) -> Tuple[torch.Tensor, CoevolutionState]:
        sub_pops, subs = member_call(self.base.ask, state.sub_states, route=self.member_route)
        coop = torch.cat([self._splice(state.best_dec, p, i) for i, p in enumerate(sub_pops)])
        return self._unpermute(coop, state.permutation), state.replace(
            sub_states=subs, coop_pops=coop)

    def tell(self, state: CoevolutionState, fitness: torch.Tensor) -> CoevolutionState:
        n = self.num_subpops
        per_sub = fitness.reshape(n, -1)
        ask_size = per_sub.shape[1]
        sub_states = member_call(self.base.tell, state.sub_states, per_sub,
                                 route=self.member_route)
        min_fit = torch.amin(per_sub, dim=1)
        argmin = torch.argmin(per_sub, dim=1)
        arange = torch.arange(n, device=fitness.device)
        # block i of the best row of subpop i (its other blocks equal best_dec)
        rows = state.coop_pops.reshape(n, ask_size, self.dim)[arange, argmin]
        blocks = rows.reshape(n, n, self.sub_dim)[arange, arange]
        improved = min_fit < state.best_fit
        best_blocks = torch.where(improved[:, None], blocks, state.best_dec.reshape(n, -1))
        return state.replace(
            sub_states=sub_states,
            best_dec=best_blocks.reshape(self.dim),
            best_fit=torch.minimum(state.best_fit, min_fit),
            coop_pops=state.coop_pops.new_zeros((0, self.dim)),
            iter_counter=state.iter_counter + 1,
        )


class Coevolution(_CoevolutionBase):
    """Round robin: one block evolves per generation."""

    def ask(self, state: CoevolutionState) -> Tuple[torch.Tensor, CoevolutionState]:
        idx = state.iter_counter % self.num_subpops
        sub_pop, new_sub = self.base.ask(take_state(state.sub_states, idx))
        coop = self._splice(state.best_dec, sub_pop, idx)
        return self._unpermute(coop, state.permutation), state.replace(
            sub_states=put_state(state.sub_states, idx, new_sub), coop_pops=coop)

    def tell(self, state: CoevolutionState, fitness: torch.Tensor) -> CoevolutionState:
        idx = state.iter_counter % self.num_subpops
        subs = put_state(state.sub_states, idx,
                         self.base.tell(take_state(state.sub_states, idx), fitness))
        best = torch.argmin(fitness).reshape(1)
        best_f = fitness.index_select(0, best)[0]
        improved = best_f < state.best_fit[idx]
        best_fit = state.best_fit.clone()
        best_fit[idx] = torch.minimum(best_fit[idx], best_f)
        return state.replace(
            sub_states=subs,
            best_dec=torch.where(improved, state.coop_pops.index_select(0, best)[0], state.best_dec),
            best_fit=best_fit,
            coop_pops=state.coop_pops.new_zeros((0, self.dim)),
            iter_counter=state.iter_counter + 1,
        )
