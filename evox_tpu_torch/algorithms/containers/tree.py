"""TreeAlgorithm — one sub-algorithm per leaf of a parameter tree; the
port of ``evox_tpu/algorithms/containers/tree.py``.

Optimize a parameter tree (a dict, list or tuple of tensors, nested or
not) by running an independent base algorithm on the flattened form of
each leaf and reassembling candidate trees for evaluation. Leaves are taken
in ``jax.tree.leaves`` order (dict keys sorted). ``base_algorithm`` is a
class or factory called once per leaf with that leaf's entries of
``*args``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ...core.algorithm import Algorithm
from ...utils.common import split_seed, tree_flatten, tree_map


def _structure(tree: Any) -> Any:
    return tree_map(lambda _: None, tree)


class TreeAlgorithm(Algorithm):
    """Per-leaf sub-algorithms over a parameter tree.

    Args:
        base_algorithm: factory ``(*leaf_args) -> Algorithm`` (e.g. a class
            like ``PSO``), invoked per leaf of ``initial_params``.
        initial_params: a parameter tree fixing the structure and the leaf
            shapes; candidates returned by ``ask`` match it with a leading
            pop axis.
        *args: trees of ``initial_params``' structure whose leaves are the
            per-leaf constructor arguments (e.g. lb/ub vectors of the
            leaf's flattened dimension).
    """

    def __init__(self, base_algorithm: Callable, initial_params: Any, *args: Any):
        leaves, self._rebuild = tree_flatten(initial_params)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        for a in args:
            if _structure(a) != _structure(initial_params):
                raise ValueError(
                    "every constructor-argument tree must match initial_params' structure")
        arg_leaves = [tree_flatten(a)[0] for a in args]
        self.inner = ([base_algorithm(*per_leaf) for per_leaf in zip(*arg_leaves)] if args
                      else [base_algorithm() for _ in leaves])

    def init(self, seed: int) -> Tuple[Any, ...]:
        return tuple(a.init(s) for a, s in zip(self.inner, split_seed(seed, len(self.inner))))

    def _assemble(self, flat_pops) -> Any:
        """Per-leaf ``(pop, leaf_dim)`` tensors -> a batched parameter tree."""
        return self._rebuild([p.reshape((p.shape[0],) + shape)
                              for p, shape in zip(flat_pops, self.shapes)])

    def _fan_out(self, calls, state) -> Tuple[Any, Tuple[Any, ...]]:
        pairs = [call(s) for call, s in zip(calls, state)]
        return self._assemble([p for p, _ in pairs]), tuple(s for _, s in pairs)

    def init_ask(self, state):
        return self._fan_out([a.init_ask for a in self.inner], state)

    def init_tell(self, state, fitness: torch.Tensor):
        return tuple(a.init_tell(s, fitness) for a, s in zip(self.inner, state))

    def ask(self, state):
        return self._fan_out([a.ask for a in self.inner], state)

    def tell(self, state, fitness: torch.Tensor):
        return tuple(a.tell(s, fitness) for a, s in zip(self.inner, state))
