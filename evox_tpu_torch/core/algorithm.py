"""Abstract Algorithm: the ask–evaluate–tell contract.

The port of ``evox_tpu/core/algorithm.py``. The algorithm object holds only
hyperparameters (and its device); all mutable data lives in a frozen state
dataclass returned by ``init`` and threaded through ``ask``/``tell``.
Optional ``init_ask``/``init_tell`` overrides serve algorithms whose first
generation differs from the steady state; workflows detect them by method
override, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

AlgorithmState = Any


class Algorithm:
    """Base class for every optimization algorithm.

    Contract::

        state = algo.init(seed)                # build initial state
        pop, state = algo.ask(state)           # propose candidates
        state = algo.tell(state, fitness)      # ingest fitness of `pop`

    ``ask`` returns a ``(pop_size, ...)`` candidate tensor. ``tell`` receives
    fitness of shape ``(pop_size,)`` (single objective) or
    ``(pop_size, n_objectives)``. ``seed`` is a Python integer: the port's
    random streams are ``torch.Generator``s seeded from integers held in
    the state.
    """

    def init(self, seed: int) -> AlgorithmState:
        raise NotImplementedError

    def ask(self, state: AlgorithmState) -> Tuple[Any, AlgorithmState]:
        raise NotImplementedError

    def tell(self, state: AlgorithmState, fitness: torch.Tensor) -> AlgorithmState:
        raise NotImplementedError

    # -- optional first-generation hooks ------------------------------------
    def init_ask(self, state: AlgorithmState) -> Tuple[Any, AlgorithmState]:
        """Candidates for the very first evaluation. Default: ``ask``."""
        return self.ask(state)

    def init_tell(self, state: AlgorithmState, fitness: torch.Tensor) -> AlgorithmState:
        """Ingest the very first fitness batch. Default: ``tell``."""
        return self.tell(state, fitness)

    @property
    def has_init_ask(self) -> bool:
        return type(self).init_ask is not Algorithm.init_ask

    @property
    def has_init_tell(self) -> bool:
        return type(self).init_tell is not Algorithm.init_tell
