"""Abstract Problem — the port of ``evox_tpu/core/problem.py``.

``init(seed) -> state`` (``None`` for stateless problems) and
``evaluate(state, pop) -> (fitness, state)``. Fitness is ``(pop,)`` for a
single objective, ``(pop, m)`` for several.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

ProblemState = Any


class Problem:
    """Base class for every optimization problem."""

    def init(self, seed: Optional[int] = None) -> ProblemState:
        return None

    def evaluate(self, state: ProblemState, pop: Any) -> Tuple[torch.Tensor, ProblemState]:
        raise NotImplementedError
