"""Abstract Problem — the port of ``evox_tpu/core/problem.py``.

``init(seed) -> state`` (``None`` for stateless problems) and
``evaluate(state, pop) -> (fitness, state)``. Fitness is ``(pop,)`` for a
single objective, ``(pop, m)`` for several.

A problem that runs on the host (a numpy simulator, an external service)
sets ``jittable = False``: its ``evaluate`` takes numpy candidates and
gives numpy fitness, and the workflow copies the candidates to the host
and the fitness back (``workflows/common.py``'s ``HostLink``). The name
is the JAX package's, so one duck-typed host problem drives both
packages. ``fit_shape``/``fit_dtype`` declare the fitness it returns.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

ProblemState = Any


class Problem:
    """Base class for every optimization problem."""

    #: False for host problems: numpy in, numpy out.
    jittable: bool = True

    #: dtype of the fitness a host problem returns.
    fit_dtype = "float32"

    def init(self, seed: Optional[int] = None) -> ProblemState:
        return None

    def evaluate(self, state: ProblemState, pop: Any) -> Tuple[torch.Tensor, ProblemState]:
        raise NotImplementedError

    def fit_shape(self, pop_size: int) -> Tuple[int, ...]:
        """Fitness shape for a given population size."""
        return (pop_size,)
