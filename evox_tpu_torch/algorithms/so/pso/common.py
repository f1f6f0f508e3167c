"""What the PSO family shares in the port: the constructor's bounds,
device and ``bound_handling``, uniform draws from one integer seed, and
the bound repair. The JAX package repeats these lines in each module."""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....operators.sanitize import sanitize_bounds, validate_bound_handling
from ....utils.common import float_vector, generator, seeded


class SwarmAlgorithm(Algorithm):
    """Base of the PSO family: ``lb``, ``ub`` (float32 ``(dim,)`` on
    ``device``), ``dim``, ``pop_size`` and ``bound_handling`` (checked
    here). ``device``: ``None`` means ``"cuda"``."""

    def __init__(self, lb: Any, ub: Any, pop_size: int, bound_handling: str,
                 device: DeviceLike):
        self.bound_handling = validate_bound_handling(bound_handling)
        self.device = resolve_device(device)
        self.lb = float_vector(lb, self.device)
        self.ub = float_vector(ub, self.device)
        self.dim = int(self.lb.shape[0])
        self.pop_size = pop_size

    def _generator(self, seed: int) -> torch.Generator:
        return generator(seed, self.device)

    def _uniform(self, seed: int, count: int, shape: Tuple[int, ...] = ()) -> List[torch.Tensor]:
        """``count`` planes of uniforms in [0, 1), each of ``shape``
        (default ``(pop_size, dim)``), from one draw of ``seed``."""
        shape = shape or (self.pop_size, self.dim)
        u = seeded(seed, self.device,
                   lambda g: torch.rand((count,) + shape, generator=g, device=self.device))
        return list(u.unbind(0))

    def _uniform_population(self, seed: int) -> torch.Tensor:
        """``(pop_size, dim)`` uniform in the box."""
        (u,) = self._uniform(seed, 1)
        return u * (self.ub - self.lb) + self.lb

    def _repair(self, x: torch.Tensor) -> torch.Tensor:
        return sanitize_bounds(x, self.lb, self.ub, self.bound_handling)
