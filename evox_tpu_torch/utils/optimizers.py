"""Gradient-step optimizers for ES-style algorithms.

The port of ``evox_tpu/utils/optimizers.py``. The JAX package resolves
names to optax transformations and builds ClipUp as one; here ``sgd``,
``adam`` and ``clipup`` are small classes with optax's ``init``/``update``
contract and optax's arithmetic (updates are *added* to the parameters).
Other optax names are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core.struct import PyTreeNode


class SGD:
    """``optax.sgd(learning_rate)``: ``updates = -learning_rate * grads``;
    its state is empty."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, params: torch.Tensor) -> Tuple[()]:
        return ()

    def update(
        self, grads: torch.Tensor, state: Any, params: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Any]:
        return -self.learning_rate * grads, state


class AdamState(PyTreeNode):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    """``optax.adam``: bias-corrected first and second moments, in optax's
    order of operations."""

    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(
            count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params)
        )

    def update(
        self, grads: torch.Tensor, state: AdamState, params: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grads + b1 * state.mu
        nu = (1 - b2) * grads**2 + b2 * state.nu
        count = state.count + 1
        # optax raises the decay to the count in float32, then divides (a
        # 0-d CPU tensor enters a CUDA op as a scalar, with no copy)
        one = torch.ones((), dtype=torch.float32)
        mu_hat = mu / (1 - (one * b1) ** count)
        nu_hat = nu / (1 - (one * b2) ** count)
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return -self.learning_rate * u, AdamState(count=count, mu=mu, nu=nu)


class ClipUpState(PyTreeNode):
    velocity: torch.Tensor


class ClipUp:
    """ClipUp (Toklu et al. 2020), ``evox_tpu/utils/optimizers.py::clipup``:
    the gradient normalised to unit length, a momentum velocity, and the
    velocity's length clipped at ``max_speed``."""

    def __init__(
        self,
        learning_rate: float = 0.15,
        momentum: float = 0.9,
        max_speed: float = 0.3,
        fix_gradient_size: bool = True,
    ):
        self.learning_rate = float(learning_rate)
        self.momentum = momentum
        self.max_speed = max_speed
        self.fix_gradient_size = fix_gradient_size

    def init(self, params: torch.Tensor) -> ClipUpState:
        return ClipUpState(velocity=torch.zeros_like(params))

    def update(
        self, grads: torch.Tensor, state: ClipUpState, params: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, ClipUpState]:
        g = grads
        if self.fix_gradient_size:
            g = g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12)
        v = self.momentum * state.velocity + self.learning_rate * g
        speed = torch.linalg.vector_norm(v)
        v = torch.where(speed > self.max_speed, v * (self.max_speed / speed), v)
        return -v, ClipUpState(velocity=v)


def make_optimizer(optimizer: Any, learning_rate: float = 0.01, **kwargs: Any) -> Any:
    """Resolve ``None`` (sgd), ``"sgd"``, ``"adam"`` or ``"clipup"``, or pass
    through an object with ``init``/``update``. ES algorithms *minimize*,
    and the gradients passed in are descent directions."""
    if optimizer is None:
        return SGD(learning_rate)
    if hasattr(optimizer, "init") and hasattr(optimizer, "update"):
        return optimizer
    if optimizer == "sgd":
        return SGD(learning_rate, **kwargs)
    if optimizer == "adam":
        return Adam(learning_rate, **kwargs)
    if optimizer == "clipup":
        return ClipUp(learning_rate=learning_rate, **kwargs)
    raise NotImplementedError(
        f"optimizer {optimizer!r} is not ported yet (sgd, adam and clipup are; "
        "see ROADMAP A6)"
    )
