"""Bound sanitization for candidate batches (clip / reflect / wrap) — the
port of ``evox_tpu/operators/sanitize.py``.

The one shared repair point of the DE and PSO families: every consumer
takes the method as a ``bound_handling=`` constructor argument and checks
it with :func:`validate_bound_handling` when it is built.

- ``"clip"``: project onto the box.
- ``"reflect"``: mirror the overshoot back into the box (triangle-wave
  folding, exact for any overshoot size).
- ``"wrap"``: periodic wrap-around by modulo.

The modulo is floor-mod, as ``jnp.remainder``: ``torch.remainder``, never
``torch.fmod``. A span of 0 takes the guarded branch (no division by 0, no
NaN). ``clip`` is ``torch.clamp``: equal in value to ``jnp.clip``, but a
zero clamped onto a zero bound of the other sign keeps its own sign (XLA's
max and min order -0.0 below +0.0). Non-finite elements are not repaired,
as in the JAX package: under ``clip`` they pass through, under ``reflect``/``wrap`` ±inf becomes NaN.
"""

from __future__ import annotations

import torch

__all__ = ["BOUND_METHODS", "sanitize_bounds", "validate_bound_handling"]

BOUND_METHODS = ("clip", "reflect", "wrap")


def validate_bound_handling(method: str) -> str:
    """Raise on an unknown method; returns ``method``."""
    if method not in BOUND_METHODS:
        raise ValueError(
            f"unknown bound_handling {method!r}; choose from {BOUND_METHODS}"
        )
    return method


def sanitize_bounds(
    x: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor, method: str = "clip"
) -> torch.Tensor:
    """Repair ``x`` into the box ``[lb, ub]`` (broadcast over the last
    axis) with the given method."""
    validate_bound_handling(method)
    if method == "clip":
        return torch.clamp(x, lb, ub)
    span = ub - lb
    live = span > 0
    if method == "wrap":
        return lb + torch.where(live, torch.remainder(x - lb, torch.where(live, span, 1.0)), 0.0)
    # reflect: fold onto a 2*span triangle wave, then mirror the upper half
    t = torch.where(live, torch.remainder(x - lb, torch.where(live, 2.0 * span, 1.0)), 0.0)
    return lb + torch.where(t > span, 2.0 * span - t, t)
