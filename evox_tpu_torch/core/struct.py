"""Frozen dataclass states — the port of ``evox_tpu/core/struct.py``.

Every state object of the port is a plain frozen dataclass of tensors and
host values with a ``.replace(**changes)`` method, as in the JAX package.
There is no pytree registration: PyTorch runs eagerly, so nothing traces
through a state. ``field``/``static_field`` keep only their dataclass
defaults; the JAX package's sharding and storage metadata wait for the
scale-out slice (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

_T = TypeVar("_T")

__all__ = ["field", "static_field", "pytree_dataclass", "PyTreeNode", "replace"]


def field(*, static: bool = False, **kwargs: Any) -> dataclasses.Field:
    """A dataclass field; ``static`` is kept as metadata only."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = static
    return dataclasses.field(metadata=metadata, **kwargs)


def static_field(**kwargs: Any) -> dataclasses.Field:
    """Shorthand for ``field(static=True)``."""
    return field(static=True, **kwargs)


def replace(obj: _T, **changes: Any) -> _T:
    """Functional ``dataclasses.replace`` for any state dataclass."""
    return dataclasses.replace(obj, **changes)


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Turn ``cls`` into a frozen dataclass with a ``.replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = replace
    return cls


class PyTreeNode:
    """Base class: subclasses are automatically frozen state dataclasses.

    Example::

        class OpenESState(PyTreeNode):
            center: torch.Tensor
            seed: int
    """

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        pytree_dataclass(cls)

    def replace(self: _T, **changes: Any) -> _T:  # pragma: no cover
        raise NotImplementedError  # overwritten by pytree_dataclass
