"""Frozen dataclass states — the port of ``evox_tpu/core/struct.py``.

Every state object of the port is a plain frozen dataclass of tensors and
host values with a ``.replace(**changes)`` method, as in the JAX package.
Each is a ``torch.utils._pytree`` node, so ``torch.func.vmap`` takes and
returns states (:mod:`evox_tpu_torch.core.members`): the fields that hold
tensors (directly or inside dicts, lists, tuples and states) are its
children, and the host fields (seeds, counters, flags, ``None``) its
context. ``field(storage=...)`` records the mixed-precision
annotation that :mod:`evox_tpu_torch.core.dtype_policy` reads, and
``field(sharding=P(...))`` the mesh layout that
:mod:`evox_tpu_torch.core.distributed` reads. A field held resident on a
mesh is a ``ShardedTensor`` there: :func:`named_leaves` gives it as one
leaf (its logical shape and dtype), and :func:`map_tensors` maps its
blocks where they lie unless told otherwise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, TypeVar

_T = TypeVar("_T")

__all__ = ["field", "static_field", "pytree_dataclass", "PyTreeNode", "replace", "map_tensors",
           "named_leaves"]


def field(*, static: bool = False, storage: Any = None, sharding: Any = None,
          **kwargs: Any) -> dataclasses.Field:
    """A dataclass field. ``static`` is kept as metadata only (it keeps a
    field out of snapshots' fingerprints and digests).

    ``storage``: the mixed-precision annotation. ``True`` marks the field's
    floating-point leaves as storage-eligible: under a workflow
    ``DtypePolicy(storage=bfloat16, compute=float32)`` they are held in
    bfloat16 between generations and cast back to float32 at step entry.
    ``False`` opts a field out explicitly; ``None`` (the default) is
    ineligible. Integer, bool and seed leaves are never cast.

    ``sharding``: the field's layout on a mesh, a
    :class:`~evox_tpu_torch.core.distributed.P` (``P(POP_AXIS)``: rows split
    over the population axis); ``None`` leaves it to the default."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = static
    if storage is not None:
        metadata["storage"] = bool(storage)
    if sharding is not None:
        metadata["sharding"] = sharding
    return dataclasses.field(metadata=metadata, **kwargs)


def static_field(**kwargs: Any) -> dataclasses.Field:
    """Shorthand for ``field(static=True)``."""
    return field(static=True, **kwargs)


def replace(obj: _T, **changes: Any) -> _T:
    """Functional ``dataclasses.replace`` for any state dataclass."""
    return dataclasses.replace(obj, **changes)


def _has_tensor(value: Any) -> bool:
    import torch

    if isinstance(value, torch.Tensor):
        return True
    if _is_state(value):
        return any(_has_tensor(getattr(value, f.name)) for f in dataclasses.fields(value))
    if isinstance(value, dict):
        return any(_has_tensor(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_tensor(v) for v in value)
    return False


def _flatten_state(obj: Any):
    children, names, host = [], [], []
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if _has_tensor(value):
            children.append(value)
            names.append(f.name)
        else:
            host.append((f.name, value))
    return children, (type(obj), tuple(names), tuple(host))


def _unflatten_state(children: Any, context: Any) -> Any:
    cls, names, host = context
    new = object.__new__(cls)
    for name, value in zip(names, children):
        object.__setattr__(new, name, value)
    for name, value in host:
        object.__setattr__(new, name, value)
    return new


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Turn ``cls`` into a frozen dataclass with a ``.replace`` method,
    registered as a ``torch.utils._pytree`` node."""
    import torch.utils._pytree as pytree

    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = replace
    pytree.register_pytree_node(
        cls, _flatten_state, _unflatten_state,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
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


def _is_state(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def map_tensors(fn: Any, tree: Any, resident: str = "blocks") -> Any:
    """``tree`` with ``fn`` applied to every tensor: states walked field by
    field, dicts, lists and tuples walked, anything else unchanged (seeds,
    counters, ``None``).

    ``resident`` says what a resident leaf (``core/distributed.py``'s
    ``ShardedTensor``) takes: ``"blocks"``, ``fn`` on each of its blocks
    where they lie (it stays resident: a cast, a copy); ``"keep"``, nothing
    (a placement on the controller leaves it on its shards); ``"leaf"``,
    ``fn`` on the resident leaf itself (a gather)."""
    import torch

    from .distributed import ShardedTensor

    def walk(node: Any) -> Any:
        if isinstance(node, torch.Tensor):
            return fn(node)
        if isinstance(node, ShardedTensor):
            if resident == "blocks":
                return node.map_blocks(fn)
            return fn(node) if resident == "leaf" else node
        if _is_state(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name)) for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    if resident not in ("blocks", "keep", "leaf"):
        raise ValueError(f"resident must be 'blocks', 'keep' or 'leaf', got {resident!r}")
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _node(cls: type) -> Optional[Tuple[str, ...]]:
    """How ``named_leaves`` walks an instance of ``cls``: a state's
    non-static field names in order, ``DICT`` or ``SEQUENCE`` for a dict,
    list or tuple, ``None`` for a leaf."""
    if dataclasses.is_dataclass(cls):
        return tuple(f.name for f in dataclasses.fields(cls) if not f.metadata.get("static", False))
    if issubclass(cls, dict):
        return DICT
    if issubclass(cls, (list, tuple)):
        return SEQUENCE
    return None


DICT, SEQUENCE = ("<dict>",), ("<sequence>",)


def named_leaves(tree: Any, prefix: str = "", keep_none: bool = False) -> list:
    """``[(path, leaf)]`` of a state in ``jax.tree_util.keystr`` form: a
    field is ``.name``, a list or tuple item ``[i]``, a dict item
    ``['key']`` (keys sorted). Static fields are left out, as the JAX
    package keeps them out of its pytrees, and so is ``None`` unless
    ``keep_none``."""
    out: list = []
    _collect(tree, prefix, keep_none, out)
    return out


def _collect(tree: Any, prefix: str, keep_none: bool, out: list) -> None:
    if tree is None:
        if keep_none:
            out.append((prefix, None))
        return
    node = _node(type(tree))
    if node is None:
        out.append((prefix, tree))
    elif node is DICT:
        for k in sorted(tree):
            _collect(tree[k], f"{prefix}[{k!r}]", keep_none, out)
    elif node is SEQUENCE:
        for i, v in enumerate(tree):
            _collect(v, f"{prefix}[{i}]", keep_none, out)
    else:
        for name in node:
            _collect(getattr(tree, name), f"{prefix}.{name}", keep_none, out)
