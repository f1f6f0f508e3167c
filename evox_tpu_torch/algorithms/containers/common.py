"""Gather and scatter along the leading axis of a stacked state — the port
of ``evox_tpu/algorithms/containers/common.py``.

A stacked state is a state dataclass whose tensor leaves carry an extra
leading member axis: what the JAX package's ``vmap(base.init)(keys)``
returns, and how the port's containers, islands and tenants hold their
members (:mod:`evox_tpu_torch.core.members`). ``take_state`` gathers
members and ``put_state`` scatters them back, on the runtime path (a
container's active members, a tenant's extraction and insertion) as in
``interop`` and the tests. Leaves are tensors or numpy arrays; nested
dataclasses, dicts, lists and tuples are walked; member seeds and other
per-member host values are indexed with the leaves; anything else (a
shared host integer, ``None``) is kept.
"""

from __future__ import annotations

from ...core.members import put_state, take_state

__all__ = ["put_state", "take_state"]
