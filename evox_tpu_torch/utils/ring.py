"""The fixed-capacity ring discipline, as three primitives — the port of
``evox_tpu/utils/ring.py``.

A ``(K, ...)`` buffer plus a monotone ``count``; the write slot is
``count % K``; host readback is chronological over the last ``min(count,
K)`` writes. Writes are functional, as in the JAX package: they return a
new buffer and leave the old one as it was, so a state that holds it is
never changed in place.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

__all__ = ["ring_write", "ring_scatter_indices", "ring_slots"]

Count = Union[int, torch.Tensor]


def ring_write(buf: torch.Tensor, row: Any, count: Count,
               cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A copy of ``buf`` with ``row`` written at slot ``count % K`` along
    axis 0. ``row`` is one slot's payload, cast to the buffer's dtype;
    ``count`` a Python int or an integer tensor (then no host read). With
    ``cond`` (a bool tensor) the buffer passes through unchanged where it
    is false."""
    slot = count % buf.shape[0]
    if isinstance(slot, torch.Tensor):
        index = slot.reshape(1).to(device=buf.device, dtype=torch.long)
        row = torch.as_tensor(row, device=buf.device).to(buf.dtype)
        out = buf.index_copy(0, index, row.expand(buf.shape[1:]).unsqueeze(0))
    else:
        out = buf.clone()
        out[slot] = row  # a tensor is cast by the copy, a Python number filled
    if cond is not None:
        out = torch.where(cond, out, buf)
    return out


def ring_scatter_indices(count: Count, mask: torch.Tensor,
                         capacity: int) -> Tuple[torch.Tensor, Count]:
    """Indices for a masked multi-row ring append: the ``mask``-selected
    rows land consecutively at the ring head, the others get index
    ``capacity`` (out of range: the caller drops them). Returns ``(idx,
    new_count)``."""
    mask = mask.to(torch.int32)
    offsets = torch.cumsum(mask, 0, dtype=torch.int32) - 1  # position among accepted rows
    idx = torch.where(mask > 0, (count + offsets) % capacity, capacity)
    return idx, count + torch.sum(mask, dtype=torch.int32)


def ring_slots(count: Count, capacity: int) -> list:
    """Host-side chronological slot order: the last ``min(count,
    capacity)`` writes, oldest first."""
    count = int(count)
    n = min(count, capacity)
    return [(i % capacity) for i in range(count - n, count)]
