"""Shared monitor plumbing — the port of ``evox_tpu/monitors/common.py``:
the ring discipline of ``utils/ring.py``, re-exported for monitor code.

``host0_sharding`` and ``backend_supports_callbacks`` have no counterpart:
the port runs eagerly on one card, so a monitor appends to a host history
directly, with no host callback to place or to refuse.
"""

from ..utils.ring import ring_scatter_indices, ring_slots, ring_write  # noqa: F401

__all__ = ["ring_scatter_indices", "ring_slots", "ring_write"]
