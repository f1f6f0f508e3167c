"""Host-side reporting helpers — the part of ``evox_tpu/core/instrument.py``
that the port has so far: :func:`sanitize_json`. The instrumented entry
points and ``run_report`` wait for ROADMAP A4."""

from __future__ import annotations

import math
from typing import Any

__all__ = ["sanitize_json"]


def sanitize_json(obj: Any) -> Any:
    """Non-finite floats replaced by ``None``, recursively: the result is
    strict (RFC 8259) JSON, where ``json.dumps`` would write bare
    ``Infinity``/``NaN`` (telemetry holds +inf before any finite
    generation, and inf-padded ring slots)."""
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
