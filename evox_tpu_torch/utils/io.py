"""x32 coercion — the port of ``evox_tpu/utils/io.py``.

Host libraries (numpy loaders, simulators) hand back 64-bit arrays; the
card works in 32 bits. A host problem's fitness passes through
:func:`to_x32_if_needed` before it is copied to the card.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np

from .common import tree_map

_X64_MAP = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def to_x32_if_needed(values: Any) -> Any:
    """Coerce the 64-bit numpy leaves of a tree (dicts, lists, tuples) to
    their 32-bit counterparts: float64 to float32, int64 to int32. Leaves
    without a 64-bit numpy dtype, tensors and Python scalars among them,
    pass through untouched. The JAX package does the same unless
    ``jax_enable_x64`` is on; the port has no such mode."""

    def fix(x):
        dt = getattr(x, "dtype", None)
        if isinstance(dt, np.dtype) and dt in _X64_MAP:
            return np.asarray(x).astype(_X64_MAP[dt])
        return x

    return tree_map(fix, values)


def x32_func_call(func: Callable) -> Callable:
    """Wrap a host function so that its outputs are x32-coerced."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return to_x32_if_needed(func(*args, **kwargs))

    return wrapper
