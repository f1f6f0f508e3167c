"""Gather and scatter along the leading axis of a stacked state — the port
of ``evox_tpu/algorithms/containers/common.py``.

A stacked state is a state dataclass whose array leaves carry an extra
leading member axis: what the JAX package's ``vmap(base.init)(keys)``
returns. The port's containers hold tuples of member states instead, so
these helpers serve ``interop`` and the tests, which split the JAX
package's stacked states into members and join members back. Leaves are
tensors or numpy arrays; nested dataclasses, dicts, lists and tuples are
walked; anything else (a host integer, ``None``, a static field) is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["put_state", "take_state"]


def _map(fn: Callable[..., Any], tree: Any, *others: Any) -> Any:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *others)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return tree


def take_state(stacked: Any, idx: Any) -> Any:
    """Member(s) ``idx`` (an int, or an index array) of a stacked state."""
    return _map(lambda x: x[idx], stacked)


def _put(full: Any, new: Any, idx: Any) -> Any:
    if isinstance(full, torch.Tensor):
        out = full.clone()
        out[idx] = torch.as_tensor(new, dtype=full.dtype, device=full.device)
        return out
    out = np.array(full, copy=True)
    out[idx] = new
    return out


def put_state(stacked: Any, idx: Any, sub: Any) -> Any:
    """``stacked`` with member(s) ``idx`` replaced by ``sub``'s leaves."""
    return _map(lambda full, new: _put(full, new, idx), stacked, sub)
