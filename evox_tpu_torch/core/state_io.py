"""Checkpoint save / load — the port of ``evox_tpu/core/state_io.py``.

``backend="pickle"`` writes the state with every tensor copied to the
host (CPU tensors; a bfloat16 tensor keeps its dtype and its bits).
``load`` returns that host state; ``workflows.checkpoint.restore_layouts``
places it on a workflow's device. The JAX package's ``backend="orbax"``
names a JAX library and raises ``ValueError`` here. Pickle saves are
synchronous, so :func:`wait_for_saves` has nothing to wait for.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from .distributed import ShardedTensor
from .struct import map_tensors

__all__ = ["host_copy", "host_copy_async", "load", "save", "wait_for_saves"]


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise ValueError(
            "backend='orbax' names a JAX library; the port saves with backend='pickle'"
        )
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend: {backend!r}")


def host_copy_async(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """``(host tree, event)``: every tensor of ``tree`` copied to the host
    (pinned memory) without blocking the caller, and the CUDA event
    recorded after the copies (``None`` when no tensor lies on a card). A
    thread that reads the host tree waits on the event first. A resident
    leaf (``ShardedTensor``) is gathered first, explicitly (on a mesh that
    spans processes, a collective every process makes): a snapshot holds
    whole leaves, and resumes on any mesh or none."""
    on_card = []

    def copy(t: Any) -> torch.Tensor:
        if isinstance(t, ShardedTensor):
            t = t.gather()
        if t.is_cuda:
            on_card.append(t.device)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t.detach(), non_blocking=True)
        return t.detach().clone()

    host = map_tensors(copy, tree, resident="leaf")
    if not on_card:
        return host, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(on_card[0]))
    return host, event


def host_copy(state: Any) -> Any:
    """``state`` with every tensor copied to the host (returns once the
    copies have landed)."""
    host, ready = host_copy_async(state)
    if ready is not None:
        ready.synchronize()
    return host


def wait_for_saves() -> None:
    """Every save of this module has committed when it returns."""


def save(state: Any, path: str, backend: str = "pickle") -> None:
    """Pickle the host copy of ``state`` to ``path`` (synchronous; an
    existing file is replaced). The JAX package's ``wait`` and
    ``overwrite`` belong to orbax and are not taken."""
    _check_backend(backend)
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(host_copy(state), f, protocol=pickle.HIGHEST_PROTOCOL)


def load(path: str, backend: str = "pickle") -> Any:
    """The host state pickled at ``path``. Unpickle only files this program
    wrote."""
    _check_backend(backend)
    with open(Path(path).resolve(), "rb") as f:
        return pickle.load(f)
