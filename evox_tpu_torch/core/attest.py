"""State digests on the host — the port of the host half of
``evox_tpu/core/attest.py``.

A digest is six uint32 words built from exact modular-integer reductions
over each leaf's canonical uint32 word stream, so it is a function of the
state's bits alone::

    [ wrapping-sum(mix(w ^ i·φ ^ salt)),        # order-sensitive, exact
      wrapping-sum(mix(w ^ i·φ ^ salt ^ c2)),   # a second mixed channel
      min(w), max(w),                           # raw word envelope
      nan_count, inf_count ]                    # exact counts, float leaves

``w`` is the leaf's word stream (4-byte dtypes bit-cast, 2-byte ones
zero-extended from uint16, 1-byte ones from uint8, 8-byte ones split into
uint32 pairs), ``i`` the flat index, ``salt`` a hash of the leaf's path in
``jax.tree_util.keystr`` form (``core/struct.py``'s ``named_leaves``).
Leaf digests combine by the same exact reductions (word 1 by XOR). The
words equal the JAX package's ``host_state_digest`` on the same numpy
leaves under the same paths.

A bfloat16 tensor digests as its uint16 bit pattern. numpy has no
bfloat16, and the JAX package's numpy view (ml_dtypes' bfloat16) is not
classed as floating by numpy either, so both packages count no NaN or inf
in a bfloat16 leaf: its words 4 and 5 are 0.

Python integers canonicalize to int32, as ``jnp.asarray`` makes them,
when they fit; the port's seeds (up to 2**62) take int64. A checkpoint's
manifest records :func:`digest_hex` of the snapshot's digest
(``workflows/checkpoint.py``). The device digest, ``StateAttestor`` and
``bisect_divergence`` wait for ROADMAP A12.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .struct import named_leaves

__all__ = [
    "DIGEST_WORDS",
    "IntegrityError",
    "digest_hex",
    "host_leaf_digests",
    "host_state_digest",
]

DIGEST_WORDS = 6

_PHI = 0x9E3779B1  # 2**32 / golden ratio — index decorrelation
_MIX1 = 0x85EBCA6B  # murmur3 finalizer constants
_MIX2 = 0xC2B2AE35
_CH2 = 0x5BD1E995  # second-channel tweak (murmur2 constant)
_MIN_IDENTITY = 0xFFFFFFFF  # empty-leaf min/max identities
_INT32 = np.iinfo(np.int32)


class IntegrityError(RuntimeError):
    """State bits do not match their attestation (a checkpoint whose
    unpickled state digests differently from its manifest)."""

    def __init__(
        self,
        message: str,
        *,
        generation: Optional[int] = None,
        leaves: Sequence[str] = (),
        where: Optional[str] = None,
    ):
        super().__init__(message)
        self.generation = generation
        self.leaves = tuple(leaves)
        self.where = where


def _mix32_np(h: np.ndarray) -> np.ndarray:
    """Murmur3 finalizer over uint32 — bijective, elementwise, exact."""
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_MIX1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_MIX2)
    h ^= h >> np.uint32(16)
    return h


def _salt(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _canon_np(x: Any) -> np.ndarray:
    """A leaf as numpy: tensors copied to the host (bfloat16 as its uint16
    bits), Python scalars at the JAX package's x32 defaults."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    if isinstance(x, int) and not isinstance(x, np.generic):
        return np.asarray(x, np.int32 if _INT32.min <= x <= _INT32.max else np.int64)
    if isinstance(x, float) and not isinstance(x, np.generic):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def _leaf_words_np(x: Any) -> np.ndarray:
    x = np.ascontiguousarray(_canon_np(x))
    dt = x.dtype
    if dt == np.bool_:
        w = x.astype(np.uint32)
    elif dt.itemsize == 1:
        w = x.view(np.uint8).astype(np.uint32)
    elif dt.itemsize == 2:
        w = x.view(np.uint16).astype(np.uint32)
    elif dt.itemsize in (4, 8):
        w = x.view(np.uint32)
    else:
        raise TypeError(f"host_state_digest: unsupported leaf dtype {dt}")
    return w.reshape(-1)


def _float_counts_np(x: np.ndarray):
    if np.issubdtype(x.dtype, np.floating) and x.size:
        return (
            np.sum(np.isnan(x), dtype=np.uint32),
            np.sum(np.isinf(x), dtype=np.uint32),
        )
    return np.uint32(0), np.uint32(0)


def _empty_leaf_digest_np(salt: int) -> np.ndarray:
    h = _mix32_np(np.asarray([salt ^ _PHI, salt ^ _PHI ^ _CH2], np.uint32))
    return np.asarray([h[0], h[1], _MIN_IDENTITY, 0, 0, 0], np.uint32)


def _leaf_digest_np(x: Any, salt: int) -> np.ndarray:
    x = _canon_np(x)
    w = _leaf_words_np(x)
    if w.shape[0] == 0:
        return _empty_leaf_digest_np(salt)
    nan, inf = _float_counts_np(np.asarray(x))
    idx = np.arange(w.shape[0], dtype=np.uint32)
    base = w ^ (idx * np.uint32(_PHI)) ^ np.uint32(salt)
    return np.asarray(
        [
            np.sum(_mix32_np(base), dtype=np.uint32),
            np.sum(_mix32_np(base ^ np.uint32(_CH2)), dtype=np.uint32),
            np.min(w),
            np.max(w),
            nan,
            inf,
        ],
        np.uint32,
    )


_EMPTY_TREE = np.asarray([0, 0, _MIN_IDENTITY, 0, 0, 0], np.uint32)


def _combine_np(digests: List[np.ndarray]) -> np.ndarray:
    d = np.stack(digests).astype(np.uint32)
    return np.asarray(
        [
            np.sum(d[:, 0], dtype=np.uint32),
            np.bitwise_xor.reduce(d[:, 1]),
            np.min(d[:, 2]),
            np.max(d[:, 3]),
            np.sum(d[:, 4], dtype=np.uint32),
            np.sum(d[:, 5], dtype=np.uint32),
        ],
        np.uint32,
    )


def host_state_digest(tree: Any) -> np.ndarray:
    """The ``uint32[6]`` digest of a state (device leaves are copied to the
    host)."""
    named = named_leaves(tree)
    if not named:
        return _EMPTY_TREE.copy()
    return _combine_np([_leaf_digest_np(leaf, _salt(name)) for name, leaf in named])


def host_leaf_digests(tree: Any) -> Dict[str, str]:
    """Per-leaf hex digests keyed by path."""
    return {name: digest_hex(_leaf_digest_np(leaf, _salt(name))) for name, leaf in named_leaves(tree)}


def digest_hex(words: Any) -> str:
    """48-char hex form of a 6-word digest."""
    w = np.asarray(words).astype(np.uint32).reshape(-1)
    if w.shape[0] != DIGEST_WORDS:
        raise ValueError(f"digest must have {DIGEST_WORDS} words, got {w.shape}")
    return "".join(f"{int(v):08x}" for v in w)
