"""State digest words: one CUDA kernel on the card (D1).

The JAX package has no Pallas kernel here: its device digest
(``evox_tpu/core/attest.py::state_digest``) is plain ``jnp`` that XLA fuses
into one pass over each leaf. In eager PyTorch the same words take ~20
operators a leaf over int64 lanes, so :func:`digest_leaves` launches the
hand-written kernel of ``csrc/digest.cu`` on CUDA tensors: one launch for
every tensor leaf of a state (up to :data:`MAX_LEAVES`; a larger state
chains launches through a device carry). On CPU tensors it runs
:func:`digest_leaves_plain`, the same words in plain PyTorch. A CUDA tensor
goes to the kernel or raises.

Each leaf's six words are ``core/attest.py``'s: the wrapping sums of two
murmur3 mixes of ``w ^ i*PHI ^ salt`` over the leaf's canonical uint32
word stream ``w``, its min and max word, and its NaN and inf counts
(float16, float32 and float64 leaves; bfloat16 counts none). Leaves
combine by wrapping sum (words 0, 4, 5), XOR (word 1), min and max.

**Words are int64.** PyTorch's ``uint32`` lacks most arithmetic, so every
word is carried as an int64 in ``[0, 2**32)``: the plain version masks to
32 bits after each step and splits each 32 x 32 multiply into 16-bit
halves, so no signed product overflows; the kernel computes in ``unsigned``
and writes int64 outputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.cost import charge
from . import _build

__all__ = [
    "DIGEST_WORDS",
    "MAX_LEAVES",
    "combine_words",
    "digest_leaves",
    "digest_leaves_plain",
    "digest_work",
    "leaf_digest_plain",
]

DIGEST_WORDS = 6
# csrc/digest.cu's table size and block span
MAX_LEAVES = 112
WORDS_PER_BLOCK = 16384

PHI = 0x9E3779B1  # 2**32 / golden ratio — index decorrelation
MIX1 = 0x85EBCA6B  # murmur3 finalizer constants
MIX2 = 0xC2B2AE35
CH2 = 0x5BD1E995  # second-channel tweak (murmur2 constant)
MASK32 = 0xFFFFFFFF
#: the combination's identity: nothing summed, min at its top, max at 0
IDENTITY = (0, 0, MASK32, 0, 0, 0)

# csrc/digest.cu's float kinds: which leaves count NaN and inf, and how
_FLOAT_KIND = {torch.float16: 1, torch.float32: 2, torch.float64: 3}


def _width(x: torch.Tensor) -> int:
    if x.is_complex():
        raise TypeError(f"state digest: unsupported leaf dtype {x.dtype}")
    return x.element_size()


def n_words(x: torch.Tensor) -> int:
    """Length of a leaf's uint32 word stream."""
    return x.numel() * (2 if _width(x) == 8 else 1)


def digest_work(leaves: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(bytes, operations) of digesting ``leaves``: each leaf read once and
    six words a leaf written; about 14 integer operations a word (two
    mixes of five steps, the index product, the salts, min and max). The
    bound column of PERF.md's table counts so."""
    nbytes = sum(x.numel() * x.element_size() for x in leaves) + 8 * DIGEST_WORDS * (len(leaves) + 1)
    return nbytes, 14 * sum(n_words(x) for x in leaves)


# ------------------------------------------------------------------ plain version
def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in ``[0, 2**32)``: the constant
    split into 16-bit halves keeps every product under 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mulmod32(h, MIX1)
    h = h ^ (h >> 13)
    h = _mulmod32(h, MIX2)
    return h ^ (h >> 16)


def _words(x: torch.Tensor) -> torch.Tensor:
    """The leaf's canonical word stream as int64 in ``[0, 2**32)``."""
    flat = x.detach().contiguous().reshape(-1)
    width = _width(x)
    if x.dtype == torch.bool or width == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if width == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    return flat.view(torch.int32).to(torch.int64) & MASK32


def empty_leaf_digest(salt: int) -> Tuple[int, ...]:
    """The words of a leaf with no elements (host integers)."""
    h = _mix32(torch.tensor([salt ^ PHI, (salt ^ PHI) ^ CH2], dtype=torch.int64))
    return (int(h[0]), int(h[1]), MASK32, 0, 0, 0)


def leaf_digest_plain(x: torch.Tensor, salt: int) -> torch.Tensor:
    """``(6,)`` int64 words of one tensor leaf, on its device, in plain
    PyTorch."""
    w = _words(x)
    if w.numel() == 0:
        return torch.tensor(empty_leaf_digest(salt), dtype=torch.int64, device=x.device)
    idx = torch.arange(w.numel(), dtype=torch.int64, device=w.device) & MASK32
    base = w ^ _mulmod32(idx, PHI) ^ (salt & MASK32)
    kind = _FLOAT_KIND.get(x.dtype)
    zero = torch.zeros((), dtype=torch.int64, device=w.device)
    nan = torch.isnan(x).sum(dtype=torch.int64) if kind else zero
    inf = torch.isinf(x).sum(dtype=torch.int64) if kind else zero
    return torch.stack([
        _mix32(base).sum() & MASK32,
        _mix32(base ^ CH2).sum() & MASK32,
        w.min(),
        w.max(),
        nan & MASK32,
        inf & MASK32,
    ])


def combine_words(digests: torch.Tensor, carry: Sequence[int] = IDENTITY) -> torch.Tensor:
    """Combine ``(L, 6)`` int64 leaf words with ``carry`` into ``(6,)``:
    wrapping sums, XOR, min and max."""
    c = torch.tensor(list(carry), dtype=torch.int64, device=digests.device)
    d = torch.cat([c[None], digests], dim=0)
    x1 = d[:, 1]
    bits = (x1[:, None] >> torch.arange(32, device=d.device)) & 1
    xor = (bits.sum(0) & 1) << torch.arange(32, device=d.device)
    return torch.stack([
        d[:, 0].sum() & MASK32,
        xor.sum(),
        d[:, 2].min(),
        d[:, 3].max(),
        d[:, 4].sum() & MASK32,
        d[:, 5].sum() & MASK32,
    ])


def digest_leaves_plain(
    leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int] = IDENTITY
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(combined (6,), per-leaf (L, 6))`` int64 words in plain PyTorch,
    ``carry`` folded into the combination."""
    if not leaves:
        raise ValueError("digest_leaves needs at least one leaf")
    rows = torch.stack([leaf_digest_plain(x, s) for x, s in zip(leaves, salts)])
    return combine_words(rows, carry), rows


# ------------------------------------------------------------------------ kernel
_SIGNATURE = [
    ctypes.c_void_p,  # rows: n_leaves x 6 int64 (host)
    ctypes.c_int,  # n_leaves
    ctypes.c_void_p,  # carry: 6 uint32 (host)
    ctypes.c_int,  # n_blocks
    ctypes.c_void_p,  # partial: n_blocks x 6 + 1 uint32 scratch (the last: block counter)
    ctypes.c_void_p,  # leaf_out: n_leaves x 6 int64
    ctypes.c_void_p,  # out: 6 int64
    ctypes.c_void_p,  # carry_dev: 6 int64 or null
    ctypes.c_void_p,  # cudaStream_t
]


def _table(leaves: Sequence[torch.Tensor], salts: Sequence[int]) -> Tuple[np.ndarray, int, list]:
    """The kernel's table of leaves, ``(rows, n_blocks, flat)``: one row
    ``(pointer, words, salt, first block, width, float kind)`` a leaf, the
    blocks of the grid, and the contiguous tensors the pointers name (keep
    them alive until the launch is queued)."""
    flat = [x.detach().contiguous() for x in leaves]
    rows = np.zeros((len(flat), 6), np.int64)
    block0 = 0
    for r, (x, salt) in enumerate(zip(flat, salts)):
        words = n_words(x)
        rows[r] = (x.data_ptr(), words, salt & MASK32, block0, _width(x),
                   _FLOAT_KIND.get(x.dtype, 0))
        block0 += -(-words // WORDS_PER_BLOCK)
    return rows, block0, flat


def _launch_group(leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int],
                  carry_dev: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = leaves[0].device
    rows, n_blocks, flat = _table(leaves, salts)
    carry_np = np.asarray(carry, np.uint32)
    partial = torch.empty((n_blocks * DIGEST_WORDS + 1,), dtype=torch.int32, device=dev)
    leaf_out = torch.empty((len(flat), DIGEST_WORDS), dtype=torch.int64, device=dev)
    out = torch.empty((DIGEST_WORDS,), dtype=torch.int64, device=dev)
    fn = _build.function("digest", "evox_state_digest", _SIGNATURE)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.ctypes.data, len(flat), carry_np.ctypes.data, n_blocks, partial.data_ptr(),
                 leaf_out.data_ptr(), out.data_ptr(),
                 None if carry_dev is None else carry_dev.data_ptr(), stream)
    _build.check_launch("digest", err, "state digest")
    digest_leaves.launches += 1
    nbytes, ops = digest_work(flat)
    charge("state_digest", ops, nbytes)
    return out, leaf_out


def _launch(leaves: Sequence[torch.Tensor], salts: Sequence[int],
            carry: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    out, rows, carry_dev = None, [], None
    for lo in range(0, len(leaves), MAX_LEAVES):
        out, leaf_out = _launch_group(leaves[lo:lo + MAX_LEAVES], salts[lo:lo + MAX_LEAVES],
                                      carry if lo == 0 else IDENTITY, carry_dev)
        carry_dev = out
        rows.append(leaf_out)
    return out, rows[0] if len(rows) == 1 else torch.cat(rows)


def digest_leaves(
    leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int] = IDENTITY
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The digest words of non-empty tensor leaves, all on one device.

    Args:
        leaves: tensors with at least one element each (an empty leaf's
            words are :func:`empty_leaf_digest`, computed on the host).
        salts: each leaf's salt (``core/attest.py``: a hash of its path).
        carry: six words folded into the combination (host leaves).

    Returns:
        ``(combined, per_leaf)``: int64 ``(6,)`` and ``(L, 6)`` on the
        leaves' device. On CUDA tensors the kernel of ``csrc/digest.cu``
        runs (``digest_leaves.launches`` counts its launches), on CPU
        tensors :func:`digest_leaves_plain`.
    """
    if not leaves or len(leaves) != len(salts):
        raise ValueError("digest_leaves needs one salt for each of at least one leaf")
    dev = leaves[0].device
    for x in leaves:
        if x.device != dev:
            raise ValueError(f"digest_leaves: a leaf lies on {x.device}, the first on {dev}")
        if x.numel() == 0:
            raise ValueError("digest_leaves takes non-empty leaves only")
        _width(x)
    if dev.type == "cpu":
        return digest_leaves_plain(leaves, salts, carry)
    if dev.type == "cuda":
        return _launch(list(leaves), list(salts), carry)
    raise ValueError(f"digest_leaves runs on cuda or cpu, not {dev}")


digest_leaves.launches = 0
