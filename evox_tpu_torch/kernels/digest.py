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

**Resident leaves.** A leaf held as blocks on a mesh (``core/
distributed.py``'s ``ShardedTensor``) is digested where its blocks lie:
each block is one entry of the launch's table, with the flat index of its
first word (``starts``) and the leaf it belongs to (``slots``). Entries of
one slot fold into one leaf digest by the leaf's own reductions (wrapping
sums, min, max, counts; :func:`merge_rows`), so a resident leaf digests to
the words of the gathered leaf, bit for bit.

**Words are int64.** PyTorch's ``uint32`` lacks most arithmetic, so every
word is carried as an int64 in ``[0, 2**32)``: the plain version masks to
32 bits after each step and splits each 32 x 32 multiply into 16-bit
halves, so no signed product overflows; the kernel computes in ``unsigned``
and writes int64 outputs.
"""

from __future__ import annotations

import ctypes
from array import array
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.cost import charge
from . import _build

__all__ = [
    "DIGEST_WORDS",
    "MAX_LEAVES",
    "TABLE_ROW",
    "combine_words",
    "digest_leaves",
    "digest_leaves_plain",
    "digest_plan",
    "digest_work",
    "launch_digest",
    "leaf_digest_plain",
    "merge_rows",
    "plan_segments",
]

DIGEST_WORDS = 6
# csrc/digest.cu's table size, chunk, block and blocks an SM
MAX_LEAVES = 112
CHUNK_WORDS = 1024
THREADS = 256
BLOCKS_PER_SM = 4
# the card's SMs (an H100 SXM): the plan's default; the wrapper asks the card
SM_COUNT = 132

PHI = 0x9E3779B1  # 2**32 / golden ratio — index decorrelation
MIX1 = 0x85EBCA6B  # murmur3 finalizer constants
MIX2 = 0xC2B2AE35
CH2 = 0x5BD1E995  # second-channel tweak (murmur2 constant)
MASK32 = 0xFFFFFFFF
#: the combination's identity: nothing summed, min at its top, max at 0
IDENTITY = (0, 0, MASK32, 0, 0, 0)

# int64 fields of a table row (csrc/digest.cu's evox_state_digest): pointer,
# words, salt, first chunk, width, float kind, first index times PHI, slot
TABLE_ROW = 8

# csrc/digest.cu's float kinds: which leaves count NaN and inf, and how
_FLOAT_KIND = {torch.float16: 1, torch.float32: 2, torch.float64: 3}


def _width(x: torch.Tensor) -> int:
    if x.is_complex():
        raise TypeError(f"state digest: unsupported leaf dtype {x.dtype}")
    return x.element_size()


def n_words(x: torch.Tensor) -> int:
    """Length of a leaf's uint32 word stream."""
    return x.numel() * (2 if _width(x) == 8 else 1)


# the integer operations the digest needs a word, one a machine
# instruction: the index (an add from the previous word's), the salted word
# (one three-way xor), the mixes' shared first step (a shift, an xor), the
# second mix's constant (an xor), two finishes of two multiplies, two
# shifts and two xors, the two sums, and min and max over two words at a
# time (three-way): 1 + 1 + 2 + 1 + 12 + 2 + 1. The NaN and inf tests of
# float leaves are not counted
DIGEST_OPERATIONS_PER_WORD = 20


def digest_work(leaves: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(bytes, operations) of digesting ``leaves``: each leaf read once and
    six words a leaf written; :data:`DIGEST_OPERATIONS_PER_WORD` integer
    operations a word. The bound column of PERF.md's table counts so, at
    the card's integer issue rate."""
    nbytes = sum(x.numel() * x.element_size() for x in leaves) + 8 * DIGEST_WORDS * (len(leaves) + 1)
    return nbytes, DIGEST_OPERATIONS_PER_WORD * sum(n_words(x) for x in leaves)


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


def leaf_digest_plain(x: torch.Tensor, salt: int, start: int = 0) -> torch.Tensor:
    """``(6,)`` int64 words of one tensor leaf, on its device, in plain
    PyTorch; ``start``: the flat index of its first word (a block of a
    resident leaf: its words' share of the leaf's words)."""
    w = _words(x)
    if w.numel() == 0:
        return torch.tensor(empty_leaf_digest(salt), dtype=torch.int64, device=x.device)
    idx = (torch.arange(w.numel(), dtype=torch.int64, device=w.device) + start) & MASK32
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


def merge_rows(rows: torch.Tensor) -> torch.Tensor:
    """The ``(6,)`` words of one leaf from the ``(k, 6)`` words of its
    parts: the leaf's own reductions (wrapping sums of words 0, 1, 4, 5;
    min; max)."""
    return torch.stack([
        rows[:, 0].sum() & MASK32,
        rows[:, 1].sum() & MASK32,
        rows[:, 2].min(),
        rows[:, 3].max(),
        rows[:, 4].sum() & MASK32,
        rows[:, 5].sum() & MASK32,
    ])


def _entry_plan(n: int, starts: Optional[Sequence[int]],
                slots: Optional[Sequence[int]]) -> Tuple[List[int], List[int], int]:
    """``(starts, slots, n_slots)`` of ``n`` table entries: by default each
    entry a leaf of its own from word 0. Slots run 0, 1, ... in order, an
    entry in its predecessor's slot or the next."""
    starts = [0] * n if starts is None else [int(v) for v in starts]
    slots = list(range(n)) if slots is None else [int(v) for v in slots]
    if len(starts) != n or len(slots) != n:
        raise ValueError("digest_leaves needs one start and one slot for each leaf")
    if slots and (slots[0] != 0 or any(b - a not in (0, 1) for a, b in zip(slots, slots[1:]))):
        raise ValueError(f"digest slots must run 0, 1, ... in order, got {slots}")
    if any(v < 0 for v in starts):
        raise ValueError(f"a digest entry's first word index is negative: {starts}")
    return starts, slots, (slots[-1] + 1 if slots else 0)


def digest_leaves_plain(
    leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int] = IDENTITY,
    starts: Optional[Sequence[int]] = None, slots: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(combined (6,), per-slot (S, 6))`` int64 words in plain PyTorch,
    ``carry`` folded into the combination; ``starts`` and ``slots`` as
    :func:`digest_leaves` takes them."""
    if not leaves:
        raise ValueError("digest_leaves needs at least one leaf")
    starts, slots, n_slots = _entry_plan(len(leaves), starts, slots)
    parts = torch.stack([leaf_digest_plain(x, s, st) for x, s, st in zip(leaves, salts, starts)])
    keys = torch.tensor(slots, device=parts.device)
    rows = torch.stack([merge_rows(parts[keys == k]) for k in range(n_slots)])
    return combine_words(rows, carry), rows


# ------------------------------------------------------------------------ kernel
def digest_plan(words: Sequence[int], sms: int = SM_COUNT) -> dict:
    """The kernel's launch for leaves of ``words`` uint32 words each: each
    leaf cut into chunks of :data:`CHUNK_WORDS` words (its last may be
    short), numbered leaf after leaf from ``chunk0[l]``; a grid of whole
    waves, ``BLOCKS_PER_SM * sms`` blocks (fewer when there are fewer
    chunks), block ``b`` taking the chunks ``[b C // G, (b + 1) C // G)``
    (:func:`plan_segments`)."""
    chunk0, c = [], 0
    for w in words:
        chunk0.append(c)
        c += -(-w // CHUNK_WORDS)
    return {"chunk0": chunk0, "chunks": c, "threads": THREADS,
            "grid": (min(BLOCKS_PER_SM * sms, c),), "chunk_words": CHUNK_WORDS}


def plan_segments(plan: dict, words: Sequence[int], block: int) -> List[Tuple[int, int, int]]:
    """``[(leaf, first word, end word)]`` that block ``block`` of ``plan``
    digests, with ``csrc/digest.cu``'s arithmetic."""
    c, g = plan["chunks"], plan["grid"][0]
    lo, hi = block * c // g, (block + 1) * c // g
    out = []
    for leaf, (c0, w) in enumerate(zip(plan["chunk0"], words)):
        chunks = -(-w // CHUNK_WORDS)
        if c0 + chunks <= lo or c0 >= hi:
            continue
        first = (max(lo, c0) - c0) * CHUNK_WORDS
        out.append((leaf, first, min(min(hi - c0, chunks) * CHUNK_WORDS, w)))
    return out


_SIGNATURE = [
    ctypes.c_void_p,  # rows: n_leaves x 8 int64 (host)
    ctypes.c_int,  # n_leaves: the table's entries
    ctypes.c_int,  # n_slots: the leaves they fold into
    ctypes.c_void_p,  # carry: 6 uint32 (host)
    ctypes.c_int,  # chunks
    ctypes.c_int,  # blocks
    ctypes.c_void_p,  # scratch: the stream's MAX_LEAVES x 6 + 1 uint32 accumulators
    ctypes.c_void_p,  # leaf_out: n_slots x 6 int64
    ctypes.c_void_p,  # out: 6 int64
    ctypes.c_void_p,  # carry_dev: 6 int64 or null
    ctypes.c_void_p,  # cudaStream_t
]
_entry: list = []  # the C entry point, resolved once a process
# (device, stream) -> the stream's scratch: MAX_LEAVES rows of six
# accumulators at their identity, then the block counter at 0. Each launch
# leaves it as it found it (csrc/digest.cu), so it is made once a stream
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_IDENTITY_ROW = [0, 0, -1, 0, 0, 0]  # int32 bits of IDENTITY's words


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream_scratch(index: int, stream: int) -> torch.Tensor:
    """The scratch of a stream of card ``index``, made (on that stream, the
    current one) at its first launch."""
    scratch = _scratch.get((index, stream))
    if scratch is None:
        scratch = torch.tensor(_IDENTITY_ROW * MAX_LEAVES + [0], dtype=torch.int32,
                               device=torch.device("cuda", index))
        _scratch[(index, stream)] = scratch
    return scratch


def _table(flat: Sequence[torch.Tensor], salts: Sequence[int],
           starts: Optional[Sequence[int]] = None,
           slots: Optional[Sequence[int]] = None) -> Tuple[array, int, int, int]:
    """The kernel's table of contiguous entries, ``(rows, chunks, words,
    bytes)``: one row ``(pointer, words, salt, first chunk, width, float
    kind, first index times PHI mod 2**32, slot)`` an entry, and the
    entries' chunks, words and bytes (with the outputs', :func:`digest_work`'s
    count)."""
    starts, slots, n_slots = _entry_plan(len(flat), starts, slots)
    rows, chunks, total, nbytes = array("q"), 0, 0, 8 * DIGEST_WORDS * (n_slots + 1)
    for x, salt, start, slot in zip(flat, salts, starts, slots):
        width, numel = _width(x), x.numel()
        words = numel * 2 if width == 8 else numel
        rows.extend((x.data_ptr(), words, salt & MASK32, chunks, width,
                     _FLOAT_KIND.get(x.dtype, 0), (start * PHI) & MASK32, slot))
        chunks += -(-words // CHUNK_WORDS)
        total += words
        nbytes += numel * width
    return rows, chunks, total, nbytes


def _prepare(leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int],
             carry_dev: Optional[torch.Tensor], starts: Optional[Sequence[int]] = None,
             slots: Optional[Sequence[int]] = None):
    """One table's launch, built: ``(launch, card, out, leaf_out, words,
    bytes)``. ``launch()`` launches the kernel on the current stream of the
    card (which must be the current card) and returns the C entry's error
    code. It refuses a stream that is being captured into a CUDA graph: the
    launch folds into the stream's one scratch, which a graph's replays
    would share with the stream's other digests."""
    flat = [x if x.is_contiguous() else x.contiguous() for x in leaves]
    starts, slots, n_slots = _entry_plan(len(flat), starts, slots)
    rows, chunks, total, nbytes = _table(flat, salts, starts, slots)
    index = flat[0].get_device()
    blocks = min(BLOCKS_PER_SM * _sm_count(index), chunks)
    carry_words = array("I", carry)
    # one allocation for the leaves' words and the combination (its last row)
    words_out = flat[0].new_empty((n_slots + 1, DIGEST_WORDS), dtype=torch.int64)
    out = words_out[-1]
    if not _entry:
        _entry.append(_build.function("digest", "evox_state_digest", _SIGNATURE))

    def launch() -> int:
        if torch._C._cuda_isCurrentStreamCapturing():
            raise RuntimeError("a state digest cannot be captured into a CUDA graph: its launch "
                               "folds into its stream's one scratch, which the graph's replays "
                               "would share with the stream's other digests")
        stream = torch._C._cuda_getCurrentRawStream(index)
        return _entry[0](rows.buffer_info()[0], len(flat), n_slots, carry_words.buffer_info()[0],
                         chunks,
                         blocks, _stream_scratch(index, stream).data_ptr(), words_out.data_ptr(),
                         out.data_ptr(), None if carry_dev is None else carry_dev.data_ptr(),
                         stream)

    return launch, index, out, words_out[:-1], total, nbytes


def _launch_group(leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int],
                  carry_dev: Optional[torch.Tensor], starts: Sequence[int],
                  slots: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    launch, index, out, leaf_out, total, nbytes = _prepare(leaves, salts, carry, carry_dev,
                                                           starts, slots)
    if index == torch._C._cuda_getDevice():  # no device context for the current card
        err = launch()
    else:
        with torch.cuda.device(index):
            err = launch()
    if err:
        _build.check_launch("digest", err, "state digest")
    digest_leaves.launches += 1
    charge("state_digest", DIGEST_OPERATIONS_PER_WORD * total, nbytes)
    return out, leaf_out


def _chain(slots: Sequence[int]) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` entry ranges of a chain of launches: at most
    :data:`MAX_LEAVES` entries each, cut between slots."""
    groups, lo = [], 0
    while lo < len(slots):
        hi = min(lo + MAX_LEAVES, len(slots))
        if hi < len(slots):
            while hi > lo and slots[hi] == slots[hi - 1]:
                hi -= 1
            if hi == lo:
                raise ValueError(f"a resident leaf of more than {MAX_LEAVES} blocks: digest it "
                                 "gathered")
        groups.append((lo, hi))
        lo = hi
    return groups


def launch_digest(leaves: Sequence[torch.Tensor], salts: Sequence[int],
                  carry: Sequence[int] = IDENTITY, starts: Optional[Sequence[int]] = None,
                  slots: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`digest_leaves` on the card without its checks: non-empty
    entries, all on one CUDA device (``core/attest.py`` groups them so). A
    state of more than :data:`MAX_LEAVES` entries chains launches through a
    device carry, each launch holding whole slots."""
    starts, slots, _ = _entry_plan(len(leaves), starts, slots)
    if len(leaves) <= MAX_LEAVES:
        return _launch_group(leaves, salts, carry, None, starts, slots)
    out, rows, carry_dev = None, [], None
    for lo, hi in _chain(slots):
        first = slots[lo]
        out, leaf_out = _launch_group(leaves[lo:hi], salts[lo:hi], carry if lo == 0 else IDENTITY,
                                      carry_dev, starts[lo:hi], [k - first for k in slots[lo:hi]])
        carry_dev = out
        rows.append(leaf_out)
    return out, torch.cat(rows)


def digest_leaves(
    leaves: Sequence[torch.Tensor], salts: Sequence[int], carry: Sequence[int] = IDENTITY,
    starts: Optional[Sequence[int]] = None, slots: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The digest words of non-empty tensor leaves, all on one device.

    Args:
        leaves: tensors with at least one element each (an empty leaf's
            words are :func:`empty_leaf_digest`, computed on the host): the
            table's entries.
        salts: each entry's salt (``core/attest.py``: a hash of its path).
        carry: six words folded into the combination (host leaves).
        starts: each entry's first word index in its leaf (default 0).
        slots: the leaf each entry belongs to, ``0, 1, ...`` in order
            (default one each): the blocks of a resident leaf share one.

    Returns:
        ``(combined, per_leaf)``: int64 ``(6,)`` and ``(S, 6)`` (a row a
        slot) on the leaves' device. On CUDA tensors the kernel of
        ``csrc/digest.cu`` runs (``digest_leaves.launches`` counts its
        launches), on CPU tensors :func:`digest_leaves_plain`.
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
    _entry_plan(len(leaves), starts, slots)
    if dev.type == "cpu":
        return digest_leaves_plain(leaves, salts, carry, starts, slots)
    if dev.type == "cuda":
        return launch_digest(list(leaves), list(salts), carry, starts, slots)
    raise ValueError(f"digest_leaves runs on cuda or cpu, not {dev}")


digest_leaves.launches = 0
