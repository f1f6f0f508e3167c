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
(``workflows/checkpoint.py``).

The device half:

- :func:`state_digest` and :func:`leaf_digests` — the same words as
  :func:`host_state_digest`, bit for bit, computed where the tensors lie:
  the tensor leaves of a state go to one launch of the digest kernel
  (``kernels/digest.py``, ``csrc/digest.cu``; its plain version on CPU
  tensors), and the host leaves (seeds, counters, empty tensors) are
  digested on the host and folded into the kernel's combination. Words
  are int64 tensors holding uint32 values.
- :class:`StateAttestor` — a monitor that records ``(generation,
  digest)`` in a device ring at a cadence. The cadence is decided on the
  host's generation counter; the digest is written into the ring with no
  host read, and only :meth:`~StateAttestor.ledger`,
  :meth:`~StateAttestor.attestation` and :meth:`~StateAttestor.verify`
  read. It is also the digest engine of ``GenerationExecutor.run_fused``'s
  ``verify_every`` voted re-dispatch.
- :func:`verify_state_digest` and :func:`bisect_divergence` — check a
  state against an attestation, and name the first divergent generation
  of a run from its journaled attestations.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.ring import ring_slots, ring_write
from .device import DeviceLike, resolve_device
from .monitor import Monitor
from .struct import PyTreeNode, named_leaves

__all__ = [
    "DIGEST_WORDS",
    "AttestState",
    "IntegrityError",
    "StateAttestor",
    "bisect_divergence",
    "digest_hex",
    "host_leaf_digests",
    "host_state_digest",
    "leaf_digests",
    "state_digest",
    "verify_state_digest",
]

DIGEST_WORDS = 6

_PHI = 0x9E3779B1  # 2**32 / golden ratio — index decorrelation
_MIX1 = 0x85EBCA6B  # murmur3 finalizer constants
_MIX2 = 0xC2B2AE35
_CH2 = 0x5BD1E995  # second-channel tweak (murmur2 constant)
_MIN_IDENTITY = 0xFFFFFFFF  # empty-leaf min/max identities
_INT32 = np.iinfo(np.int32)


class IntegrityError(RuntimeError):
    """State bits do not match their attestation: a checkpoint whose
    unpickled state digests differently from its manifest, a verified
    state against its record, or three dispatches of one chunk with no
    2-of-3 majority. Never retried into acceptance."""

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


@functools.lru_cache(maxsize=4096)
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
    host; a resident leaf gathered first)."""
    from .distributed import gather_tree

    named = named_leaves(gather_tree(tree))
    if not named:
        return _EMPTY_TREE.copy()
    return _combine_np([_leaf_digest_np(leaf, _salt(name)) for name, leaf in named])


def host_leaf_digests(tree: Any) -> Dict[str, str]:
    """Per-leaf hex digests keyed by path (a resident leaf gathered
    first)."""
    from .distributed import gather_tree

    return {name: digest_hex(_leaf_digest_np(leaf, _salt(name)))
            for name, leaf in named_leaves(gather_tree(tree))}


def digest_hex(words: Any) -> str:
    """48-char hex form of a 6-word digest."""
    w = np.asarray(words).astype(np.uint32).reshape(-1)
    if w.shape[0] != DIGEST_WORDS:
        raise ValueError(f"digest must have {DIGEST_WORDS} words, got {w.shape}")
    return "".join(f"{int(v):08x}" for v in w)


# -- the device digest ---------------------------------------------------------


_M32 = 0xFFFFFFFF


def _mix32_int(h: int) -> int:
    """The murmur3 finalizer on one Python integer word."""
    h ^= h >> 16
    h = (h * _MIX1) & _M32
    h ^= h >> 13
    h = (h * _MIX2) & _M32
    return h ^ (h >> 16)


def _scalar_digest(leaf: Any, salt: int) -> Optional[Tuple[int, ...]]:
    """The words of a Python ``bool`` or ``int`` leaf in plain integer
    arithmetic (the words ``_leaf_digest_np`` gives, without numpy's
    per-call cost: an attestation digests a state's seeds every time);
    ``None`` for any other leaf."""
    if isinstance(leaf, (bool, np.bool_)):
        return _int_digest(1, int(leaf), salt)
    if isinstance(leaf, int) and not isinstance(leaf, np.generic):
        return _int_digest(0, leaf, salt)
    return None


@functools.lru_cache(maxsize=4096)
def _int_digest(is_bool: int, value: int, salt: int) -> Tuple[int, ...]:
    """``_scalar_digest`` of a bool (``is_bool``) or an int, kept: seeds and
    counters recur from one digest to the next."""
    if is_bool or _INT32.min <= value <= _INT32.max:
        words = [value & _M32]
    else:
        words = [value & _M32, (value >> 32) & _M32]
    s0 = s1 = 0
    for i, w in enumerate(words):
        base = w ^ ((i * _PHI) & _M32) ^ salt
        s0 += _mix32_int(base)
        s1 += _mix32_int(base ^ _CH2)
    return (s0 & _M32, s1 & _M32, min(words), max(words), 0, 0)


def _fold(acc: List[int], d: Any) -> None:
    """Combine one digest's words into ``acc`` in place (the leaves'
    combination: wrapping sums, XOR, min, max)."""
    d = [int(v) for v in d]
    acc[0] = (acc[0] + d[0]) & _M32
    acc[1] ^= d[1]
    acc[2] = min(acc[2], d[2])
    acc[3] = max(acc[3], d[3])
    acc[4] = (acc[4] + d[4]) & _M32
    acc[5] = (acc[5] + d[5]) & _M32


def _combine_host(digests: List[Tuple[int, ...]]) -> List[int]:
    """The combination of host digests (tuples of Python integers), from
    the empty tree's words."""
    x1 = 0
    for d in digests:
        x1 ^= d[1]
    cols = list(zip(*digests)) or [()] * DIGEST_WORDS
    return [sum(cols[0]) & _M32, x1, min(cols[2], default=_MIN_IDENTITY),
            max(cols[3], default=0), sum(cols[4]) & _M32, sum(cols[5]) & _M32]


_CPU = torch.device("cpu")


def _entries(leaf: Any, name: str, salt: int) -> List[Tuple[str, torch.Tensor, int, int]]:
    """The kernel's table entries of one non-empty tensor or resident leaf:
    ``[(name, tensor, salt, first word index)]``: a tensor whole, a
    resident leaf's blocks on this process at their words' offsets."""
    from .distributed import ShardedTensor

    if isinstance(leaf, torch.Tensor):
        return [(name, leaf, salt, 0)]
    row_words = int(np.prod(leaf.shape[1:])) * (2 if leaf.element_size() == 8 else 1)
    first = np.cumsum([0] + list(leaf.rows))
    return [(name, b, salt, int(first[s]) * row_words)
            for s, b in zip(leaf.positions, leaf.blocks) if b.numel() > 0]


def _device_digest(tree: Any, per_leaf: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``(combined, {path: words})`` of ``tree``: non-empty tensor leaves
    through ``kernels/digest.py`` (one launch for the CUDA leaves, the
    plain version for CPU leaves), host leaves and empty tensors on the
    host, folded into the combination, which lands as a ``(6,)`` int64
    tensor on the CUDA leaves' device (else the CPU). With ``per_leaf`` the
    dict holds each leaf's words: a device row for a tensor leaf, host
    integers for the rest.

    A resident leaf (``ShardedTensor``) enters as its blocks, each at its
    words' offset in the leaf, folded into one leaf digest: the gathered
    leaf's words, bit for bit. Blocks on several devices (a mesh of
    distinct cards) are digested a device at a time, one launch each, and
    a leaf's rows merged. On a mesh that spans processes each process
    digests its own blocks and the leaf's partial words cross processes
    (one ``exchange`` for all such leaves) before the leaves combine."""
    from ..kernels import digest as kd
    from .distributed import ShardedTensor, exchange, mesh_spans_processes

    host: List[Tuple[int, ...]] = []
    leaves: Dict[str, Any] = {}
    groups: Dict[torch.device, List[Tuple[str, torch.Tensor, int, int]]] = {}
    partial: List[str] = []  # resident leaves whose other blocks lie in other processes
    for name, leaf in named_leaves(tree):
        salt = _salt(name)
        if isinstance(leaf, ShardedTensor) and mesh_spans_processes(leaf.mesh) \
                and leaf.numel() > 0:
            partial.append(name)
        if isinstance(leaf, (torch.Tensor, ShardedTensor)):
            entries = _entries(leaf, name, salt) if leaf.numel() > 0 else []
            for entry in entries:
                groups.setdefault(entry[1].device, []).append(entry)
            if entries:
                continue
            if leaf.numel() > 0:  # a resident leaf with no block in this process
                continue
            d = kd.empty_leaf_digest(salt)
        else:
            d = _scalar_digest(leaf, salt)
            if d is None:
                d = tuple(_leaf_digest_np(leaf, salt).tolist())
        host.append(d)
        if per_leaf:
            leaves[name] = d
    acc = _combine_host(host)
    if partial or len([d for d in groups if d != _CPU]) > 1:
        return _combine_rows(groups, acc, partial, leaves, per_leaf, exchange)
    cpu = groups.pop(_CPU, None)
    if cpu:
        tensors, salts, starts, slots = _table_of(cpu)
        combined, rows = kd.digest_leaves(tensors, salts, starts=starts, slots=slots)
        _fold(acc, combined.tolist())
        if per_leaf:
            leaves.update(zip(_slot_names(cpu), rows))
    if not groups:
        return torch.tensor(acc, dtype=torch.int64), leaves
    (dev, items), = groups.items()
    tensors, salts, starts, slots = _table_of(items)
    if dev.type == "cuda":  # grouped by device, none empty: the launch needs no other check
        combined, rows = kd.launch_digest(tensors, salts, acc, starts, slots)
    else:
        combined, rows = kd.digest_leaves(tensors, salts, acc, starts, slots)
    if per_leaf:
        leaves.update(zip(_slot_names(items), rows))
    return combined, leaves


def _slot_names(items: List[Tuple[str, torch.Tensor, int, int]]) -> List[str]:
    """The leaf of each slot of a table: its entries' names, in order, each
    once."""
    names: List[str] = []
    for name, _, _, _ in items:
        if not names or names[-1] != name:
            names.append(name)
    return names


def _table_of(items: List[Tuple[str, torch.Tensor, int, int]]) -> tuple:
    """``(tensors, salts, starts, slots)`` of a device's entries: one slot
    a leaf, its blocks' entries sharing it."""
    slots, k = [], -1
    for i, (name, _, _, _) in enumerate(items):
        if i == 0 or name != items[i - 1][0]:
            k += 1
        slots.append(k)
    return ([x for _, x, _, _ in items], [s for _, _, s, _ in items],
            [st for _, _, _, st in items], slots)


def _combine_rows(groups: dict, acc: List[int], partial: List[str], leaves: Dict[str, Any],
                  per_leaf: bool, exchange: Callable[[torch.Tensor], list]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The digest of a state whose tensor words lie on several devices or
    in several processes: each device's leaf rows (one launch, no carry), a
    leaf's rows from several devices merged, the partial leaves' rows
    merged over the processes, every leaf row then combined with the host
    words on the first card's device (else the CPU)."""
    from ..kernels import digest as kd

    parts: Dict[str, List[torch.Tensor]] = {}
    dev = next((d for d in groups if d.type == "cuda"), _CPU)
    for items in groups.values():
        tensors, salts, starts, slots = _table_of(items)
        _, per_slot = kd.digest_leaves(tensors, salts, starts=starts, slots=slots)
        for name, row in zip(_slot_names(items), per_slot):
            parts.setdefault(name, []).append(row.to(dev))
    rows = {name: r[0] if len(r) == 1 else kd.merge_rows(torch.stack(r))
            for name, r in parts.items()}
    if partial:
        identity = torch.tensor(kd.IDENTITY, dtype=torch.int64)
        mine = torch.stack([rows.get(name, identity).to(dev) for name in partial])
        everyone = torch.stack(exchange(mine))  # (processes, leaves, 6)
        for i, name in enumerate(partial):
            rows[name] = kd.merge_rows(everyone[:, i])
    stacked = torch.stack([r.to(dev) for r in rows.values()])
    combined = kd.combine_words(stacked, acc)
    if per_leaf:
        leaves.update(rows)
    return combined, leaves


def state_digest(tree: Any) -> torch.Tensor:
    """The ``(6,)`` int64 digest words of a state, on its device, equal bit
    for bit to :func:`host_state_digest`. On the card the tensor leaves
    take one launch of the digest kernel and nothing is read back."""
    return _device_digest(tree)[0]


def leaf_digests(tree: Any) -> Dict[str, torch.Tensor]:
    """Per-leaf ``(6,)`` int64 digest words keyed by path, on the state's
    device."""
    combined, leaves = _device_digest(tree, per_leaf=True)
    return {name: (d if isinstance(d, torch.Tensor)
                   else torch.tensor([int(v) for v in d], dtype=torch.int64)).to(combined.device)
            for name, d in leaves.items()}


def verify_state_digest(
    state: Any,
    expected: Union[str, Any],
    *,
    generation: Optional[int] = None,
    where: str = "state",
    expected_leaves: Optional[Dict[str, str]] = None,
) -> str:
    """Verify ``state``'s bits against an attestation; raise on mismatch.

    ``expected`` is a hex digest (or 6-word array). With a per-leaf
    attestation map the error names the leaf paths whose digests split.
    Returns the verified hex digest."""
    got = digest_hex(host_state_digest(state))
    want = expected if isinstance(expected, str) else digest_hex(expected)
    if got == want:
        return got
    split: List[str] = []
    if expected_leaves:
        actual = host_leaf_digests(state)
        split = [
            name
            for name in sorted(set(actual) | set(expected_leaves))
            if actual.get(name) != expected_leaves.get(name)
        ]
    at = f" at generation {generation}" if generation is not None else ""
    leaf_note = f" (splitting leaves: {', '.join(split)})" if split else ""
    raise IntegrityError(
        f"integrity violation in {where}{at}: digest {got} != attested "
        f"{want}{leaf_note}",
        generation=generation,
        leaves=split,
        where=where,
    )


def _hex_words(words: Any) -> str:
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    return digest_hex(np.asarray(words).astype(np.uint32))


# -- the attestor monitor ------------------------------------------------------


class AttestState(PyTreeNode):
    """The attestation ring: ``count`` attestations so far (a host
    integer: the cadence is decided on the host), and ``(capacity, 6)``
    int64 digest words and ``(capacity,)`` generations on the device."""

    count: int
    ring_digest: torch.Tensor
    ring_generation: torch.Tensor


class StateAttestor(Monitor):
    """Digest the workflow state at a cadence, on the device.

    Attach as a monitor: every ``every`` generations the ``post_step`` hook
    writes ``(generation, digest)`` into a fixed-capacity ring. The
    cadence is read from the host's generation counter, the digest is one
    launch of the digest kernel, and the ring write is a device copy: no
    host read. The same object is the digest engine of the executor's
    ``verify_every`` rung and of journal attestation.

    It digests the workflow state without its ``monitors`` field: monitor
    states are observations, and include this ring itself, which updates
    after the digest is taken.
    """

    def __init__(self, every: int = 10, capacity: int = 64, device: DeviceLike = None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.every = int(every)
        self.capacity = int(capacity)
        self.device = resolve_device(device)

    # -- digest engine --------------------------------------------------------
    def _selected(self, state: Any) -> Any:
        try:
            return state.replace(monitors=())
        except (AttributeError, TypeError):
            return state

    def digest(self, state: Any) -> torch.Tensor:
        """Device digest words of ``state`` (without its monitors)."""
        return state_digest(self._selected(state))

    def digest_hex(self, state: Any) -> str:
        return _hex_words(self.digest(state))

    def host_digest_hex(self, state: Any) -> str:
        """The host digest (copies the leaves to the host)."""
        return digest_hex(host_state_digest(self._selected(state)))

    def leaf_digest_hex(self, state: Any) -> Dict[str, str]:
        return host_leaf_digests(self._selected(state))

    def attestation(self, state: Any) -> Dict[str, Any]:
        """``{"digest": hex, "leaves": {path: hex}}`` from one digest
        launch and one host read of the ``(L + 1) x 6`` words: never the
        state itself."""
        combined, leaves = _device_digest(self._selected(state), per_leaf=True)
        rows = [name for name, d in leaves.items() if isinstance(d, torch.Tensor)]
        words = torch.stack([combined, *(leaves[name] for name in rows)]).cpu().numpy()
        leaves.update(zip(rows, words[1:]))
        return {
            "digest": _hex_words(words[0]),
            "leaves": {name: _hex_words(d) for name, d in leaves.items()},
        }

    def verify(self, state: Any, attestation: Any, *, generation: Optional[int] = None,
               where: str = "state") -> str:
        """Check ``state`` against a journaled attestation (a hex digest or
        an :meth:`attestation` dict). Returns the matching hex digest, or
        raises :class:`IntegrityError` naming the splitting leaves."""
        want = attestation["digest"] if isinstance(attestation, dict) else attestation
        expected_leaves = attestation.get("leaves") if isinstance(attestation, dict) else None
        return verify_state_digest(self._selected(state), want, generation=generation,
                                   where=where, expected_leaves=expected_leaves)

    # -- monitor surface -------------------------------------------------------
    def hooks(self) -> Sequence[str]:
        return ("post_step",)

    def init(self, seed: Optional[int] = None) -> AttestState:
        return AttestState(
            count=0,
            ring_digest=torch.zeros((self.capacity, DIGEST_WORDS), dtype=torch.int64,
                                    device=self.device),
            ring_generation=torch.full((self.capacity,), -1, dtype=torch.int64,
                                       device=self.device),
        )

    def post_step(self, mstate: AttestState, wf_state: Any) -> AttestState:
        gen = int(wf_state.generation)
        if gen % self.every:
            return mstate
        words = self.digest(wf_state).to(mstate.ring_digest.device)
        return mstate.replace(
            count=mstate.count + 1,
            ring_digest=ring_write(mstate.ring_digest, words, mstate.count),
            ring_generation=ring_write(mstate.ring_generation, gen, mstate.count),
        )

    # -- host readback ---------------------------------------------------------
    def ledger(self, mstate: AttestState) -> List[Dict[str, Any]]:
        """Chronological ``[{generation, digest}]`` over the ring (one host
        read of the ring)."""
        gens = mstate.ring_generation.cpu().numpy()
        digs = mstate.ring_digest.cpu().numpy()
        return [
            {"generation": int(gens[s]), "digest": _hex_words(digs[s])}
            for s in ring_slots(mstate.count, self.capacity)
        ]

    def integrity_report(self, mstate: AttestState) -> Dict[str, Any]:
        """The attestor's part of ``run_report``'s ``integrity`` section."""
        return {
            "enabled": True,
            "every": self.every,
            "capacity": self.capacity,
            "attestations": int(mstate.count),
            "ring": self.ledger(mstate),
        }

    def journal_ring(self, mstate: AttestState, journal: Any) -> int:
        """Append one ``attest`` record per ring entry to a RunJournal."""
        ring = self.ledger(mstate)
        for rec in ring:
            journal.append("attest", generation=rec["generation"], digest=rec["digest"])
        return len(ring)


# -- divergence forensics ------------------------------------------------------


def _journal_records(journal_dir: Any) -> List[Dict[str, Any]]:
    if isinstance(journal_dir, (list, tuple)):
        return list(journal_dir)
    journal = journal_dir
    if not hasattr(journal, "records"):
        from ..workflows.journal import RunJournal  # deferred: workflows imports core

        journal = RunJournal(os.fspath(journal_dir))
    return journal.records()


def _pod_context(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Epoch and pod census from the journal's pod lifecycle records."""
    epoch, census = 0, None
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if "epoch" in rec:
            epoch = max(epoch, int(rec["epoch"]))
        if rec.get("kind") == "census":
            census = rec.get("alive", rec.get("census"))
        elif rec.get("kind") == "pod_join":
            census = rec.get("world", census)
    return {"epoch": epoch, "pod_census": census}


def _load_attestations(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``[{generation, digest}]`` sorted by generation from journal records
    or an explicit ledger (the last record of a generation wins: a
    re-attestation after a heal supersedes)."""
    by_gen: Dict[int, str] = {}
    for rec in records:
        kind = rec.get("kind") if isinstance(rec, dict) else None
        if kind == "attest" or (kind is None and "digest" in rec):
            by_gen[int(rec["generation"])] = str(rec["digest"])
        elif kind == "chunk_complete" and isinstance(rec.get("attest"), dict):
            att = rec["attest"]
            if "digest" in att:
                by_gen[int(rec["generation"])] = str(att["digest"])
    return [{"generation": g, "digest": by_gen[g]} for g in sorted(by_gen)]


def bisect_divergence(
    journal_dir: Any,
    *,
    wf: Any,
    start_state: Any,
    suspect: Optional[Callable[[Any, int], Any]] = None,
    attestor: Optional[StateAttestor] = None,
    report_to: Any = None,
) -> Dict[str, Any]:
    """Name the first generation where a run's bits went wrong.

    ``journal_dir`` holds the suspect run's attestations (``attest``
    records, or ``chunk_complete`` records with an ``attest`` field; an
    explicit ``[{generation, digest}]`` ledger is also taken).
    ``start_state`` is the trusted state at the last attested barrier
    (checked against the journal when attested there); ``wf.run`` replays
    the honest trajectory from it.

    Phase 1 replays through the journaled attestations to the first
    cadence window whose digest splits. Phase 2 needs a reproducible
    suspect leg (``suspect(state, n_steps)`` re-runs the faulty path) and
    advances both legs at halving chunk sizes until the first divergent
    generation is pinned. Without ``suspect`` the report carries the
    window only.

    Returns the report that ``run_report``'s ``integrity.bisection`` and
    the ``integrity.*`` flight-recorder gauges read; ``report_to`` (a
    workflow) also keeps it as ``._integrity_forensics``.
    """
    att = attestor if attestor is not None else StateAttestor(device=_state_device(start_state))
    records = _journal_records(journal_dir)
    ledger = _load_attestations(records)

    cur = int(start_state.generation)
    start_gen = cur
    report: Dict[str, Any] = {
        "enabled": True,
        "barrier_generation": start_gen,
        **_pod_context(records),
        "attestations_checked": 0,
        "chunks_replayed": 0,
        "generations_replayed": 0,
        "first_divergent_generation": None,
        "window": None,
        "leaves": [],
        "reproducible": None,
        "verdict": "clean",
    }
    if report_to is not None:
        report_to._integrity_forensics = report

    at_start = [r for r in ledger if r["generation"] == start_gen]
    if at_start and att.digest_hex(start_state) != at_start[-1]["digest"]:
        raise IntegrityError(
            f"bisect_divergence: start state at generation {start_gen} does "
            f"not match its journaled attestation — no trusted barrier to "
            f"replay from",
            generation=start_gen,
            where="bisect_divergence",
        )

    # phase 1: replay the honest leg through the journaled attestations
    ref_state = start_state
    g_lo, g_hi = start_gen, None
    for rec in ledger:
        gen = rec["generation"]
        if gen <= cur:
            continue
        ref_state = wf.run(ref_state, gen - cur)
        report["chunks_replayed"] += 1
        report["generations_replayed"] += gen - cur
        cur = gen
        report["attestations_checked"] += 1
        if att.digest_hex(ref_state) == rec["digest"]:
            g_lo = gen
        else:
            g_hi = gen
            break
    if g_hi is None:
        return report

    report["window"] = [g_lo + 1, g_hi]
    report["verdict"] = "detected"
    if suspect is None:
        return report

    # phase 2: both legs at halving chunk sizes inside (g_lo, g_hi]
    ref_state = start_state
    if g_lo > start_gen:
        ref_state = wf.run(ref_state, g_lo - start_gen)
        report["generations_replayed"] += g_lo - start_gen
        report["chunks_replayed"] += 1
    sus_state = ref_state
    g, hi = g_lo, g_hi
    first_divergent = None
    while g < hi:
        step = max(1, (hi - g) // 2)
        ref_next = wf.run(ref_state, step)
        sus_next = suspect(sus_state, step)
        report["chunks_replayed"] += 2
        report["generations_replayed"] += 2 * step
        if att.digest_hex(ref_next) == att.digest_hex(sus_next):
            g += step
            ref_state, sus_state = ref_next, sus_next
            if g == hi:
                report["reproducible"] = False  # the suspect leg did not reproduce the fault
                return report
        else:
            hi = g + step
            if step == 1:
                first_divergent = hi
                ref_leaves = host_leaf_digests(att._selected(ref_next))
                sus_leaves = host_leaf_digests(att._selected(sus_next))
                report["leaves"] = [
                    name
                    for name in sorted(set(ref_leaves) | set(sus_leaves))
                    if ref_leaves.get(name) != sus_leaves.get(name)
                ]
                break
    report["reproducible"] = True
    report["first_divergent_generation"] = first_divergent
    return report


def _state_device(state: Any) -> torch.device:
    """The device of a state's first tensor leaf (the CPU without one)."""
    for _, leaf in named_leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")
