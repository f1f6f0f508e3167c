"""Durable journal: a hash-chained write-ahead log — the port of
``evox_tpu/workflows/journal.py``.

:class:`ChainedLog` is an append-only JSON-lines file where every event
is one fsynced record. Records are **hash-chained**: each carries
``prev`` (the SHA-256 of the previous record's canonical serialization)
and ``sha`` (its own), so the log is tamper-evident end to end: a
modified or deleted middle record breaks the chain of everything after
it and raises :class:`JournalIntegrityError`, while a torn tail (the one
partial line a crash mid-append can leave, given per-record fsync) is
skipped with a warning and truncated so later appends keep the file
well-formed. Closed segments (``max_segment_bytes``) and retention
(``retain_segments``, with a ``retention.json`` sidecar) keep one chain
across files.

:class:`RunJournal` is the same machinery under ``journal.jsonl`` with
the run's event-kind whitelist (:data:`EVENT_KINDS`): the serving queue's
transitions, pod lifecycle records, and the integrity records
(``attest``, ``integrity``) that ``core/attest.py``'s
``bisect_divergence`` reads. The serving queue itself waits for ROADMAP
A13. Everything here is host file I/O between dispatches; no tensor is
read except through :func:`jsonable`.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ChainedLog", "RunJournal", "JournalIntegrityError"]

_SCHEMA = "evox_tpu.run_journal/v1"
_GENESIS = "0" * 64

# every queue transition the journal records; append() rejects anything
# else so a typo'd kind cannot silently create an event class the
# recovery replay and the run_report validator do not know about
EVENT_KINDS = (
    "submit",
    "start",
    "admit",
    "chunk_complete",
    "retire",
    "evict",
    "freeze",
    "health",
    "recover",
    # SLA serving: a deadline-driven preemption close-out, and
    # an elastic-autoscale close-out (the tenant grew into the next pop
    # bucket; its continuation is a `submit` with `resume_from` in the
    # TARGET bucket's journal)
    "preempt",
    "autoscale",
    # cross-pod work-stealing (workflows/control_plane.py): a
    # parked continuation (or still-pending spec) released from THIS
    # queue because the gateway re-placed it on another pod — the moved
    # work is already durable in the target pod's journal (same WAL
    # ordering as the elastic-growth handoff), so recovery must NOT
    # requeue the stolen seq here
    "steal",
    # pod membership transitions (core/pod_supervisor.py —
    # process-0-writes, the checkpoint commit discipline): a member
    # joining a pod epoch, a classified pod fault (worker_dead /
    # hung_collective / coordinator_loss + detection latency), a
    # coordinated SIGTERM drain close-out, a re-formation onto the
    # survivor set, and the barrier-snapshot resume that completes it
    "pod_join",
    "pod_failure",
    "pod_drain",
    "pod_reform",
    "pod_resume",
    # compute integrity (core/attest.py): `attest` pins a
    # state digest at a generation (the bisect_divergence replay input);
    # `integrity` records a detected digest violation and the healing
    # action taken (barrier fallback, voted re-dispatch, quarantine) —
    # corruption is never silently retried into acceptance
    "attest",
    "integrity",
)


class JournalIntegrityError(RuntimeError):
    """The journal's hash chain is broken somewhere BEFORE its tail — a
    middle record was edited, replaced, or deleted. Unlike a torn tail
    (the expected crash artifact, skipped with a warning), a broken
    middle means the ledger can no longer be trusted as a whole, so the
    error is loud instead of self-healing."""


def jsonable(obj: Any) -> Any:
    """Coerce numpy scalars, arrays and tensors into plain JSON types so
    journal payloads (hyperparams, health signals) serialize without a
    custom encoder. Non-finite floats become None (the
    ``sanitize_json`` rule — the journal is strict RFC 8259 JSON)."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        return f if np.isfinite(f) else None
    if isinstance(obj, torch.Tensor):
        return jsonable(obj.detach().cpu().tolist())
    if hasattr(obj, "tolist"):  # numpy arrays
        return jsonable(np.asarray(obj).tolist())
    return obj


def _canonical(record: Dict[str, Any]) -> bytes:
    """The byte string the record's ``sha`` commits to: the record
    without its own ``sha`` field, serialized with sorted keys and no
    whitespace — independent of dict insertion order."""
    body = {k: v for k, v in record.items() if k != "sha"}
    return json.dumps(
        body, sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode()


def _fsync_dir(directory: Path) -> None:
    """fsync a directory so a rename/unlink inside it is durable."""
    fd = os.open(str(directory), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ChainedLog:
    """Append-only, fsynced, hash-chained JSON-lines event log — the
    reusable half of :class:`RunJournal` (the metrics stream in
    ``workflows/flightrec.py`` shares the identical adoption,
    torn-tail-repair, and tamper-evidence machinery, so the discipline
    lives once). Subclasses pin three class attributes:

    - ``FILENAME``: the JSON-lines file inside the directory,
    - ``SCHEMA``: the per-record ``schema`` tag,
    - ``KINDS``: the closed event-kind whitelist (``None`` = any kind).

    Args:
        directory: log directory (created if missing). An existing file
            is ADOPTED: the chain is verified, a torn tail is truncated
            with a warning, and appends continue the chain — that is
            the crash-recovery path.
        max_segment_bytes: when set, the ACTIVE file is rotated once it
            reaches this size: it is renamed to ``FILENAME.NNNNNN`` (the
            next closed-segment ordinal) under the append lock, the
            directory entry is fsynced, and the next append re-creates
            the active file. The hash chain carries straight across the
            boundary (``prev`` of the first record in the new segment is
            the sha of the last record in the old one), so adoption and
            :meth:`verify` check ONE chain over all segments. Because a
            segment is only ever closed by renaming a fully-fsynced
            file, a torn tail can exist ONLY in the active file — a torn
            record inside a closed segment is tamper, not crash damage.
        retain_segments: opt-in retention — keep at most this many
            closed segments, dropping the oldest. A durable
            ``retention.json`` sidecar recording the dropped prefix's
            last seq/sha is committed BEFORE any unlink, so adoption can
            verify a chain whose head is not genesis. The segment
            holding the newest record of a :attr:`PIN_KINDS` kind (the
            newest intact barrier) is never dropped, nor is anything
            newer than it. ``None`` (default) = keep everything;
            :class:`RunJournal` refuses retention outright — recovery
            needs every ``submit``.

    Thread safety: ``append`` takes an internal lock, so the caller
    thread and the executor's background lanes may interleave appends;
    each record is written and fsynced atomically under the lock, so
    the chain stays valid in submission order.
    """

    FILENAME = "chain.jsonl"
    SCHEMA = _SCHEMA
    KINDS: Optional[tuple] = None
    #: record kinds whose newest instance pins its segment against
    #: retention (the "never drop the newest intact barrier" rule)
    PIN_KINDS: tuple = ()
    _RETENTION = "retention.json"

    def __init__(
        self,
        directory: str,
        max_segment_bytes: Optional[int] = None,
        retain_segments: Optional[int] = None,
    ):
        if max_segment_bytes is not None and max_segment_bytes < 1:
            raise ValueError(
                f"max_segment_bytes must be >= 1, got {max_segment_bytes}"
            )
        if retain_segments is not None and retain_segments < 1:
            raise ValueError(
                f"retain_segments must be >= 1, got {retain_segments}"
            )
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / self.FILENAME
        self.max_segment_bytes = max_segment_bytes
        self.retain_segments = retain_segments
        self._lock = threading.Lock()
        self.torn_tail_dropped = 0
        self.rotations = 0
        self.segments_dropped = 0
        self._records: List[Dict[str, Any]] = []
        self._last_sha = _GENESIS
        self._next_seq = 0
        self._next_ordinal = 1
        self._active_bytes = 0
        if self.path.exists() or self._segment_paths():
            self._adopt()

    # ------------------------------------------------------------------ read
    def _segment_paths(self) -> List[Path]:
        """Closed segments, oldest -> newest (6-digit ordinal order)."""
        return sorted(self.directory.glob(self.FILENAME + ".[0-9]*"))

    def _read_retention(self) -> Optional[dict]:
        try:
            with open(self.directory / self._RETENTION) as f:
                side = json.load(f)
            return side if isinstance(side, dict) else None
        except (OSError, ValueError):
            return None

    def _adopt(self) -> None:
        """Verify the full chain over closed segments + the active file;
        truncate a torn ACTIVE tail (the only damage a single-writer
        fsync-per-record log can suffer from a crash) and raise on
        anything deeper — including any damage inside a closed segment,
        which by construction cannot be a crash artifact."""
        segs = self._segment_paths()
        retention = self._read_retention()
        records: List[Dict[str, Any]] = []
        last_sha = _GENESIS
        first = True
        for seg in segs:
            recs, last_sha, first = self._adopt_file(
                seg, last_sha, retention, first, allow_torn=False
            )
            records.extend(recs)
        if self.path.exists():
            recs, last_sha, first = self._adopt_file(
                self.path, last_sha, retention, first, allow_torn=True
            )
            records.extend(recs)
        self._records = records
        self._last_sha = last_sha
        self._next_seq = (
            records[-1]["seq"] + 1
            if records
            else (
                int(retention["dropped_through_seq"]) + 1
                if retention
                else 0
            )
        )
        if segs:
            self._next_ordinal = (
                max(int(p.name.rsplit(".", 1)[1]) for p in segs) + 1
            )
        elif retention is not None:
            self._next_ordinal = int(
                retention.get("dropped_through_ordinal", 0)
            ) + 1
        self._active_bytes = (
            self.path.stat().st_size if self.path.exists() else 0
        )

    def _adopt_file(
        self,
        path: Path,
        last_sha: str,
        retention: Optional[dict],
        first: bool,
        allow_torn: bool,
    ) -> tuple:
        """Adopt one file of the chain. ``first`` marks the oldest file
        on disk: its head record may chain from genesis, or — when a
        retention sidecar committed a dropped prefix — from the
        sidecar's recorded sha."""
        raw = path.read_bytes()
        lines = raw.split(b"\n")
        # byte offset where each line starts, for physical truncation
        offsets, pos = [], 0
        for line in lines:
            offsets.append(pos)
            pos += len(line) + 1
        records: List[Dict[str, Any]] = []
        bad_index: Optional[int] = None
        bad_reason = ""
        chain_break = False
        nonempty = [i for i, ln in enumerate(lines) if ln.strip()]
        for i in nonempty:
            line = lines[i]
            try:
                record = json.loads(line)
                if not isinstance(record, dict):
                    raise ValueError("record is not a JSON object")
                sha = hashlib.sha256(_canonical(record)).hexdigest()
                if record.get("sha") != sha:
                    raise ValueError(
                        f"sha {str(record.get('sha'))[:12]}… does not match "
                        f"recomputed {sha[:12]}…"
                    )
                prev = record.get("prev")
                if first:
                    # the head of the on-disk chain: genesis, or the
                    # committed retention cut (older segments dropped)
                    if prev != last_sha and not (
                        retention is not None
                        and prev == retention.get("dropped_through_sha")
                        and record.get("seq")
                        == int(retention["dropped_through_seq"]) + 1
                    ):
                        chain_break = True
                        raise ValueError(
                            f"head prev {str(prev)[:12]}… is neither "
                            "genesis nor the committed retention cut"
                        )
                    first = False
                elif prev != last_sha:
                    # a torn append can never COMPLETE a record (the sha
                    # field closes the line), so a self-consistent record
                    # whose prev doesn't chain means a predecessor was
                    # edited or deleted — tamper, wherever it sits
                    chain_break = True
                    raise ValueError(
                        f"prev {str(prev)[:12]}… does not "
                        f"chain from {last_sha[:12]}…"
                    )
            except ValueError as e:
                bad_index = i
                bad_reason = str(e)
                break
            records.append(record)
            last_sha = record["sha"]
        if bad_index is not None:
            if not allow_torn:
                # a closed segment was rotated only after every record
                # in it was fsynced — ANY invalid line inside one is
                # tamper, never a crash artifact
                raise JournalIntegrityError(
                    f"closed journal segment {path} record {len(records)} "
                    f"is invalid ({bad_reason}) — closed segments cannot "
                    "tear; the chain was tampered with. Restore the "
                    "journal from a copy or start a fresh directory."
                )
            if chain_break or bad_index != nonempty[-1]:
                # valid-looking records FOLLOW the bad one: a torn append
                # cannot produce that (each record is fsynced before the
                # next is written) — the middle of the ledger was changed
                raise JournalIntegrityError(
                    f"journal {path} record {len(records)} is invalid "
                    f"({bad_reason}) but later records exist — the chain "
                    "was tampered with mid-file; refusing to adopt. "
                    "Restore the journal from a copy or start a fresh "
                    "directory."
                )
            warnings.warn(
                f"journal {path}: dropping torn tail record "
                f"{len(records)} ({bad_reason}) — the expected artifact of "
                "a crash mid-append",
                stacklevel=2,
            )
            self.torn_tail_dropped += 1
            with open(path, "r+b") as f:
                f.truncate(offsets[bad_index])
                f.flush()
                os.fsync(f.fileno())
        return records, last_sha, first

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """All adopted+appended records (a copy), optionally filtered."""
        with self._lock:
            recs = list(self._records)
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records():
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out

    @classmethod
    def verify(cls, directory: str) -> int:
        """Re-read a log from disk, raising
        :class:`JournalIntegrityError` on a broken chain; returns the
        number of intact records. (Adoption already verifies — this is
        the standalone audit entry point.)"""
        return len(cls(directory).records())

    # ----------------------------------------------------------------- write
    def append(self, kind: str, **payload: Any) -> Dict[str, Any]:
        """Append one event record and fsync it before returning — the
        WAL guarantee: once ``append`` returns, the transition is
        durable. ``payload`` values are coerced to strict JSON."""
        if self.KINDS is not None and kind not in self.KINDS:
            raise ValueError(
                f"unknown {type(self).__name__} event kind {kind!r}; "
                f"expected one of {self.KINDS}"
            )
        with self._lock:
            record: Dict[str, Any] = {
                "schema": self.SCHEMA,
                "seq": self._next_seq,
                "kind": kind,
                "t": round(time.time(), 6),
                "prev": self._last_sha,
            }
            record.update(jsonable(payload))
            record["sha"] = hashlib.sha256(_canonical(record)).hexdigest()
            line = json.dumps(
                record, sort_keys=True, separators=(",", ":"),
                allow_nan=False,
            )
            with open(self.path, "ab") as f:
                f.write(line.encode() + b"\n")
                f.flush()
                os.fsync(f.fileno())
            self._records.append(record)
            self._last_sha = record["sha"]
            self._next_seq += 1
            self._active_bytes += len(line) + 1
            if (
                self.max_segment_bytes is not None
                and self._active_bytes >= self.max_segment_bytes
            ):
                self._rotate_locked()
            return record

    def _rotate_locked(self) -> None:
        """Close the active file: rename it to the next segment ordinal
        and fsync the directory entry. The rename happens AFTER the last
        record's fsync (append just did it), so a closed segment can
        never carry a torn tail; the in-memory chain head is untouched,
        so the next append continues the chain in a fresh active file."""
        seg = self.directory / f"{self.FILENAME}.{self._next_ordinal:06d}"
        os.rename(self.path, seg)
        _fsync_dir(self.directory)
        self._next_ordinal += 1
        self._active_bytes = 0
        self.rotations += 1
        if self.retain_segments is not None:
            self._apply_retention_locked()

    def _apply_retention_locked(self) -> None:
        """Drop the oldest closed segments past ``retain_segments``,
        never dropping the segment that holds the newest record of a
        :attr:`PIN_KINDS` kind (or anything newer). The cut is committed
        to the ``retention.json`` sidecar — durably, BEFORE any unlink —
        so adoption can verify the shortened chain's head against it."""
        segs = self._segment_paths()
        excess = len(segs) - self.retain_segments
        if excess <= 0:
            return
        droppable = segs[:excess]
        if self.PIN_KINDS:
            pinned = [
                r["seq"]
                for r in self._records
                if r.get("kind") in self.PIN_KINDS
            ]
            if pinned:
                pin_seq = max(pinned)
                kept = []
                for seg in droppable:
                    # the segment's last record bounds its seq range: a
                    # segment whose bound reaches the pinned seq holds
                    # it (or something newer) — stop dropping there
                    tail = seg.read_bytes().strip().split(b"\n")[-1]
                    last = json.loads(tail)
                    if int(last["seq"]) >= pin_seq:
                        break
                    kept.append(seg)
                droppable = kept
        if not droppable:
            return
        cut_path = droppable[-1]
        tail = json.loads(cut_path.read_bytes().strip().split(b"\n")[-1])
        side = {
            "schema": self.SCHEMA,
            "dropped_through_seq": int(tail["seq"]),
            "dropped_through_sha": tail["sha"],
            "dropped_through_ordinal": int(
                cut_path.name.rsplit(".", 1)[1]
            ),
        }
        tmp = self.directory / (self._RETENTION + ".tmp")
        with open(tmp, "wb") as f:
            f.write(json.dumps(side, sort_keys=True).encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.directory / self._RETENTION)
        _fsync_dir(self.directory)
        for seg in droppable:
            seg.unlink()
        _fsync_dir(self.directory)
        cut_seq = int(tail["seq"])
        self._records = [r for r in self._records if r["seq"] > cut_seq]
        self.segments_dropped += len(droppable)

class RunJournal(ChainedLog):
    """The serving queue's durable WAL (module docstring): the
    :class:`ChainedLog` machinery under the ``journal.jsonl`` name with
    the queue-transition kind whitelist — ``append()`` rejects anything
    outside :data:`EVENT_KINDS` so a typo'd kind cannot silently create
    an event class the recovery replay and the run_report validator do
    not know about."""

    FILENAME = "journal.jsonl"
    SCHEMA = _SCHEMA
    KINDS = EVENT_KINDS
    PIN_KINDS = ("chunk_complete",)

    def __init__(
        self,
        directory: str,
        max_segment_bytes: Optional[int] = None,
        retain_segments: Optional[int] = None,
    ):
        if retain_segments is not None:
            # recover() replays EVERY submit — a retained-away prefix
            # would silently lose accepted work, so the queue's WAL may
            # rotate (bounded files) but never forget
            raise ValueError(
                "RunJournal does not support retention: recovery replays "
                "the full submit history; use max_segment_bytes alone"
            )
        super().__init__(directory, max_segment_bytes=max_segment_bytes)

    # ---------------------------------------------------------------- report
    def report(self) -> dict:
        """The ``tenancy.queue.journal`` section of ``run_report()``
        (validated by tools/check_report.py): per-kind event
        counters, the chain head, and whether this journal has ever been
        recovered from."""
        counts = self.counts()
        return {
            "path": str(self.path),
            "records": len(self._records),
            "last_seq": len(self._records) - 1,
            "events": counts,
            "recovered": counts.get("recover", 0) > 0,
            "torn_tail_dropped": self.torn_tail_dropped,
        }
