"""Flight recorder: durable metrics stream and crash ring — the port of
``evox_tpu/workflows/flightrec.py``.

The registry (``core/metrics.py``) holds the run's live counters, gauges
and histograms; this module makes them durable and readable:

- :class:`MetricsStream` — an append-only, fsynced, hash-chained
  JSON-lines file (the :class:`~evox_tpu_torch.workflows.journal.
  ChainedLog` discipline: a torn tail is truncated with a warning on
  adoption, a tampered middle record raises
  :class:`~evox_tpu_torch.workflows.journal.JournalIntegrityError`).
  ``tools/check_report.py`` validates it (known kinds, monotonic
  counters, SLO coherence).
- :class:`FlightRecorder` — the producer facade: one registry, a bounded
  in-memory ring of the newest events and samples (the tape a
  post-mortem carries), and the optional stream. ``directory=None``
  keeps everything in memory; passing no recorder at all
  (``GenerationExecutor(metrics=None)``) is an exact no-op.
- :func:`read_stream` and :func:`merge_pod_streams` — read a stream
  without adopting it, and merge per-process streams into one Chrome
  trace, clock-aligned at their first common ``barrier`` record.

Record kinds (:data:`STREAM_KINDS`): ``meta`` (once, first), ``sample``
(a registry snapshot and the SLO ledger at a chunk boundary), ``event``
(a discrete transition, such as an integrity heal) and ``barrier`` (a
rendezvous anchor). Everything here is host file I/O between
dispatches.
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from ..core.metrics import MetricsRegistry
from .journal import ChainedLog, jsonable

__all__ = [
    "FlightRecorder",
    "MetricsStream",
    "STREAM_KINDS",
    "STREAM_SCHEMA",
    "merge_pod_streams",
    "read_stream",
]

STREAM_SCHEMA = "evox_tpu.metrics_stream/v1"

#: closed record-kind whitelist (the journal EVENT_KINDS discipline)
STREAM_KINDS = ("meta", "sample", "event", "barrier")

#: trace pids are ``pid_base + local track``; one stride per process —
#: the deterministic pid <-> process-index mapping
PID_STRIDE = 100

_US = 1e6


class MetricsStream(ChainedLog):
    """The metrics stream file: :class:`ChainedLog` under
    ``metrics.jsonl`` with the :data:`STREAM_KINDS` whitelist. All
    durability semantics (per-record fsync, torn-tail repair on
    adoption, loud tamper detection) are inherited."""

    FILENAME = "metrics.jsonl"
    SCHEMA = STREAM_SCHEMA
    KINDS = STREAM_KINDS
    # retention may drop old segments but never the newest rendezvous
    # anchor — pod merge alignment needs at least one intact barrier
    PIN_KINDS = ("barrier",)

    def report(self) -> dict:
        """The ``metrics.stream`` subsection of ``run_report()``."""
        return {
            "path": str(self.path),
            "records": len(self._records),
            "events": self.counts(),
            "torn_tail_dropped": self.torn_tail_dropped,
        }


class FlightRecorder:
    """The metrics producer facade.

    Args:
        directory: stream directory. ``None`` = in-memory only — the
            registry and ring still work (post-mortem tails, reports),
            but NOTHING is written to disk.
        ring_capacity: bounded in-memory ring of the newest
            events/samples/barriers (``collections.deque(maxlen=...)``)
            — the black-box tape dumped into post-mortems.
        process_id / process_count: pod identity stamped into the
            ``meta`` record and the pid mapping; by default the rank and
            world size of an initialised ``torch.distributed`` group,
            else 0 and 1, so a plain single-process recorder needs no
            arguments.
        max_segment_bytes / retain_segments: forwarded to
            :class:`MetricsStream` — size-bounded segment rotation of
            ``metrics.jsonl`` with the hash chain carried across the
            boundary, and opt-in retention that never drops the newest
            intact ``barrier`` (see :class:`~evox_tpu_torch.workflows.
            journal.ChainedLog`). A long-lived process should set these;
            the defaults keep one unbounded file.

    Producers call :meth:`count` / :meth:`set` / :meth:`observe`
    (registry mutations — pure host memory, safe at any frequency),
    :meth:`event` (ring + one durable record), :meth:`barrier` (ring +
    one durable alignment record), and :meth:`sample` (ring + one
    durable full-registry snapshot — the per-chunk cadence). Mutators
    never raise into the serving path for I/O reasons: the stream's own
    ``append`` raising (disk full) propagates, matching the journal's
    WAL contract — losing metrics silently would be worse.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        ring_capacity: int = 256,
        process_id: Optional[int] = None,
        process_count: Optional[int] = None,
        max_segment_bytes: Optional[int] = None,
        retain_segments: Optional[int] = None,
    ):
        if ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {ring_capacity}")
        if process_id is None or process_count is None:
            pid, pcount = _process_info()
            process_id = pid if process_id is None else process_id
            process_count = pcount if process_count is None else process_count
        self.process_id = int(process_id)
        self.process_count = int(process_count)
        self.registry = MetricsRegistry()
        self._ring: collections.deque = collections.deque(maxlen=ring_capacity)
        self._t0 = time.perf_counter()
        self._started_wall = time.time()
        self.stream: Optional[MetricsStream] = None
        if directory is not None:
            self.stream = MetricsStream(
                str(directory),
                max_segment_bytes=max_segment_bytes,
                retain_segments=retain_segments,
            )
            if not self.stream.records(kind="meta"):
                self.stream.append(
                    "meta",
                    process_id=self.process_id,
                    process_count=self.process_count,
                    pid_base=self.process_id * PID_STRIDE,
                    started_wall=round(self._started_wall, 6),
                )

    # -------------------------------------------------------------- registry
    def count(self, name: str, n: float = 1.0) -> None:
        self.registry.count(name, n)

    def set(self, name: str, v: float) -> None:
        self.registry.set(name, v)

    def observe(self, name: str, v: float, **kw: Any) -> None:
        self.registry.observe(name, v, **kw)

    def _tm(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    # --------------------------------------------------------------- records
    def _record(self, kind: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        rec = {"kind": kind, "tm": self._tm(), **jsonable(payload)}
        self._ring.append(rec)
        if self.stream is not None:
            self.stream.append(kind, **{k: v for k, v in rec.items() if k != "kind"})
        return rec

    def event(self, name: str, **fields: Any) -> None:
        """One discrete serving transition (preemption, eviction, pod
        failure…): ring + durable ``event`` record. ``name`` is dotted
        like metric names (``queue.preempt``, ``pod.failure``)."""
        self._record("event", {"name": name, **fields})

    def barrier(self, name: str, **fields: Any) -> None:
        """A rendezvous anchor: the merge key for pod clock alignment.
        Every pod member writes the SAME ``name`` at the SAME logical
        barrier, each stamping its own clocks — alignment then needs no
        cross-host clock agreement."""
        self._record(
            "barrier",
            {"name": str(name), "t_wall": round(time.time(), 6), **fields},
        )

    def sample(self, **context: Any) -> Dict[str, Any]:
        """A full registry snapshot + SLO ledger, durably appended —
        the per-dispatch-boundary cadence (once a chunk). ``context``
        rides along verbatim (e.g. ``generation=``)."""
        snap = self.registry.snapshot()
        return self._record("sample", {**snap, "slo": self.slo_ledger(), **context})

    # -------------------------------------------------------------- recovery
    def restore(self, sample: Dict[str, Any]) -> None:
        """Re-seed the registry from one stream ``sample`` record — the
        crash-recovery path: a resumed run restores the metrics plane to
        the barrier its state came from, so the replayed stretch
        re-counts exactly what the crash rolled back. (Rates restart
        with the new process's clock.)"""
        reg = self.registry
        for name, v in (sample.get("counters") or {}).items():
            reg.counter(name).value = float(v)
        for name, v in (sample.get("gauges") or {}).items():
            reg.set(name, float(v))
        for name, h in (sample.get("histograms") or {}).items():
            hist = reg.histogram(name, h["le"])
            hist.counts = [int(c) for c in h["counts"]]
            hist.count = int(h["count"])
            hist.sum = float(h["sum"])

    def restore_at(self, generation: Optional[int] = None) -> bool:
        """Restore from the stream's newest sample whose ``generation``
        context matches the recovered barrier. Returns False — registry
        left at zero, the correct seed for a from-scratch replay — when
        no such sample exists (including ``generation=None``).
        Appends a ``queue.recover`` event either way: the stream
        validator resets its counter-monotonicity baseline there
        (replayed counts legally rewind past samples the crash rolled
        back)."""
        samples = (
            self.stream.records(kind="sample")
            if self.stream is not None
            else []
        )
        # generation=None (no barrier survived — from-scratch replay)
        # matches nothing: the zeroed registry IS the right seed there
        samples = [r for r in samples if r.get("generation") == generation]
        if samples:
            self.restore(samples[-1])
        self.event(
            "queue.recover",
            generation=generation,
            restored=bool(samples),
        )
        return bool(samples)

    # ------------------------------------------------------------------ views
    def tail(self, n: int = 50) -> List[dict]:
        """The newest ``n`` ring records — the black-box tape a
        post-mortem carries."""
        ring = list(self._ring)
        return jsonable(ring[-n:])

    def slo_ledger(self) -> dict:
        """The SLO ledger: the ``slo.*`` counter namespace as one view,
        plus the derived tenant-gens/sec rate over the recorder's
        lifetime."""
        elapsed = max(self._tm(), 1e-9)
        reg = self.registry
        gens = reg.value("slo.tenant_gens")
        return {
            "tenant_gens": int(gens),
            "elapsed_s": round(elapsed, 6),
            "tenant_gens_per_s": round(gens / elapsed, 6),
            "admissions": int(reg.value("slo.admissions")),
            "preemptions": int(reg.value("slo.preemptions")),
            "deadline_hits": int(reg.value("slo.deadline_hits")),
            "deadline_misses": int(reg.value("slo.deadline_misses")),
        }

    def record_search(self, search: Dict[str, Any]) -> None:
        """Publish a LineageMonitor search report (monitors/lineage.py,
        the run_report ``search`` section) into the
        ``search.*`` gauge namespace — called at a dispatch boundary
        with ``monitor.search_report(mstate)``, the same host-side
        cadence as :meth:`sample`. Gauges carry absolute values (the
        monitor's on-device counters are the source of truth; re-publish
        after a crash restore and the plane converges like everything
        else): ``search.generations`` / ``search.epoch`` /
        ``search.restarts``, the newest window's ``search.best_fitness``
        / ``search.delta`` (and ``search.front_size`` /
        ``search.churn`` for MO runs), and the per-operator credit table
        as ``search.ledger.<op>.attempts|successes|improvement``."""
        if not isinstance(search, dict) or not search.get("enabled"):
            return
        for key in ("generations", "epoch", "restarts", "width"):
            if isinstance(search.get(key), (int, float)):
                self.set(f"search.{key}", float(search[key]))
        for op, row in (search.get("ledger") or {}).items():
            for key in ("attempts", "successes", "improvement"):
                if isinstance(row.get(key), (int, float)):
                    self.set(f"search.ledger.{op}.{key}", float(row[key]))
        traj = search.get("trajectory") or {}
        for key in ("best_fitness", "delta", "front_size", "churn"):
            col = traj.get(key)
            if isinstance(col, list) and col:
                self.set(f"search.{key}", float(col[-1]))

    def record_integrity(self, integrity: Dict[str, Any]) -> None:
        """Publish a compute-integrity report (core/attest.py, the
        run_report ``integrity`` section) into the
        ``integrity.*`` gauge namespace — same host-side cadence and
        absolute-value discipline as :meth:`record_search`. Gauges:
        ``integrity.attestations`` (ring count) and the newest ring
        entry's ``integrity.last_generation``; the verify rung's
        ``integrity.redispatches`` / ``integrity.verified_chunks``
        / ``integrity.mismatches`` / ``integrity.healed`` /
        ``integrity.aborted``; bisection forensics publish
        ``integrity.first_divergent_generation`` when one was named.
        The verdict rides as an ``integrity.verdict`` event whenever it
        is not ``clean`` (events are the anomaly lane; a clean run adds
        zero event records)."""
        if not isinstance(integrity, dict) or not integrity.get("enabled"):
            return
        if isinstance(integrity.get("attestations"), (int, float)):
            self.set(
                "integrity.attestations", float(integrity["attestations"])
            )
        ring = integrity.get("ring") or []
        if ring and isinstance(ring[-1].get("generation"), (int, float)):
            self.set(
                "integrity.last_generation", float(ring[-1]["generation"])
            )
        verify = integrity.get("verify") or {}
        for key in (
            "redispatches",
            "verified_chunks",
            "mismatches",
            "healed",
            "aborted",
        ):
            if isinstance(verify.get(key), (int, float)):
                self.set(f"integrity.{key}", float(verify[key]))
        bisection = integrity.get("bisection") or {}
        fdg = bisection.get("first_divergent_generation")
        if isinstance(fdg, (int, float)):
            self.set("integrity.first_divergent_generation", float(fdg))
        verdict = integrity.get("verdict")
        if verdict and verdict != "clean":
            self.event("integrity.verdict", verdict=verdict)

    def report(self) -> dict:
        """The ``metrics`` section of ``run_report()`` (validated by
        tools/check_report.py)."""
        out: dict = {
            "enabled": True,
            "process_id": self.process_id,
            "process_count": self.process_count,
            "ring_len": len(self._ring),
            "ring_capacity": self._ring.maxlen,
            **self.registry.snapshot(),
        }
        if self.stream is not None:
            out["stream"] = self.stream.report()
        return out

    def to_openmetrics(self) -> str:
        return self.registry.to_openmetrics()


# --------------------------------------------------------------- pod merge


def read_stream(path: Any) -> List[dict]:
    """Read-only stream load: parse ``metrics.jsonl`` records without
    adopting (no truncation — a reader and the merge must never
    write to a stream a live run owns). A torn tail line is skipped;
    chain verification is the validator's/adoption's job."""
    p = Path(path)
    if p.is_dir():
        p = p / MetricsStream.FILENAME
    records: List[dict] = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail — the crash artifact, reader-safe
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _align_offsets(streams: Sequence[List[dict]]) -> List[float]:
    """Per-process time offsets (seconds to SUBTRACT from each stream's
    ``tm``) that put the first barrier name common to ALL processes at
    the same merged instant. With no common barrier (or one process),
    offsets are zero — tracks land on their own clocks, still viewable."""
    barrier_tm: List[Dict[str, float]] = []
    for recs in streams:
        seen: Dict[str, float] = {}
        for r in recs:
            if r.get("kind") == "barrier" and r.get("name") not in seen:
                seen[str(r.get("name"))] = float(r.get("tm", 0.0))
        barrier_tm.append(seen)
    common = set(barrier_tm[0]) if barrier_tm else set()
    for seen in barrier_tm[1:]:
        common &= set(seen)
    if not common or len(streams) < 2:
        return [0.0] * len(streams)
    # earliest common barrier in process 0's clock — deterministic
    anchor = min(common, key=lambda name: barrier_tm[0][name])
    ref = barrier_tm[0][anchor]
    return [seen[anchor] - ref for seen in barrier_tm]


def merge_pod_streams(
    stream_dirs: Sequence[Any],
    trace_path: Optional[str] = None,
    merged_stream_path: Optional[str] = None,
) -> dict:
    """Process 0's pod aggregation: merge per-process metrics streams
    into ONE Perfetto/Chrome trace (named per-process tracks — counter
    tracks from samples, instant markers from events/barriers) and one
    aggregated stream file, clock-aligned at the first common barrier
    record. Returns ``{"trace": <dict>, "records": <aggregated list>,
    "offsets_s": [...], "processes": n}``; writes the files when paths
    are given. Read-only over the inputs."""
    streams = [read_stream(d) for d in stream_dirs]
    if not streams:
        raise ValueError("merge_pod_streams: no streams given")
    offsets = _align_offsets(streams)
    events: List[dict] = []
    merged: List[dict] = []
    for p, (recs, off) in enumerate(zip(streams, offsets)):
        meta = next((r for r in recs if r.get("kind") == "meta"), {})
        proc = int(meta.get("process_id", p))
        pid_base = int(meta.get("pid_base", proc * PID_STRIDE))
        events.append(_meta(pid_base, f"process {proc}: metrics"))
        events.append(_meta(pid_base, "events", tid=1))
        counter_names: List[str] = []
        for r in recs:
            kind = r.get("kind")
            ts = max(float(r.get("tm", 0.0)) - off, 0.0) * _US
            if kind == "event":
                events.append(
                    {
                        "ph": "i",
                        "name": str(r.get("name")),
                        "cat": "metrics",
                        "pid": pid_base,
                        "tid": 1,
                        "ts": round(ts, 3),
                        "s": "t",
                    }
                )
            elif kind == "barrier":
                events.append(
                    {
                        "ph": "i",
                        "name": f"barrier:{r.get('name')}",
                        "cat": "metrics",
                        "pid": pid_base,
                        "tid": 1,
                        "ts": round(ts, 3),
                        "s": "p",
                    }
                )
            elif kind == "sample":
                flat = dict(r.get("counters") or {})
                flat.update(r.get("gauges") or {})
                flat["slo.tenant_gens_per_s"] = (r.get("slo") or {}).get(
                    "tenant_gens_per_s", 0
                )
                for name, v in flat.items():
                    if not isinstance(v, (int, float)) or isinstance(v, bool):
                        continue
                    if name not in counter_names:
                        counter_names.append(name)
                    events.append(
                        {
                            "ph": "C",
                            "name": name,
                            "pid": pid_base,
                            "ts": round(ts, 3),
                            "args": {name.rsplit(".", 1)[-1]: v},
                        }
                    )
            merged.append({**r, "process_id": proc, "tm_aligned": round(ts / _US, 6)})
    merged.sort(key=lambda r: (r.get("tm_aligned", 0.0), r.get("process_id", 0)))
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "evox_tpu_torch.workflows.flightrec.merge_pod_streams",
            "time_origin": "first common pod barrier",
            "processes": len(streams),
            "offsets_s": [round(o, 6) for o in offsets],
        },
    }
    if trace_path is not None:
        with open(trace_path, "w") as f:
            json.dump(trace, f, allow_nan=False)
    if merged_stream_path is not None:
        with open(merged_stream_path, "w") as f:
            for rec in merged:
                f.write(json.dumps(jsonable(rec), allow_nan=False) + "\n")
    return {
        "trace": trace,
        "records": merged,
        "offsets_s": [round(o, 6) for o in offsets],
        "processes": len(streams),
    }


def _process_info() -> tuple:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _meta(pid: int, name: str, tid: Optional[int] = None) -> dict:
    e: dict = {
        "ph": "M",
        "pid": pid,
        "name": "process_name" if tid is None else "thread_name",
        "args": {"name": name},
    }
    if tid is not None:
        e["tid"] = tid
    return e
