"""One gateway over many pods: the journal-backed multi-pod control plane;
the port of ``evox_tpu/workflows/control_plane.py``.

A :class:`ControlPlane` (the gateway) owns a durable tenant ledger
(:class:`ControlLedger`, the ``ChainedLog`` machinery of every durable
surface here), places :class:`~evox_tpu_torch.workflows.elastic.ElasticSpec`
requests across N pods (each pod one
:class:`~evox_tpu_torch.workflows.elastic.ElasticServer` with its own
journal, checkpoint and metrics directories) and survives a kill of the
gateway, of a pod, or of a steal half done.

The three laws (``tests/test_torch_control_plane.py``):

- **Write-ahead**: every gateway decision (submit, placement, steal, pod
  open, dead or close, autoscale) is fsynced into the ledger before the
  pod-side mutation it describes. Recovery replays the ledger against the
  per-pod journals, so a crash between the ledger append and the pod
  mutation re-derives the mutation, and a crash between the pod mutation
  and the ledger append is healed by dedup.
- **Cross-pod stealing, exactly once**: a pod declared dead has its
  outstanding work re-placed on surviving pods from a host-only parse of
  its journals: parked continuations move with their durable checkpoints
  (checked intact by the manifest digest, never unpickled), tenants that
  never finished run again from their seeds, and finished tenants' result
  entries are adopted from the close-out records. A steal is durable in
  the target pod's journal first, then the ledger's ``steal``, then (a
  live source only) the source queue's ``release_continuation``: a kill
  at any point leaves at worst a duplicate placement, which checkpoint and
  tag dedup removes at the next recovery.
- **Kill-anywhere recovery**: :meth:`ControlPlane.recover` rebuilds the
  gateway from the ledger and the per-pod journals alone. Per-tenant
  results and telemetry fingerprints equal the uncrashed run's (tenants
  are seeded and isolated by ``member_call``, and every sum a tenant's
  state or ring takes is in a fixed order, so results do not depend on
  placement), and each spec is admitted once.

:class:`PodAutoscaler` reads queue depth and the flight recorder's SLO
ledger between rounds, opens a pod under pressure and drains and closes an
idle one (queued work steals away; active tenants finish where they run).

Everything the gateway does between dispatches is host file I/O. Every
ledger record is plain JSON: integers and floats taken to the host, never
a tensor.
"""

from __future__ import annotations

import dataclasses
import json
import re
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .elastic import BucketShape, BucketTable, ElasticServer, ElasticSpec
from .journal import ChainedLog, RunJournal

__all__ = [
    "ControlLedger",
    "ControlPlane",
    "PodAutoscaler",
    "PodRuntime",
]

_PAD = "_pad_"
_BUCKET_KEY = re.compile(r"^pop(\d+)_dim(\d+)_w(\d+)$")

#: the chaos hook: called with a point label at every write-ahead half
#: step (``pre_place:``, ``pre_pod_submit:``, ``steal_target_durable:``,
#: ``pre_source_release:``, each followed by the tenant's tag), so a
#: scripted kill can land between "durable in the target" and the ledger
#: append
_CRASH_HOOK: Optional[Callable[[str], None]] = None


def _crash_point(point: str) -> None:
    hook = _CRASH_HOOK
    if hook is not None:
        hook(point)


def _checkpoint_attest(checkpoint_dir: Any) -> Optional[dict]:
    """The parked checkpoint's newest manifest attestation, ``{"digest",
    "generation"}``, read from the manifest JSON (file I/O, nothing
    unpickled), so the steal record pins the bits the moved tenant resumes
    from. ``None`` for a manifest without one or anything unreadable: the
    steal never fails on it, the resumer verifies."""
    try:
        manifests = sorted(Path(checkpoint_dir).glob("ckpt_????????.pkl.manifest.json"))
        if not manifests:
            return None
        with open(manifests[-1]) as f:
            att = json.load(f).get("attest")
        if not isinstance(att, dict) or att.get("digest") is None:
            return None
        return {"digest": att["digest"], "generation": att.get("generation")}
    except Exception:
        return None


def _parse_bucket_key(name: str) -> Optional[BucketShape]:
    m = _BUCKET_KEY.match(name)
    if m is None:
        return None
    return BucketShape(pop=int(m.group(1)), dim=int(m.group(2)), width=int(m.group(3)))


# ------------------------------------------------------------------ ledger


class ControlLedger(ChainedLog):
    """The gateway's durable decision log: one hash-chained JSON-lines file
    (``ledger.jsonl``) under the control plane's root. Every record is
    fsynced before the transition it describes; recovery replays the whole
    history, so retention is refused (segment rotation,
    ``max_segment_bytes``, is kept)."""

    FILENAME = "ledger.jsonl"
    SCHEMA = "evox_tpu.control_ledger/v1"
    KINDS = (
        "submit",      # a tenant acknowledged by the gateway (full payload)
        "place",       # tenant -> pod assignment
        "steal",       # tenant re-placed from one pod onto another
        "pod_open",    # a pod joined the census
        "pod_dead",    # a pod declared dead
        "pod_close",   # a drained pod left the census
        "autoscale",   # a demand-driven grow or shrink decision
        "recover",     # a gateway recovery replayed this ledger
    )

    def __init__(self, directory: str, max_segment_bytes: Optional[int] = None,
                 retain_segments: Optional[int] = None):
        if retain_segments is not None:
            raise ValueError(
                "ControlLedger does not support retention: recovery replays the full decision "
                "history; use max_segment_bytes alone")
        super().__init__(directory, max_segment_bytes=max_segment_bytes)


# ------------------------------------------------------------- spec codecs


def _host_array(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _elastic_spec_record(spec: ElasticSpec) -> dict:
    """The ledger ``submit`` payload: everything needed to place the request
    again after the gateway dies. An integer seed rides as ``seed``; any
    other seed (an array of key words) as ``seed_key`` and its dtype."""
    rec: dict = {
        "tag": spec.tag,
        "n_steps": int(spec.n_steps),
        "pop": int(spec.pop),
        "dim": int(spec.dim),
        "deadline": int(spec.deadline) if spec.deadline is not None else None,
        "hyperparams": {k: _host_array(v) for k, v in spec.hyperparams.items()},
    }
    seed = spec.seed
    if isinstance(seed, (int, np.integer)):
        rec["seed"] = int(seed)
    else:
        arr = _host_array(seed)
        rec["seed_key"] = arr
        rec["seed_key_dtype"] = str(arr.dtype)
    return rec


def _elastic_spec_from_record(rec: dict) -> ElasticSpec:
    if rec.get("seed") is not None:
        seed: Any = int(rec["seed"])
    else:
        seed = np.asarray(rec["seed_key"], dtype=rec.get("seed_key_dtype", "uint32"))
    return ElasticSpec(
        seed=seed,
        n_steps=int(rec["n_steps"]),
        pop=int(rec["pop"]),
        dim=int(rec["dim"]),
        hyperparams=dict(rec.get("hyperparams") or {}),
        tag=rec.get("tag"),
        deadline=int(rec["deadline"]) if rec.get("deadline") is not None else None,
    )


# --------------------------------------------------------- steal derivation


def _derive_outstanding(recs: List[dict]) -> tuple:
    """Host-only post-mortem of one bucket journal: its acknowledged submits
    split into (outstanding submit records, completed result entries). A
    submit is outstanding unless a terminal close-out (retire, evict,
    freeze), a moved close-out (preempt, autoscale: the work continued
    under a continuation submit) or a steal accounts for its seq. Padding
    fillers are dropped. Terminal close-outs embed the whole result entry,
    so a dead pod's finished work surfaces without rebuilding its fleet."""
    submits: Dict[int, dict] = {}
    closed: set = set()
    completed: List[dict] = []
    for r in recs:
        kind = r.get("kind")
        if kind == "submit":
            submits[int(r["spec_seq"])] = r
        elif kind in ("retire", "evict", "freeze", "preempt", "autoscale"):
            if r.get("spec_seq") is not None:
                closed.add(int(r["spec_seq"]))
            if kind in ("retire", "evict", "freeze"):
                entry = r.get("entry") or {}
                if not (entry.get("tag") or "").startswith(_PAD):
                    completed.append(entry)
        elif kind == "steal" and r.get("spec_seq") is not None:
            closed.add(int(r["spec_seq"]))
    outstanding = [rec for seq, rec in sorted(submits.items())
                   if seq not in closed and not (rec.get("tag") or "").startswith(_PAD)]
    return outstanding, completed


# ---------------------------------------------------------------- runtimes


@dataclasses.dataclass
class PodAutoscaler:
    """The demand-driven pod census, evaluated once a gateway round. Its
    inputs are deterministic serving state (queued work a live pod, each
    pod's idle streak, the SLO ledger's deadline misses), so a recovered
    gateway makes the decisions the crashed one made.

    Args:
        scale_up_depth: open a pod when queued (not yet admitted) work a
            live pod exceeds this.
        miss_pressure: also open a pod when the SLO ledger's
            ``deadline_misses`` grew by at least this since the last round
            (None: queue depth only).
        scale_down_idle_rounds: drain and close a pod that served nothing
            for this many rounds in a row.
        min_pods / max_pods: census bounds.
    """

    scale_up_depth: int = 4
    miss_pressure: Optional[int] = None
    scale_down_idle_rounds: int = 3
    min_pods: int = 1
    max_pods: int = 4

    def report(self) -> dict:
        return {
            "scale_up_depth": self.scale_up_depth,
            "miss_pressure": self.miss_pressure,
            "scale_down_idle_rounds": self.scale_down_idle_rounds,
            "min_pods": self.min_pods,
            "max_pods": self.max_pods,
        }


class PodRuntime:
    """One pod: an :class:`ElasticServer` over its own directories
    (``<root>/pods/<pod_id>/{journal,ckpt}``), sharing the gateway's serving
    cache, bucket table and flight recorder. A dead pod keeps its
    directories (the steal source) while ``server`` drops to None: its
    fleets died with it."""

    def __init__(self, plane: "ControlPlane", pod_id: str):
        self.id = pod_id
        self.root = plane.directory / "pods" / pod_id
        self.dead = False
        self.closed = False
        self.draining = False
        self.idle_rounds = 0
        self.server: Optional[ElasticServer] = ElasticServer(
            factory=plane.factory, table=plane.table, cache=plane.cache, width=plane.width,
            chunk=plane.chunk, journal_dir=str(self.root / "journal"),
            checkpoint_dir=str(self.root / "ckpt"), autoscaler=plane.autoscaler,
            supervisor=plane.supervisor, executor=plane.executor, metrics=plane.metrics)

    @property
    def alive(self) -> bool:
        return not self.dead and not self.closed

    def bucket_dirs(self) -> List[Path]:
        root = self.root / "journal"
        if not root.exists():
            return []
        return [d for d in sorted(root.iterdir())
                if d.is_dir() and _parse_bucket_key(d.name) is not None
                and ((d / RunJournal.FILENAME).exists()
                     or any(d.glob(RunJournal.FILENAME + ".[0-9]*")))]

    def recover_buckets(self) -> None:
        """Rebuild every journaled bucket of this pod from disk."""
        for d in self.bucket_dirs():
            self.server.recover_bucket(_parse_bucket_key(d.name))


# ------------------------------------------------------------------ gateway


class ControlPlane:
    """The gateway: a journal-backed scheduler over N pods.

    Args:
        factory: the shared bucket factory (``factory(BucketShape) ->
            ElasticWorkflow``; every pod builds the same fleets, which is
            what makes stolen work independent of its placement).
        directory: the plane's root: the ledger at the root, pods under
            ``pods/<pod_id>/``, the serving cache under ``cache/``.
        n_pods: pods opened at construction.
        table / width / chunk: the shared lattice.
        autoscaler: a per-bucket :class:`~evox_tpu_torch.workflows.elastic.
            PopAutoscaler` (pop rungs within a pod).
        pod_autoscaler: a :class:`PodAutoscaler` (the census across pods).
        metrics: one :class:`~evox_tpu_torch.workflows.flightrec.
            FlightRecorder` (or a directory for one) over the whole plane:
            its SLO ledger is the autoscaler's pressure input.
        supervisor / executor: given to every pod's queues.
        max_ledger_segment_bytes: rotate the ledger into segments (one hash
            chain across them).

    One :class:`~evox_tpu_torch.core.exec_cache.ExecutableCache` under the
    root serves every pod: a bucket warmed on one pod is a cache hit on the
    next, and a gateway recovered in a fresh process warms each bucket it
    recovers from the manifest's entries.
    """

    def __init__(self, factory: Callable[[BucketShape], Any], directory: str, n_pods: int = 2,
                 table: Optional[BucketTable] = None, width: int = 4, chunk: int = 5,
                 autoscaler: Any = None, pod_autoscaler: Optional[PodAutoscaler] = None,
                 metrics: Any = None, supervisor: Any = None, executor: Any = None,
                 max_ledger_segment_bytes: Optional[int] = None, _adopt: bool = False):
        from ..core.exec_cache import ExecutableCache

        self.factory = factory
        self.directory = Path(directory)
        self.table = table if table is not None else BucketTable()
        self.width = width
        self.chunk = chunk
        self.autoscaler = autoscaler
        self.pod_autoscaler = pod_autoscaler
        self.supervisor = supervisor
        self.executor = executor
        if isinstance(metrics, (str, Path)):
            from .flightrec import FlightRecorder

            metrics = FlightRecorder(directory=str(metrics))
        self.metrics = metrics
        self.cache = ExecutableCache(directory=str(self.directory / "cache"))
        if metrics is not None:
            self.cache.metrics = metrics
        self.ledger = ControlLedger(str(self.directory), max_segment_bytes=max_ledger_segment_bytes)
        if not _adopt and self.ledger.records():
            raise RuntimeError(
                f"control-plane directory {self.directory} already holds a ledger: use "
                "ControlPlane.recover() to adopt it (a fresh gateway over it would fork the "
                "decision history)")
        self.pods: Dict[str, PodRuntime] = {}
        self._pod_seq = 0
        self._tenant_seq = 0
        #: tag -> {"record": the ledger's submit payload, "pod": current pod}
        self._tenants: Dict[str, dict] = {}
        self._adopted_results: List[dict] = []
        self.steal_events: List[dict] = []
        self.autoscale_events: List[dict] = []
        self._round = 0
        self._last_misses = 0
        self.counters: Dict[str, int] = {
            "submitted": 0, "placed": 0, "stolen": 0, "steal_dedup": 0, "pods_opened": 0,
            "pods_dead": 0, "pods_closed": 0, "recoveries": 0,
        }
        if not _adopt:
            for _ in range(int(n_pods)):
                self._open_pod()

    # ------------------------------------------------------------- census
    def _open_pod(self) -> str:
        pod_id = f"pod{self._pod_seq:02d}"
        self._pod_seq += 1
        self.ledger.append("pod_open", pod=pod_id)
        self.pods[pod_id] = PodRuntime(self, pod_id)
        self.counters["pods_opened"] += 1
        if self.metrics is not None:
            self.metrics.count("control.pods_opened")
            self.metrics.set("control.pods_live", len(self.live_pods()))
            self.metrics.event("control.pod_open", pod=pod_id)
        return pod_id

    def live_pods(self) -> List[str]:
        return [pid for pid, pr in self.pods.items() if pr.alive]

    def _placement_candidates(self) -> List[str]:
        return [pid for pid, pr in self.pods.items() if pr.alive and not pr.draining]

    def _pod_load(self, pr: PodRuntime) -> int:
        if pr.server is None:
            return 0
        n = 0
        for b in pr.server._buckets.values():
            q = b.queue
            n += len(q.pending) + len(q.continuations)
            n += sum(1 for s in q.slots if s is not None and s.active
                     and not (s.spec.tag or "").startswith(_PAD))
        return n

    def _queued_depth(self) -> int:
        return sum(len(b.queue.pending) + len(b.queue.continuations)
                   for pid in self._placement_candidates()
                   for b in self.pods[pid].server._buckets.values())

    # -------------------------------------------------------------- submit
    def bucket_for(self, spec: ElasticSpec) -> BucketShape:
        return self.table.bucket_for(spec.pop, spec.dim, self.width)

    def _rank_target(self, shape: BucketShape, exclude: tuple = ()) -> str:
        cands = [pid for pid in self._placement_candidates() if pid not in exclude]
        if not cands:
            # the autoscaling primitive is also the last-resort placement:
            # work must land somewhere durable
            self.ledger.append("autoscale", action="grow", reason="no_live_pods")
            pid = self._open_pod()
            self.autoscale_events.append({"action": "grow", "pod": pid,
                                          "reason": "no_live_pods"})
            return pid

        def rank(pid: str) -> tuple:
            # least loaded first; a warm bucket breaks ties, then the pod id
            pr = self.pods[pid]
            warm = 0 if shape.key in pr.server._buckets else 1
            return (self._pod_load(pr), warm, pid)

        return min(cands, key=rank)

    def submit(self, spec: ElasticSpec) -> str:
        """Acknowledge one tenant and place it: the ledger's ``submit`` (the
        full payload), the ledger's ``place`` (its bucket and the least
        loaded live pod, warm buckets first), then the pod journal's
        submit. :meth:`recover` heals a crash between any two. Tags name
        tenants across the plane and must be unique; an untagged spec is
        given one. Returns the pod id."""
        if spec.tag is None:
            spec = dataclasses.replace(spec, tag=f"t{self._tenant_seq:05d}")
        if (spec.tag or "").startswith(_PAD):
            raise ValueError(f"tenant tag {spec.tag!r} collides with the reserved padding "
                             "namespace")
        if spec.tag in self._tenants:
            raise ValueError(f"duplicate tenant tag {spec.tag!r}: the ledger's exactly-once "
                             "admission law needs plane-unique tags")
        rec = _elastic_spec_record(spec)
        self.ledger.append("submit", **rec)
        self._tenant_seq += 1
        self.counters["submitted"] += 1
        self._tenants[spec.tag] = {"record": rec, "pod": None}
        _crash_point(f"pre_place:{spec.tag}")
        shape = self.bucket_for(spec)
        pod_id = self._rank_target(shape)
        self.ledger.append("place", tag=spec.tag, pod=pod_id, bucket=shape.key)
        self._tenants[spec.tag]["pod"] = pod_id
        _crash_point(f"pre_pod_submit:{spec.tag}")
        self.pods[pod_id].server.submit(spec)
        self.counters["placed"] += 1
        if self.metrics is not None:
            self.metrics.count("control.placed")
            self.metrics.event("control.place", tag=spec.tag, pod=pod_id, bucket=shape.key)
        return pod_id

    # --------------------------------------------------------------- serve
    def has_work(self) -> bool:
        return any(pr.server is not None and pr.server.has_work()
                   for pr in self.pods.values() if pr.alive)

    def serve_round(self) -> None:
        """One gateway quantum: every live pod advances one serving round
        (a chunk a bucket), then the pod autoscale pass. Chunk boundaries
        are the only places the gateway's state changes."""
        self._round += 1
        for pr in list(self.pods.values()):
            if not pr.alive or pr.server is None:
                continue
            if pr.server.has_work():
                pr.server.serve_round()
                pr.idle_rounds = 0
            else:
                pr.idle_rounds += 1
        self._pod_autoscale_pass()

    def serve(self, max_rounds: Optional[int] = None) -> List[dict]:
        """Drive every pod to completion; returns the merged results."""
        rounds = 0
        while self.has_work():
            self.serve_round()
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return self.results()

    # --------------------------------------------------------------- steal
    def mark_dead(self, pod_id: str, reason: str = "declared_dead") -> None:
        """Declare a pod dead and steal its outstanding work. Its in-memory
        server is dropped (it died with the process); only its durable
        journals and checkpoints are read from here on."""
        pr = self.pods[pod_id]
        if pr.dead:
            return
        self.ledger.append("pod_dead", pod=pod_id, reason=reason)
        pr.dead = True
        pr.server = None
        self.counters["pods_dead"] += 1
        if self.metrics is not None:
            self.metrics.count("control.pods_dead")
            self.metrics.set("control.pods_live", len(self.live_pods()))
            self.metrics.event("control.pod_dead", pod=pod_id, reason=reason)
        self._steal_from_dead(pod_id)

    def _already_placed(self, tag: str, checkpoint: Optional[str]) -> bool:
        """The dedup witness: is this work already durable in a live pod's
        journal? (Heals a gateway that died between the target's submit and
        the ledger's ``steal``: the re-derived steal finds its first half
        done and skips.)"""
        for pr in self.pods.values():
            if not pr.alive or pr.server is None:
                continue
            for b in pr.server._buckets.values():
                if b.queue.journal is None:
                    continue
                for r in b.queue.journal.records("submit"):
                    if r.get("tag") == tag and (checkpoint is None
                                                or r.get("resume_from") == checkpoint):
                        return True
        return False

    def _adopt_completed(self, pod_id: str, bucket: str, completed: List[dict]) -> None:
        known = {(e.get("tag"), e.get("status"), e.get("generations"))
                 for e in self._adopted_results}
        for e in completed:
            k = (e.get("tag"), e.get("status"), e.get("generations"))
            if k not in known:
                known.add(k)
                self._adopted_results.append({**e, "bucket": bucket, "pod": pod_id})

    def _steal_from_dead(self, pod_id: str) -> None:
        from .checkpoint import snapshot_dir_intact
        from .tenancy import _spec_from_record

        pr = self.pods[pod_id]
        for bdir in pr.bucket_dirs():
            shape = _parse_bucket_key(bdir.name)
            outstanding, completed = _derive_outstanding(RunJournal(str(bdir)).records())
            self._adopt_completed(pod_id, bdir.name, completed)
            seen_ckpts: set = set()
            for rec in outstanding:
                tag = rec.get("tag")
                ck = rec.get("resume_from")
                if ck is not None:
                    if ck in seen_ckpts:
                        continue  # a continuation the replay submitted twice
                    seen_ckpts.add(ck)
                if self._already_placed(tag, ck):
                    self.counters["steal_dedup"] += 1
                    continue
                tspec = _spec_from_record(rec)
                target = self._rank_target(shape, exclude=(pod_id,))
                tb = self.pods[target].server._get_bucket(shape)
                resumed = False
                if ck is not None and snapshot_dir_intact(ck):
                    tb.queue.submit_resume(tspec, checkpoint=ck, done=rec.get("done"))
                    resumed = True
                else:
                    if ck is not None:
                        warnings.warn(
                            f"steal {tag!r} from {pod_id}: parked checkpoint {ck} is torn; the "
                            "tenant runs again from its seed (deterministic, but its parked "
                            "progress is lost)")
                    tb.queue.submit(tspec)
                _crash_point(f"steal_target_durable:{tag}")
                self._record_steal(tag, pod_id, target, shape.key,
                                   checkpoint=ck if resumed else None,
                                   source_seq=int(rec["spec_seq"]))

    def _record_steal(self, tag: str, from_pod: str, to_pod: str, bucket: str,
                      checkpoint: Optional[str], source_seq: Optional[int]) -> None:
        # a tenant that moves with a parked checkpoint has that checkpoint's
        # manifest attestation pinned in the record: the resumed bits can be
        # proven the parked bits without trusting the file system
        attest = _checkpoint_attest(checkpoint) if checkpoint is not None else None
        self.ledger.append("steal", tag=tag, from_pod=from_pod, to_pod=to_pod, bucket=bucket,
                           checkpoint=checkpoint, attest=attest, source_seq=source_seq)
        self.counters["stolen"] += 1
        self._tenants.setdefault(tag, {"record": None, "pod": None})
        self._tenants[tag]["pod"] = to_pod
        ev = {"tag": tag, "from_pod": from_pod, "to_pod": to_pod, "bucket": bucket,
              "with_checkpoint": checkpoint is not None}
        self.steal_events.append(ev)
        if self.metrics is not None:
            self.metrics.count("control.stolen")
            self.metrics.event("control.steal", **ev)

    def steal_queued(self, from_pod: str, to_pod: Optional[str] = None,
                     limit: Optional[int] = None) -> List[str]:
        """Re-place a live pod's queued (not yet admitted) work on other
        pods: the slow-pod rebalance and the shrink drain. Parked
        continuations move with their checkpoints, pending specs whole.
        Each item: durable in the target journal, then the ledger's
        ``steal``, then the source queue's ``release_continuation`` (its
        own ``steal`` record). Active slots finish where they run.
        ``limit`` caps the items moved. Returns the moved tags."""
        pr = self.pods[from_pod]
        if not pr.alive or pr.server is None:
            raise RuntimeError(
                f"steal_queued needs a live pod; {from_pod} is "
                f"{'dead' if pr.dead else 'closed'}: a dead pod is stolen from its journals "
                "(mark_dead)")
        moved: List[str] = []
        for b in list(pr.server._buckets.values()):
            q, shape = b.queue, b.shape
            items = ([("cont", dict(c)) for c in list(q.continuations)]
                     + [("pend", s) for s in list(q.pending)])
            for kind, item in items:
                if limit is not None and len(moved) >= limit:
                    return moved
                if kind == "cont":
                    spec, seq = item["spec"], item.get("seq")
                    ck, done = item.get("checkpoint"), item.get("done")
                else:
                    spec, seq = item, getattr(item, "_journal_seq", None)
                    ck, done = None, None
                tag = spec.tag
                if (tag or "").startswith(_PAD) or seq is None:
                    continue
                cands = [p for p in self._placement_candidates() if p != from_pod]
                if to_pod is not None and to_pod in cands:
                    target = to_pod
                elif cands:
                    target = self._rank_target(shape, exclude=(from_pod,))
                else:
                    return moved  # nowhere to move it: it stays at the source
                spec2 = dataclasses.replace(spec)
                if getattr(spec, "_elastic_grows", 0):
                    spec2._elastic_grows = spec._elastic_grows
                tb = self.pods[target].server._get_bucket(shape)
                if ck is not None:
                    tb.queue.submit_resume(spec2, checkpoint=ck, done=done)
                else:
                    tb.queue.submit(spec2)
                _crash_point(f"steal_target_durable:{tag}")
                self._record_steal(tag, from_pod, target, shape.key, checkpoint=ck,
                                   source_seq=int(seq))
                _crash_point(f"pre_source_release:{tag}")
                q.release_continuation(int(seq))
                moved.append(tag)
        return moved

    # ----------------------------------------------------------- autoscale
    def close_pod(self, pod_id: str) -> None:
        """Begin a graceful drain: queued work steals away at once, the pod
        takes no more placements, and the ledger's ``pod_close`` lands once
        its active tenants finish."""
        pr = self.pods[pod_id]
        if not pr.alive:
            return
        pr.draining = True
        self.steal_queued(pod_id)
        self._maybe_finish_close(pod_id)

    def _maybe_finish_close(self, pod_id: str) -> None:
        pr = self.pods[pod_id]
        if pr.alive and pr.draining and (pr.server is None or not pr.server.has_work()):
            self.ledger.append("pod_close", pod=pod_id)
            pr.closed = True
            self.counters["pods_closed"] += 1
            if self.metrics is not None:
                self.metrics.event("control.pod_close", pod=pod_id)

    def _pod_autoscale_pass(self) -> None:
        for pid in list(self.pods):
            self._maybe_finish_close(pid)
        a = self.pod_autoscaler
        if a is None:
            return
        cands = self._placement_candidates()
        if not cands:
            return
        depth = self._queued_depth()
        miss_delta = 0
        if self.metrics is not None:
            misses = int(self.metrics.slo_ledger()["deadline_misses"])
            miss_delta = misses - self._last_misses
            self._last_misses = misses
        pressure = depth / len(cands) > a.scale_up_depth or (
            a.miss_pressure is not None and miss_delta >= a.miss_pressure)
        if pressure and len(cands) < a.max_pods:
            self.ledger.append("autoscale", action="grow", depth=depth, miss_delta=miss_delta)
            pid = self._open_pod()
            self.autoscale_events.append({"action": "grow", "pod": pid, "depth": depth,
                                          "miss_delta": miss_delta})
            # the new pod is idle until work reaches it: move half the
            # deepest backlog onto it
            deepest = max(cands, key=lambda p: self._pod_load(self.pods[p]))
            self.steal_queued(deepest, to_pod=pid, limit=max(1, depth // 2))
            return
        if len(cands) > a.min_pods:
            for pid in cands:
                if self.pods[pid].idle_rounds >= a.scale_down_idle_rounds:
                    self.ledger.append("autoscale", action="shrink", pod=pid)
                    self.autoscale_events.append({"action": "shrink", "pod": pid})
                    self.close_pod(pid)
                    break

    # -------------------------------------------------------------- recover
    @classmethod
    def recover(cls, factory: Callable[[BucketShape], Any], directory: str,
                table: Optional[BucketTable] = None, width: int = 4, chunk: int = 5,
                autoscaler: Any = None, pod_autoscaler: Optional[PodAutoscaler] = None,
                metrics: Any = None, supervisor: Any = None, executor: Any = None,
                max_ledger_segment_bytes: Optional[int] = None) -> "ControlPlane":
        """Rebuild the gateway after a kill anywhere, from the disk alone:
        replay the ledger to the pod census and the tenant table, recover
        every live pod's buckets from their journals, then heal what was
        half done: placements whose pod-journal submit never landed are
        submitted again, steals whose source release was lost are released
        again, dead pods are stolen from again (checkpoint and tag dedup
        remove double placements) and closed or dead pods' finished results
        are adopted from their close-out records. No checkpoint is
        unpickled to decide a placement. Serving the returned plane
        completes the sweep with per-tenant results and telemetry
        fingerprints equal to the uncrashed run's, each spec admitted
        once."""
        plane = cls(factory, directory, n_pods=0, table=table, width=width, chunk=chunk,
                    autoscaler=autoscaler, pod_autoscaler=pod_autoscaler, metrics=metrics,
                    supervisor=supervisor, executor=executor,
                    max_ledger_segment_bytes=max_ledger_segment_bytes, _adopt=True)
        recs = plane.ledger.records()
        opened = [r["pod"] for r in recs if r["kind"] == "pod_open"]
        dead = {r["pod"] for r in recs if r["kind"] == "pod_dead"}
        closed_set = {r["pod"] for r in recs if r["kind"] == "pod_close"}
        submits = {r["tag"]: r for r in recs if r["kind"] == "submit"}
        places: Dict[str, str] = {r["tag"]: r["pod"] for r in recs if r["kind"] == "place"}
        steals = [r for r in recs if r["kind"] == "steal"]
        plane._pod_seq = max((int(p[3:]) for p in opened), default=-1) + 1
        plane._tenant_seq = len(submits)
        plane.counters.update(submitted=len(submits), pods_opened=len(opened),
                              pods_dead=len(dead), pods_closed=len(closed_set),
                              stolen=len(steals))
        # the census, and each live pod's journals replayed
        for pod_id in opened:
            pr = PodRuntime(plane, pod_id)
            plane.pods[pod_id] = pr
            if pod_id in dead:
                pr.dead, pr.server = True, None
            elif pod_id in closed_set:
                pr.closed, pr.server = True, None
            else:
                pr.recover_buckets()
        # the tenant table from the ledger (steals move ownership)
        for tag, rec in submits.items():
            plane._tenants[tag] = {"record": rec, "pod": places.get(tag)}
        for s in steals:
            plane._tenants.setdefault(s["tag"], {"record": None, "pod": None})
            plane._tenants[s["tag"]]["pod"] = s["to_pod"]
            plane.steal_events.append({"tag": s["tag"], "from_pod": s["from_pod"],
                                       "to_pod": s["to_pod"], "bucket": s.get("bucket"),
                                       "with_checkpoint": s.get("checkpoint") is not None})
        # heal a ledger steal whose source release was lost (killed between
        # the ledger append and release_continuation): the recovered source
        # queue may still hold the moved seq
        for s in steals:
            src = plane.pods.get(s["from_pod"])
            if src is None or not src.alive or src.server is None:
                continue
            b = src.server._buckets.get(s.get("bucket"))
            if b is None or s.get("source_seq") is None:
                continue
            try:
                b.queue.release_continuation(int(s["source_seq"]))
            except (KeyError, ValueError):
                pass  # already released (the normal case)
        # heal a parked checkpoint placed on two pods (killed between the
        # target submit and the ledger append, then placed elsewhere by an
        # earlier recovery): keep the ledger's owner when it names one, else
        # the lowest pod id, so repeated recoveries converge
        claims: Dict[str, List[tuple]] = {}
        for pid in plane.live_pods():
            server = plane.pods[pid].server
            if server is None:
                continue
            for b in server._buckets.values():
                for c in list(b.queue.continuations):
                    ck = c.get("checkpoint")
                    if ck is not None and c.get("seq") is not None:
                        claims.setdefault(ck, []).append((pid, b, int(c["seq"])))
        stolen_to = {s.get("checkpoint"): s["to_pod"] for s in steals
                     if s.get("checkpoint") is not None}
        for ck, holders in claims.items():
            if len(holders) < 2:
                continue
            owner = stolen_to.get(ck)
            if owner is None or owner not in [h[0] for h in holders]:
                owner = min(h[0] for h in holders)
            for pid, b, seq in holders:
                if pid != owner:
                    try:
                        b.queue.release_continuation(seq)
                    except (KeyError, ValueError):
                        pass
        # acknowledged tenants: place the never placed, submit again the
        # placements whose pod-journal submit never landed
        for tag, rec in submits.items():
            spec = _elastic_spec_from_record(rec)
            pod = places.get(tag)
            if pod is None:
                shape = plane.bucket_for(spec)
                pod = plane._rank_target(shape)
                plane.ledger.append("place", tag=tag, pod=pod, bucket=shape.key)
                plane._tenants[tag]["pod"] = pod
                plane.pods[pod].server.submit(spec)
                plane.counters["placed"] += 1
                continue
            plane.counters["placed"] += 1
            pr = plane.pods[pod]
            if not pr.alive or pr.server is None:
                continue  # the dead pod's steal below derives it again
            if not plane._already_placed(tag, None):
                pr.server.submit(spec)
        # dead pods: steal again (idempotent through the dedup witness) and
        # adopt their finished results
        for pod_id in opened:
            if pod_id in dead:
                plane._steal_from_dead(pod_id)
            elif pod_id in closed_set:
                plane._adopt_closed_results(pod_id)
        plane.counters["recoveries"] = 1 + sum(1 for r in recs if r["kind"] == "recover")
        plane.ledger.append("recover", live=sorted(plane.live_pods()), dead=sorted(dead),
                            tenants=len(submits))
        if plane.metrics is not None:
            plane.metrics.event("control.recover", live=len(plane.live_pods()), dead=len(dead))
        return plane

    def _adopt_closed_results(self, pod_id: str) -> None:
        for bdir in self.pods[pod_id].bucket_dirs():
            _, completed = _derive_outstanding(RunJournal(str(bdir)).records())
            self._adopt_completed(pod_id, bdir.name, completed)

    # -------------------------------------------------------------- results
    def results(self) -> List[dict]:
        """Per-tenant results: every live pod's, plus the entries adopted
        from dead and closed pods' close-out records, each with its pod."""
        out = list(self._adopted_results)
        for pid, pr in self.pods.items():
            if pr.server is None:
                continue
            out.extend({**r, "pod": pid} for r in pr.server.results())
        return out

    def report(self) -> dict:
        """``run_report``'s ``control_plane`` section (the JAX package's
        schema v12, ``tools/check_report.py``): the pod census, the ledger's
        event counts, tenant accounting, the exactly-once admission audit
        over the live pods' journals, and the steal and autoscale events."""
        recs = self.ledger.records()
        kinds: Dict[str, int] = {}
        for r in recs:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        # across the live pods a tag has at most one fresh (not a
        # continuation) admission; a live steal leaves the submit in the
        # source journal beside its steal release, so it does not count
        fresh: Dict[str, int] = {}
        for pid in self.live_pods():
            server = self.pods[pid].server
            if server is None:
                continue
            for b in server._buckets.values():
                if b.queue.journal is None:
                    continue
                for r in b.queue.journal.records():
                    tag = r.get("tag")
                    if not tag or tag.startswith(_PAD):
                        continue
                    if r["kind"] == "submit" and r.get("resume_from") is None:
                        fresh[tag] = fresh.get(tag, 0) + 1
                    elif r["kind"] == "steal":
                        fresh[tag] = fresh.get(tag, 0) - 1
        duplicates = {t: c for t, c in fresh.items() if c > 1}
        fresh = {t: c for t, c in fresh.items() if c > 0}
        out = {
            "pods": {
                "opened": self.counters["pods_opened"],
                "live": sorted(self.live_pods()),
                "dead": sorted(pid for pid, pr in self.pods.items() if pr.dead),
                "closed": sorted(pid for pid, pr in self.pods.items() if pr.closed),
                "draining": sorted(pid for pid, pr in self.pods.items()
                                   if pr.alive and pr.draining),
            },
            "tenants": {
                "submitted": self.counters["submitted"],
                "placed": self.counters["placed"],
                "stolen": self.counters["stolen"],
                "steal_dedup": self.counters["steal_dedup"],
                "results": len(self.results()),
            },
            "events": kinds,
            "ledger": {"records": len(recs), "rotations": self.ledger.rotations,
                       "recoveries": self.counters["recoveries"]},
            "exactly_once": {"audited_tags": len(fresh), "duplicate_admissions": duplicates},
            "steals": list(self.steal_events),
            "autoscale": {
                "policy": self.pod_autoscaler.report() if self.pod_autoscaler is not None
                else None,
                "events": list(self.autoscale_events),
            },
        }
        if self.metrics is not None:
            out["slo"] = self.metrics.slo_ledger()
            # the gateway's own counters, from the registry: the validator
            # holds them against the ledger's counts
            out["metrics"] = self.metrics.registry.values("control.")
        return out

    def close(self) -> None:
        """Release the gateway's process resources: the serving cache's
        in-memory entries (its manifest stays) and the background lanes of
        every pod's queues (their fleet snapshots made durable first), the
        given executor's among them."""
        self.cache.close()
        executors = [] if self.executor is None else [self.executor]
        for pr in self.pods.values():
            if pr.server is not None:
                executors += [b.queue.executor for b in pr.server._buckets.values()]
        for ex in {id(e): e for e in executors}.values():
            if hasattr(ex, "close"):
                ex.close()
