"""PodSupervisor — the fault domain of a ``torch.distributed`` process
group; the port of ``evox_tpu/core/pod_supervisor.py``.

Collectives run in lockstep: a worker killed, wedged or preempted leaves
every survivor blocked inside a collective (or a
:func:`~evox_tpu_torch.core.distributed.process_barrier`) with no deadline
and no diagnosis. This module closes that gap on the host:

- **Heartbeats**: every member runs a daemon thread that bumps a counter in
  the process group's key-value store (``FileStore`` or ``TCPStore``,
  :func:`~evox_tpu_torch.core.distributed.dist_store`; no collective, so it
  works whatever the backend). :meth:`PodSupervisor.census` is a double
  read separated by a probe interval: a member whose counter did not
  advance is not alive, and no clocks are compared across hosts.
- **Collective deadlines**: :meth:`PodSupervisor.supervised` runs a
  lockstep point (a chunk dispatch, a checkpoint's commit barrier) on a
  disposable watchdog thread with a wall-clock deadline, the body that
  ``RunSupervisor``'s dispatch watchdog shares (:func:`_watchdog_call`). A
  hung call becomes a raised, classified error; its thread is abandoned.
- **Classification**: deadline hits and store errors are refined through
  the census into ``worker_dead`` (a peer's heartbeat stopped),
  ``hung_collective`` (every peer alive, the call itself is wedged) or
  ``coordinator_loss`` (the store is gone). Any other failure propagates
  unchanged; ``workflows/supervisor.py``'s ``classify_error`` folds the pod
  errors into its classes (the deadlines into ``deadline``, a classified
  :class:`PodFailureError` into ``fatal``: one process cannot heal a pod
  fault, re-formation happens outside it).
- **Coordinated drain**: :meth:`install_sigterm_drain` turns SIGTERM (a
  preemption notice) into a drain: the chunk in flight finishes, every
  member agrees at the next :meth:`chunk_boundary` (process 0 arbitrates
  through the store, so no member drains while another walks into a
  collective nobody joins), a final barrier checkpoint is fsynced and the
  run returns. The resumed run equals the uninterrupted one.

Membership transitions (join, failure, drain, reform, resume) are
journaled as the ``pod_*`` kinds of a
:class:`~evox_tpu_torch.workflows.journal.RunJournal` by process 0 only,
are ``run_report``'s ``pod_supervisor`` section (the JAX package's schema
v9, ``tools/check_report.py``) and ``write_chrome_trace``'s
``supervisor:pod:*`` markers. Without a pod supervisor nothing of this
runs. In one process every method keeps its local meaning: the census is
``{0: True}``, barriers and the drain decision are local, and
``supervised`` keeps only the watchdog.
"""

from __future__ import annotations

import signal
import threading
import time
import warnings
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import distributed as _dist
from .distributed import BarrierTimeoutError, process_barrier

__all__ = [
    "WORKER_DEAD",
    "HUNG_COLLECTIVE",
    "COORDINATOR_LOSS",
    "INTEGRITY_DISSENT",
    "POD_FAILURE_CLASSES",
    "POD_EVENT_KINDS",
    "COORD_ABORT_S",
    "CollectiveDeadlineError",
    "PodFailureError",
    "PodSupervisor",
]

#: the detection bound a multi-process deadline must undercut: the JAX
#: package's (its runtime aborts a process about 10 s after it stops
#: reaching the coordinator). The port keeps it, so a pod fault is
#: classified within the same budget on either package.
COORD_ABORT_S = 10.0
#: the margin under that bound
_COORD_ABORT_MARGIN_S = 0.5

# pod-domain failure classes (strings, so post-mortems stay plain JSON)
WORKER_DEAD = "worker_dead"
HUNG_COLLECTIVE = "hung_collective"
COORDINATOR_LOSS = "coordinator_loss"
# a pod whose chunk result lost a 2-of-3 integrity vote: it answered in
# time with wrong bits (the remedy differs from a dead worker's)
INTEGRITY_DISSENT = "integrity_dissent"
POD_FAILURE_CLASSES = (WORKER_DEAD, HUNG_COLLECTIVE, COORDINATOR_LOSS, INTEGRITY_DISSENT)

#: every event kind a PodSupervisor records (the report's section and the
#: trace's markers; tools/check_report.py pins the set)
POD_EVENT_KINDS = ("join", "census", "barrier_timeout", "failure", "drain_requested", "drain",
                   "reform", "resume")

# event kind -> the counter it increments
_COUNTER_FOR = {
    "census": "censuses",
    "barrier_timeout": "barrier_timeouts",
    "failure": "failures",
    "drain": "drains",
    "reform": "reforms",
    "resume": "resumes",
}

# message fingerprints of a store that is gone: torch.distributed's store
# and socket errors once process 0 (the TCPStore's server) died
_CHANNEL_PATTERNS = (
    "coordinator",
    "unavailable",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "failed to connect",
    "shutting down",
)


class CollectiveDeadlineError(RuntimeError):
    """A supervised lockstep point ran past its wall-clock deadline: some
    peer never entered (or never left) it. ``classify_error`` folds it into
    ``deadline``; the pod supervisor refines it through the census."""


class PodFailureError(RuntimeError):
    """The pod supervisor diagnosed a pod-domain fault. ``classification``
    is one of :data:`POD_FAILURE_CLASSES`; ``post_mortem`` the structured
    account (entry point, census, detection latency, event tail) for the
    code that re-forms the pod. ``classify_error`` reads it as ``fatal``."""

    def __init__(self, message: str, classification: str, post_mortem: dict):
        super().__init__(message)
        self.classification = classification
        self.post_mortem = post_mortem


def _watchdog_call(fn: Callable[[], Any], deadline_s: Optional[float], label: str,
                   make_timeout: Optional[Callable[[str, float], BaseException]] = None,
                   thread_prefix: str = "pod") -> Any:
    """``fn()`` on a disposable daemon thread, waited on for at most
    ``deadline_s`` (``None``: called inline). The one watchdog body: the
    dispatch watchdog of ``workflows/supervisor.py`` passes its own timeout
    error through ``make_timeout``. A hung call keeps its thread forever,
    so threads are never pooled: a hung one is abandoned (it holds nothing
    the next call needs: the call's inputs are immutable states)."""
    if deadline_s is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def target() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - raised again on the caller
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=target, daemon=True, name=f"{thread_prefix}:{label}")
    worker.start()
    if not done.wait(deadline_s):
        # the call returns, if ever, after its caller has moved on: the
        # executor counts no dispatch time for it (core/executor.py)
        worker.abandoned = True
        if make_timeout is not None:
            raise make_timeout(label, deadline_s)
        raise CollectiveDeadlineError(
            f"pod collective '{label}' exceeded its {deadline_s:g} s deadline; the worker "
            "thread is abandoned (a lockstep collective with a missing peer never completes)")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _is_channel_error(exc: BaseException) -> bool:
    if isinstance(exc, ConnectionError):
        return True
    msg = str(exc).lower()
    return any(p in msg for p in _CHANNEL_PATTERNS)


class PodSupervisor:
    """Liveness, collective deadlines, the coordinated drain and the
    barrier resume of one process-group member.

    Args:
        deadline_s: wall-clock bound of supervised points (chunk
            dispatches) and the default barrier timeout; ``None`` disables
            the watchdog (barriers keep ``process_barrier``'s default).
        checkpoint_deadline_s: the bound of a synchronous checkpoint save
            in a process group (default six times ``deadline_s``).
        heartbeat_interval_s: the heartbeat period; the census waits
            ``2 * interval + 0.2`` s between its reads.
        journal: a :class:`~evox_tpu_torch.workflows.journal.RunJournal`,
            its directory, or ``None``. Process 0 appends the ``pod_*``
            records.
        epoch: the pod's formation counter (0 first, bumped by the
            code that re-forms the pod); it namespaces the store's keys.
        namespace: the store's key prefix for heartbeats, drain intents
            and decisions.
        clock: the monotonic clock (``time.perf_counter``, the recorder's,
            so trace tracks align).
        metrics: a ``FlightRecorder``: every transition counted there
            (``pod.*``), the heartbeat's store latency observed, barriers
            stamped, and a failure's post-mortem carries its tail.
    """

    #: failed beats in a row before the heartbeat thread gives up: one
    #: blip of the store must not freeze a healthy member's counter
    _HB_MAX_CONSECUTIVE_FAILURES = 5

    def __init__(self, deadline_s: Optional[float] = None,
                 checkpoint_deadline_s: Optional[float] = None,
                 heartbeat_interval_s: float = 0.5, journal: Any = None, epoch: int = 0,
                 namespace: str = "evox_tpu_torch/pod",
                 clock: Callable[[], float] = time.perf_counter, metrics: Any = None):
        if heartbeat_interval_s <= 0:
            raise ValueError(f"heartbeat_interval_s must be > 0, got {heartbeat_interval_s}")
        self.deadline_s = deadline_s
        # a checkpoint save (copy, pickle, fsync) outlasts a chunk: bounding
        # it by the chunk's deadline would abort a healthy pod
        self.checkpoint_deadline_s = (
            checkpoint_deadline_s if checkpoint_deadline_s is not None
            else (6.0 * deadline_s if deadline_s is not None else None))
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.epoch = int(epoch)
        self.namespace = f"{namespace}/e{self.epoch}"
        self.metrics = metrics
        self._clock = clock
        self._created = clock()
        self.process_id, self.process_count = _dist.process_id(), _dist.process_count()
        # in a process group, a deadline whose worst detection latency
        # (deadline + the census probe) cannot beat the abort bound is
        # clamped with a warning; one process has no peer to wait for
        if self.deadline_s is not None and self.process_count > 1:
            slack = 2.0 * self.heartbeat_interval_s + 0.2
            budget = COORD_ABORT_S - _COORD_ABORT_MARGIN_S - slack
            if self.deadline_s > budget:
                clamped = max(budget, self.heartbeat_interval_s)
                warnings.warn(
                    f"PodSupervisor deadline_s={self.deadline_s} cannot classify a fault within "
                    f"the ~{COORD_ABORT_S:g} s coordination heartbeat abort bound: detection "
                    f"needs the deadline + {slack:.1f} s of census slack; clamping to "
                    f"{clamped:.2f} s", stacklevel=2)
                self.deadline_s = clamped
                if checkpoint_deadline_s is None:
                    self.checkpoint_deadline_s = 6.0 * clamped
        self._journal = self._resolve_journal(journal)
        self._hb_seq = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._drain_flag = threading.Event()
        self._drain_reason: Optional[str] = None
        self._drain_event_recorded = False
        self._prev_boundary_gen: Optional[int] = None
        self._prev_sigterm: Any = None
        self._lock = threading.Lock()
        self._outcome: Optional[str] = None
        self.events: List[dict] = []
        self.counters: Dict[str, int] = {
            "heartbeats": 0, "censuses": 0, "barriers": 0, "barrier_timeouts": 0,
            "supervised_calls": 0, "failures": 0, "drains": 0, "reforms": 0, "resumes": 0,
        }

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _resolve_journal(journal: Any) -> Any:
        if journal is None:
            return None
        if isinstance(journal, (str, bytes)) or hasattr(journal, "__fspath__"):
            from ..workflows.journal import RunJournal

            return RunJournal(str(journal))
        return journal

    def _store(self) -> Any:
        """The group's store, or None in one process."""
        if self.process_count <= 1:
            return None
        return _dist.dist_store()

    def _event(self, kind: str, **fields: Any) -> None:
        assert kind in POD_EVENT_KINDS, kind
        ev = {"t": round(self._clock() - self._created, 6), "event": kind}
        ev.update(fields)
        with self._lock:
            self.events.append(ev)
            counter = _COUNTER_FOR.get(kind)
            if counter is not None:
                self.counters[counter] += 1
        if self.metrics is not None:
            self.metrics.count(f"pod.{kind}")

    def _journal_event(self, kind: str, **payload: Any) -> None:
        """Append the transition (process 0 only). A failed append never
        masks the event: the run's own failure is usually unwinding."""
        if self._journal is None or self.process_id != 0:
            return
        try:
            self._journal.append(kind, epoch=self.epoch, process_id=self.process_id, **payload)
        except Exception:  # pragma: no cover - a full disk
            pass

    # ----------------------------------------------------------- heartbeats
    def start(self) -> "PodSupervisor":
        """Join the pod: record the membership and start the heartbeat
        thread. Idempotent; returns self."""
        if self._hb_thread is None or not self._hb_thread.is_alive():
            self._event("join", process_id=self.process_id, process_count=self.process_count,
                        epoch=self.epoch)
            self._journal_event("pod_join", process_count=self.process_count)
            self._hb_stop.clear()
            self.beat()  # the first beat lands before any peer can census us
            self._hb_thread = threading.Thread(target=self._beat_loop, daemon=True,
                                               name="pod:heartbeat")
            self._hb_thread.start()
        return self

    def stop(self) -> None:
        """Stop the heartbeat thread and give SIGTERM back its previous
        handler (idempotent). A stopped counter is what a census reads as
        death: a clean exit passes a barrier first."""
        self._hb_stop.set()
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):  # pragma: no cover - not the main thread
                pass
            self._prev_sigterm = None

    def beat(self) -> int:
        """Advance and publish this process's heartbeat counter once."""
        self._hb_seq += 1
        self.counters["heartbeats"] += 1
        store = self._store()
        if store is not None:
            t0 = self._clock()
            store.set(f"{self.namespace}/hb/{self.process_id}", str(self._hb_seq))
            if self.metrics is not None:
                self.metrics.observe("pod.heartbeat_ms", (self._clock() - t0) * 1e3)
        return self._hb_seq

    def _beat_loop(self) -> None:
        failures = 0
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            try:
                self.beat()
                failures = 0
            except Exception:
                # keep beating through a blip; only a persistent failure
                # ends the loop, and even then the main thread classifies
                # at its next supervised point
                failures += 1
                if failures >= self._HB_MAX_CONSECUTIVE_FAILURES:
                    return

    def _read_heartbeats(self) -> Dict[int, int]:
        store = self._store()
        if store is None:
            return {self.process_id: self._hb_seq}
        out = {}
        for p in range(self.process_count):
            key = f"{self.namespace}/hb/{p}"
            if store.check([key]):
                out[p] = int(store.get(key))
        return out

    def census(self, probe_s: Optional[float] = None) -> Dict[int, bool]:
        """Who is alive? Two reads of the store separated by ``probe_s``
        (default ``2 * heartbeat_interval + 0.2`` s): a member whose counter
        advanced between them is alive; a frozen or absent one is not.
        Raises whatever the store raises when it is gone (classified as
        :data:`COORDINATOR_LOSS`)."""
        if self._store() is None:
            alive = {self.process_id: True}
        else:
            probe = 2.0 * self.heartbeat_interval_s + 0.2 if probe_s is None else probe_s
            first = self._read_heartbeats()
            if probe > 0:
                time.sleep(probe)
            second = self._read_heartbeats()
            alive = {}
            for p in range(self.process_count):
                if p == self.process_id:
                    alive[p] = True
                    continue
                s0, s1 = first.get(p), second.get(p)
                alive[p] = s0 is not None and s1 is not None and s1 > s0
        self._event("census", alive=sorted(p for p, a in alive.items() if a),
                    dead=sorted(p for p, a in alive.items() if not a))
        return alive

    # --------------------------------------------------------- classification
    def classify_failure(self, exc: BaseException) -> Optional[str]:
        """Refine ``exc`` into a pod-domain class, or ``None`` when it is no
        pod fault (a numerics error, an OOM: the caller's ladder owns
        those). Deadlines consult the census: a frozen peer means
        :data:`WORKER_DEAD`, everyone alive :data:`HUNG_COLLECTIVE`; an
        unreadable store :data:`COORDINATOR_LOSS`."""
        if isinstance(exc, PodFailureError):
            return exc.classification
        deadline = isinstance(exc, (CollectiveDeadlineError, BarrierTimeoutError))
        if not deadline and not _is_channel_error(exc):
            return None
        try:
            alive = self.census()
        except Exception:
            return COORDINATOR_LOSS
        if any(not a for a in alive.values()):
            return WORKER_DEAD
        if deadline:
            return HUNG_COLLECTIVE
        # a store error, but the census reads and everyone is alive: a
        # blip, not a pod fault (the caller may retry)
        return None

    def _fail(self, entry: str, exc: BaseException, t0: float) -> PodFailureError:
        classification = self.classify_failure(exc)
        if classification is None:
            raise exc
        detect_s = round(self._clock() - t0, 6)
        census_ev = next((e for e in reversed(self.events) if e["event"] == "census"), None)
        self._event("failure", entry=entry, classification=classification, detect_s=detect_s,
                    error=str(exc)[:300])
        self._outcome = "failed"
        post_mortem = {
            "entry": entry,
            "classification": classification,
            "detect_s": detect_s,
            "error": f"{type(exc).__name__}: {exc}",
            "census": ({k: v for k, v in census_ev.items() if k in ("alive", "dead")}
                       if census_ev else None),
            "epoch": self.epoch,
            "process_id": self.process_id,
            "process_count": self.process_count,
            "events_tail": self.events[-20:],
        }
        if self.metrics is not None:
            self.metrics.event("pod.failure", entry=entry, classification=classification)
            post_mortem["flight_recorder"] = self.metrics.tail(20)
        self._journal_event("pod_failure", entry=entry, classification=classification,
                            detect_s=detect_s)
        return PodFailureError(
            f"pod fault at '{entry}': {classification} (detected in {detect_s:g} s): "
            f"{type(exc).__name__}: {exc}", classification=classification,
            post_mortem=post_mortem)

    # ------------------------------------------------------ collective points
    def supervised(self, fn: Callable[[], Any], entry: str = "collective",
                   deadline_s: Optional[float] = None) -> Any:
        """Run one lockstep point under the watchdog's deadline. A deadline
        hit or a dead store is classified through the census and raised as
        :class:`PodFailureError` with a post-mortem; any other failure
        propagates untouched."""
        dl = self.deadline_s if deadline_s is None else deadline_s
        self.counters["supervised_calls"] += 1
        t0 = self._clock()
        try:
            return _watchdog_call(fn, dl, entry)
        except (KeyboardInterrupt, SystemExit, PodFailureError):
            raise
        except BaseException as e:  # noqa: BLE001 - classified below
            raise self._fail(entry, e, t0) from e

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> None:
        """A classified :func:`~evox_tpu_torch.core.distributed.
        process_barrier`: its timeout (default ``deadline_s``) is raised
        through the census as a :class:`PodFailureError` naming the missing
        processes."""
        tmo = timeout_s if timeout_s is not None else self.deadline_s
        self.counters["barriers"] += 1
        t0 = self._clock()
        try:
            if tmo is None:
                process_barrier(name)
            else:
                process_barrier(name, timeout_s=tmo)
            if self.metrics is not None:
                # every member stamps the same barrier name at about the
                # same instant: the anchor per-process streams align on
                self.metrics.barrier(f"pod:{name}", wait_ms=round((self._clock() - t0) * 1e3, 3))
        except (KeyboardInterrupt, SystemExit):
            raise
        except BarrierTimeoutError as e:
            self._event("barrier_timeout", name=name, missing=list(e.missing),
                        arrived=list(e.arrived))
            raise self._fail(f"barrier:{name}", e, t0) from e
        except Exception as e:  # the store died inside the barrier
            raise self._fail(f"barrier:{name}", e, t0) from e

    # ------------------------------------------------------------------ drain
    def install_sigterm_drain(self) -> None:
        """Route SIGTERM into the coordinated drain: the handler only sets
        a flag; the next :meth:`chunk_boundary` decides for the whole pod.
        Call it from the main thread; :meth:`stop` restores the previous
        handler."""
        self._prev_sigterm = signal.signal(
            signal.SIGTERM, lambda signum, frame: self.request_drain("SIGTERM"))

    def request_drain(self, reason: str = "api") -> None:
        """Ask the pod to drain at the next chunk boundary (signal safe: it
        only sets a flag)."""
        self._drain_flag.set()
        self._drain_reason = reason

    def drain_requested(self) -> bool:
        return self._drain_flag.is_set()

    def chunk_boundary(self, generation: int, timeout_s: Optional[float] = None) -> str:
        """The rendezvous at the end of a chunk: every member publishes its
        drain intent, passes the classified barrier, and process 0 decides
        for the pod through the store, ``"continue"`` or ``"drain"``, so a
        SIGTERM landing between two members' reads cannot split them. In
        one process the decision is the local flag."""
        gen = int(generation)
        store = self._store()
        if store is None:
            decision = "drain" if self._drain_flag.is_set() else "continue"
        else:
            ns = self.namespace
            t0 = self._clock()
            try:
                store.set(f"{ns}/intent/{gen}/{self.process_id}",
                          "drain" if self._drain_flag.is_set() else "ok")
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                raise self._fail(f"boundary:{gen}", e, t0) from e
            self.barrier(f"{ns}/gen{gen}", timeout_s)
            tmo = timeout_s if timeout_s is not None else self.deadline_s
            tmo = tmo if tmo is not None else 120.0
            try:
                if self.process_id == 0:
                    keys = [f"{ns}/intent/{gen}/{p}" for p in range(self.process_count)]
                    intents = [store.get(k).decode() for k in keys]
                    decision = "drain" if "drain" in intents else "continue"
                    store.set(f"{ns}/decision/{gen}", decision)
                    # this boundary's intents are read, and every member
                    # read the previous decision before this barrier: a
                    # long run keeps no key a chunk (best effort)
                    try:
                        for k in keys:
                            store.delete_key(k)
                        if self._prev_boundary_gen is not None:
                            store.delete_key(f"{ns}/decision/{self._prev_boundary_gen}")
                    except Exception:
                        pass
                    self._prev_boundary_gen = gen
                else:
                    key = f"{ns}/decision/{gen}"
                    store.wait([key], timedelta(seconds=tmo))
                    decision = store.get(key).decode()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                raise self._fail(f"decision:{gen}", e, t0) from e
        if decision == "drain" and not self._drain_event_recorded:
            self._drain_event_recorded = True
            self._event("drain_requested", generation=gen, reason=self._drain_reason or "peer")
        return decision

    def note_integrity_dissent(self, generation: int, entry: str = "verify",
                               dissent: str = "first") -> None:
        """Record that a 2-of-3 integrity vote outvoted this pod's chunk
        result (``dissent``: ``"first"``, the original dispatch, or
        ``"redo"``). Nothing is raised: the voter dropped the result; the
        event is for the code that re-forms the pod and for the fleet
        health policy."""
        self._event("failure", entry=entry, classification=INTEGRITY_DISSENT,
                    generation=int(generation), dissent=dissent)
        if self.metrics is not None:
            self.metrics.event("pod.failure", entry=entry, classification=INTEGRITY_DISSENT)
        self._journal_event("pod_failure", entry=entry, classification=INTEGRITY_DISSENT,
                            generation=int(generation), dissent=dissent)

    def note_drained(self, generation: int, checkpointed: bool = True) -> None:
        """Record the completed drain. ``checkpointed=False`` says that no
        final barrier snapshot exists (the run had no checkpointer)."""
        self._event("drain", generation=int(generation), checkpointed=bool(checkpointed))
        self._journal_event("pod_drain", generation=int(generation),
                            checkpointed=bool(checkpointed))
        self._outcome = "drained"

    # ------------------------------------------------------------ re-formation
    def note_reform(self, survivors: Sequence[int], from_epoch: int) -> None:
        """Record that this pod re-forms ``from_epoch`` on ``survivors``."""
        survivors = sorted(int(p) for p in survivors)
        self._event("reform", survivors=survivors, from_epoch=int(from_epoch), epoch=self.epoch)
        self._journal_event("pod_reform", survivors=survivors, from_epoch=int(from_epoch))

    def resume_from_barrier(self, wf: Any, checkpointer: Any, expect_like: Any = None,
                            allow_config_mismatch: bool = False) -> Any:
        """Restore the newest intact barrier snapshot (``checkpointer``: a
        ``WorkflowCheckpointer`` or its directory) onto the workflow's
        device, by ``wf.place_restored`` where the workflow has it (fleets),
        and record the resume. Raises ``RuntimeError`` when no intact
        snapshot exists."""
        from ..workflows.checkpoint import _as_checkpointer, restore_layouts

        ckpt = _as_checkpointer(checkpointer)
        snapshot = ckpt.latest(expect_like=expect_like,
                               allow_config_mismatch=allow_config_mismatch)
        if snapshot is None:
            raise RuntimeError(f"resume_from_barrier: no intact barrier snapshot in "
                               f"{ckpt.directory}: nothing to re-form from")
        placer = getattr(wf, "place_restored", None)
        if placer is not None:
            state = placer(snapshot)
        else:
            state = restore_layouts(snapshot, device=getattr(wf, "device", None),
                                    mesh=getattr(wf, "mesh", None))
        gen = int(snapshot.generation)
        self._event("resume", generation=gen)
        self._journal_event("pod_resume", generation=gen)
        self._outcome = "resumed"
        return state

    # ------------------------------------------------------------------ report
    def report(self) -> dict:
        """``run_report``'s ``pod_supervisor`` section (strict JSON).
        ``outcome``: ``clean`` (nothing fired), ``drained``, ``failed`` or
        ``resumed``."""
        return {
            "process_id": self.process_id,
            "process_count": self.process_count,
            "epoch": self.epoch,
            "deadline_s": self.deadline_s,
            "checkpoint_deadline_s": self.checkpoint_deadline_s,
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "outcome": self._outcome or "clean",
            "counters": dict(self.counters),
            "events": list(self.events),
        }

    def markers(self) -> List[dict]:
        """The events as ``supervisor:pod:*`` instant markers for
        ``write_chrome_trace`` (the recorder's ``perf_counter`` clock)."""
        return [{"t_abs": self._created + ev["t"], "name": f"supervisor:pod:{ev['event']}",
                 "args": {k: v for k, v in ev.items() if k not in ("t", "event")}}
                for ev in self.events]
