"""RunSupervisor — deadlines, classified retry and checkpoint replay for the
dispatch layer; the port of ``evox_tpu/workflows/supervisor.py``.

- **Deadline**: every supervised dispatch chunk runs on a disposable daemon
  thread while the supervisor waits with a wall-clock bound; a chunk that
  hangs raises :class:`DispatchDeadlineError`. A hung CUDA call cannot be
  killed from Python, so its thread is abandoned.
- **Classifier**: :func:`classify_error` folds PyTorch's failures into
  ``transient`` / ``oom`` / ``deadline`` / ``fatal`` / ``integrity``:
  ``torch.cuda.OutOfMemoryError`` and "CUDA error: out of memory" are
  ``oom``; ``torch.distributed``'s network and store errors, connection
  resets and timeouts of gloo and NCCL are ``transient``; NCCL's watchdog
  timeout of a collective and this module's and the barrier's deadlines
  are ``deadline``; a CUDA error that leaves the context unusable (an
  illegal address, a launch failure) and every unknown error are
  ``fatal``; a digest mismatch (``core/attest.py``) is ``integrity``.
  Types decide before messages, and only the message is matched.
- **Escalation ladder**, per dispatch chunk: retry (bounded, exponential
  backoff with deterministic jitter) → restore the newest
  ``WorkflowCheckpointer`` snapshot and replay → degrade (pipelined runs:
  halve the host evaluation chunk on OOM) → :class:`RunAbortedError` with a
  post-mortem. OOM takes the degrade rung first where there is one.
  Retrying is bit-safe: a chunk is a function of its entry state (every
  draw comes from the state's seeds), so a retried or replayed chunk
  reproduces the clean run bit for bit.

Every decision is recorded with a host timestamp: ``run_report``'s
``supervisor`` section is :meth:`RunSupervisor.report`, and
``write_chrome_trace(supervisor=)`` draws :meth:`RunSupervisor.markers` on
the supervisor's track. The chunk loops live in
:class:`~evox_tpu_torch.core.executor.GenerationExecutor`; this module is
the policy, wired in as the executor's hooks.
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.attest import IntegrityError
from ..core.distributed import BarrierTimeoutError

__all__ = [
    "DEADLINE",
    "FATAL",
    "INTEGRITY",
    "OOM",
    "TRANSIENT",
    "DispatchDeadlineError",
    "RunAbortedError",
    "RunSupervisor",
    "classify_error",
]


class DispatchDeadlineError(RuntimeError):
    """A supervised dispatch chunk ran past its wall-clock deadline."""


class RunAbortedError(RuntimeError):
    """The supervisor's ladder is exhausted. ``post_mortem`` is the
    structured account of what was tried; ``__cause__`` the last failure."""

    def __init__(self, message: str, post_mortem: dict):
        super().__init__(message)
        self.post_mortem = post_mortem


TRANSIENT = "transient"
OOM = "oom"
DEADLINE = "deadline"
FATAL = "fatal"
INTEGRITY = "integrity"

# a CUDA error after which the context cannot be trusted: no retry
_FATAL_CUDA_PATTERNS = (
    "illegal memory access",
    "illegal address",
    "unspecified launch failure",
    "misaligned address",
    "device-side assert",
    "an illegal instruction",
)
# out of memory on the card or the host (PyTorch's caching allocator,
# cudaMalloc, NCCL's buffers)
_OOM_PATTERNS = (
    "out of memory",
    "cudaerrormemoryallocation",
    "resource_exhausted",
    "resource exhausted",
    "payload too large",
    "request entity too large",
    "http 413",
)
_OOM_413 = re.compile(r"(?:^|[^0-9.])413(?:[^0-9.]|$)")
# a collective that never completed: NCCL's watchdog
_DEADLINE_PATTERNS = (
    "watchdog caught collective operation timeout",
    "collective operation timeout",
)
# retryable failures of the transport: torch.distributed's network and
# store errors, gloo's and NCCL's connection and timeout messages
_TRANSIENT_PATTERNS = (
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "timed out",
    "timeout",
    "socket",
    "unavailable",
    "temporarily",
    "nccl communicator was aborted",
    "remote process exited",
    "eof occurred",
    "unexpected eof",
)


def _dist_error_types() -> tuple:
    """``torch.distributed``'s backend, network and store error types (the
    ones this PyTorch build has)."""
    try:
        import torch.distributed as dist
    except Exception:  # pragma: no cover - builds without distributed
        return ()
    return tuple(t for t in (getattr(dist, name, None) for name in (
        "DistBackendError", "DistNetworkError", "DistStoreError")) if isinstance(t, type))


def classify_error(exc: BaseException) -> str:
    """Fold an exception into ``transient`` / ``oom`` / ``deadline`` /
    ``fatal`` / ``integrity`` (module docstring). A bubbled-up
    :class:`RunAbortedError` is always fatal: a supervisor never retries
    another's verdict."""
    import torch

    if isinstance(exc, IntegrityError):
        return INTEGRITY
    if isinstance(exc, (DispatchDeadlineError, BarrierTimeoutError)):
        return DEADLINE
    if isinstance(exc, RunAbortedError):
        return FATAL
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return OOM
    msg = str(exc).lower()
    if any(p in msg for p in _FATAL_CUDA_PATTERNS):
        return FATAL
    if any(p in msg for p in _OOM_PATTERNS):
        return OOM
    if _OOM_413.search(msg) and ("http" in msg or "remote" in msg):
        return OOM
    if any(p in msg for p in _DEADLINE_PATTERNS):
        return DEADLINE
    if isinstance(exc, (ConnectionError, TimeoutError) + _dist_error_types()):
        return TRANSIENT
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return TRANSIENT
    if isinstance(exc, OSError):
        return TRANSIENT
    return FATAL


def _call_with_deadline(fn: Callable[[], Any], deadline_s: Optional[float], label: str) -> Any:
    """``fn()`` on a fresh daemon thread, waited on for at most
    ``deadline_s`` (``None``: called inline). A hung call keeps its thread
    forever, so threads are never pooled: a hung one is abandoned."""
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

    threading.Thread(target=target, daemon=True, name=f"supervised:{label}").start()
    if not done.wait(deadline_s):
        raise DispatchDeadlineError(
            f"dispatch '{label}' exceeded its {deadline_s:g} s deadline; the worker thread is "
            "abandoned (a hung CUDA call cannot be interrupted)")
    if "error" in box:
        raise box["error"]
    return box["value"]


# event kind -> the counter it increments
_COUNTER_FOR = {
    "retry": "retries",
    "deadline": "deadline_hits",
    "restore": "restores",
    "degrade": "degradations",
    "abort": "aborts",
}


class RunSupervisor:
    """Drive a workflow's dispatch chunks under deadlines, classified
    retry, checkpoint replay and degradation.

    Args:
        checkpointer: optional ``WorkflowCheckpointer``. Runs are chunked at
            its cadence and snapshotted between chunks (the final state is
            an unsupervised run's), and the restore rung replays from its
            newest intact snapshot.
        deadline_s: wall-clock bound of one supervised chunk (``None``: no
            watchdog). A pipelined chunk's bound covers the whole chunk.
        max_retries: transient and deadline retries a chunk before the
            restore rung.
        max_restores: snapshot replays a run (not a chunk: a chunk that
            always fails would otherwise cycle forever).
        backoff_s, backoff_factor, jitter: a retry sleeps ``backoff_s *
            factor**(attempt-1) * (1 + jitter*u)``, ``u`` uniform in [0, 1)
            from a PRNG seeded with ``seed`` (reproducible).
        min_eval_chunk: the floor of the pipelined evaluation chunk; OOM
            below it escalates.
        metrics: a ``FlightRecorder`` (``workflows/flightrec.py``): every
            event counted there, and an abort's post-mortem carries its
            newest records. ``None`` records nothing.
        attest, verify_every: the executor's voted re-dispatch for fused
            runs (``core/executor.py``); ``None`` adds no dispatch.

    One supervisor may drive many runs; counters and events accumulate.
    """

    def __init__(
        self,
        checkpointer: Any = None,
        deadline_s: Optional[float] = None,
        max_retries: int = 3,
        max_restores: int = 1,
        backoff_s: float = 0.05,
        backoff_factor: float = 2.0,
        jitter: float = 0.25,
        min_eval_chunk: int = 1,
        seed: int = 0,
        metrics: Any = None,
        attest: Any = None,
        verify_every: Optional[int] = None,
    ):
        if max_retries < 0 or max_restores < 0:
            raise ValueError("max_retries and max_restores must be >= 0")
        if min_eval_chunk < 1:
            raise ValueError(f"min_eval_chunk must be >= 1, got {min_eval_chunk}")
        self.checkpointer = checkpointer
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.max_restores = max_restores
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.jitter = jitter
        self.min_eval_chunk = min_eval_chunk
        self.attest = attest
        self.verify_every = verify_every
        self.metrics = metrics
        self._rng = random.Random(seed)
        self._created = time.perf_counter()
        self.events: List[dict] = []
        self.counters: Dict[str, int] = {
            "dispatches": 0,
            "retries": 0,
            "deadline_hits": 0,
            "restores": 0,
            "degradations": 0,
            "aborts": 0,
        }
        self._outcome: Optional[str] = None

    # ------------------------------------------------------------- recording
    def _event(self, kind: str, **fields: Any) -> None:
        ev = {"t": round(time.perf_counter() - self._created, 6), "event": kind}
        ev.update(fields)
        self.events.append(ev)
        counter = _COUNTER_FOR.get(kind)
        if counter is not None:
            self.counters[counter] += 1
        if self.metrics is not None:
            self.metrics.count(f"supervisor.{kind}")

    def report(self) -> dict:
        """``run_report``'s ``supervisor`` section, strict JSON. ``outcome``:
        ``clean`` (nothing fired), ``recovered`` (faults healed) or
        ``aborted`` (the ladder ran out)."""
        healed = any(e["event"] in ("retry", "restore", "degrade") for e in self.events)
        outcome = self._outcome
        if outcome is None:
            outcome = "recovered" if healed else "clean"
        return {
            "deadline_s": self.deadline_s,
            "max_retries": self.max_retries,
            "max_restores": self.max_restores,
            "counters": dict(self.counters),
            "outcome": outcome,
            "events": list(self.events),
        }

    def markers(self) -> List[dict]:
        """The events as instant markers with absolute timestamps on the
        recorder's clock (``time.perf_counter``), for ``write_chrome_trace``."""
        return [{"t_abs": self._created + ev["t"], "name": f"supervisor:{ev['event']}",
                 "args": {k: v for k, v in ev.items() if k not in ("t", "event")}}
                for ev in self.events]

    # -------------------------------------------------------------- plumbing
    def _sleep_backoff(self, attempt: int) -> float:
        dt = self.backoff_s * self.backoff_factor ** max(attempt - 1, 0)
        dt *= 1.0 + self.jitter * self._rng.random()
        time.sleep(dt)
        return dt

    def _abort(self, entry: str, error: BaseException, **ladder: Any) -> None:
        self._event("abort", entry=entry, error=str(error)[:300], **ladder)
        self._outcome = "aborted"
        post_mortem = {
            "entry": entry,
            "error": f"{type(error).__name__}: {error}",
            "classification": classify_error(error),
            "ladder": dict(ladder),
            "counters": dict(self.counters),
            "events_tail": self.events[-20:],
        }
        if self.metrics is not None:
            self.metrics.event("supervisor.abort", entry=entry, error=str(error)[:120])
            post_mortem["flight_recorder"] = self.metrics.tail(20)
        raise RunAbortedError(
            f"supervised '{entry}' exhausted its escalation ladder ({ladder}); last failure: "
            f"{type(error).__name__}: {error}", post_mortem=post_mortem) from error

    def call(
        self,
        fn: Callable[[], Any],
        entry: str = "dispatch",
        restore: Optional[Callable[[], Any]] = None,
        degrade: Optional[Callable[[], bool]] = None,
        restore_budget: Optional[Dict[str, int]] = None,
    ) -> Any:
        """One supervised dispatch of the zero-argument ``fn`` under the
        whole ladder (``fn`` is called again on a retry). ``restore()``
        returns a snapshot to replay from: when that rung fires, the
        snapshot is the call's result and the caller replays from its
        ``generation``. ``degrade()`` applies one degradation and says
        whether it could. ``restore_budget``: a ``{"used": n}`` cell shared
        by every chunk of one run (the restores are bounded a run)."""
        retries = 0
        if restore_budget is None:
            restore_budget = {"used": 0}
        while True:
            self.counters["dispatches"] += 1
            try:
                return _call_with_deadline(fn, self.deadline_s, entry)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 - classified below
                kind = classify_error(e)
                if kind == DEADLINE:
                    self._event("deadline", entry=entry, deadline_s=self.deadline_s)
                if kind == FATAL:
                    self._abort(entry, e, rung="fatal")
                if kind == INTEGRITY:
                    self._abort(entry, e, rung="integrity")
                if kind == OOM and degrade is not None and degrade():
                    self._event("degrade", entry=entry, error=str(e)[:300])
                    continue
                if retries < self.max_retries and kind != OOM:
                    retries += 1
                    waited = self._sleep_backoff(retries)
                    self._event("retry", entry=entry, attempt=retries, classification=kind,
                                backoff_s=round(waited, 6), error=str(e)[:300])
                    continue
                if restore is not None and restore_budget["used"] < self.max_restores:
                    snapshot = restore()
                    if snapshot is not None:
                        restore_budget["used"] += 1
                        self._event("restore", entry=entry, attempt=restore_budget["used"],
                                    classification=kind)
                        return snapshot
                self._abort(entry, e, rung="exhausted", retries=retries,
                            restores=restore_budget["used"])

    # ------------------------------------------------------------ fused runs
    def run(self, wf: Any, state: Any, n_steps: int, chunk: Optional[int] = None,
            resume_from: Any = None, executor: Any = None) -> Any:
        """Supervised ``wf.run``: the run is chunked (at the checkpointer's
        cadence, else every ``chunk`` generations, else one chunk) and each
        chunk dispatched under the deadline and the ladder. Chunking changes
        no arithmetic, and a retry or a replay starts from an immutable
        state, so the final state is a straight ``wf.run``'s bit for bit.
        ``resume_from`` restores the newest intact snapshot first and makes
        ``n_steps`` the total."""
        from ..core.executor import GenerationExecutor

        ex = executor if executor is not None else GenerationExecutor()
        return ex.run_fused(wf, state, n_steps, checkpointer=self.checkpointer, chunk=chunk,
                            resume_from=resume_from, supervisor=self, attest=self.attest,
                            verify_every=self.verify_every)

    # --------------------------------------------------------- pipelined runs
    def run_host_pipelined(self, wf: Any, state: Any, n_steps: int, chunk: Optional[int] = None,
                           eval_chunk: Optional[int] = None, resume_from: Any = None,
                           executor: Any = None, **pipelined_kw: Any) -> Any:
        """Supervised ``run_host_pipelined`` for host problems: chunked like
        :meth:`run`, each chunk under the ladder with the degrade rung live
        (on OOM the host evaluation batch halves, floored at
        ``min_eval_chunk``, and the chunk is retried from its entry
        state)."""
        from ..core.executor import GenerationExecutor

        ex = executor if executor is not None else GenerationExecutor()
        return ex.run_host(wf, state, n_steps, checkpointer=self.checkpointer, chunk=chunk,
                           eval_chunk=eval_chunk, resume_from=resume_from, supervisor=self,
                           **pipelined_kw)

    def _restorer(self, ckpt: Any, wf: Any, expect_like: Any) -> Optional[Callable[[], Any]]:
        """The replay rung's thunk: the newest intact snapshot, placed on
        the workflow's device (or by the fleet's own layout)."""
        if ckpt is None:
            return None
        from .checkpoint import restore_layouts

        def restore() -> Any:
            snapshot = ckpt.latest(expect_like=expect_like)
            if snapshot is None:
                return None
            placer = getattr(wf, "place_restored", None)
            if placer is not None:
                return placer(snapshot)
            return restore_layouts(snapshot, device=getattr(wf, "device", None))

        return restore
