"""GenerationExecutor — the port of ``evox_tpu/core/executor.py``: the one
generation loop behind ``checkpointed_run`` and ``run_host_pipelined``.

- **Fused runs** (:meth:`GenerationExecutor.run_fused`): ``wf.run`` in
  chunks that end on the checkpoint cadence (or on ``chunk``); each
  snapshot is copied to the host without blocking and pickled and fsynced
  on a background checkpoint lane while the next chunk runs. The chunks
  change no arithmetic, so the final state is the unchunked run's.
- **Voted re-dispatch** (``run_fused(attest=, verify_every=K)``): every
  K-th chunk is dispatched again from its entry state and the two results'
  digests compared (``core/attest.py``: one digest-kernel launch each, one
  host read for both); on a mismatch a third dispatch votes 2 of 3, and no
  majority raises :class:`~evox_tpu_torch.core.attest.IntegrityError`.
  Off (the default), it costs nothing.
- **Host problems** (:meth:`GenerationExecutor.run_host`): each
  generation's candidates go to the host (``wf.host_link``, pinned
  buffers and a CUDA event), the host ``evaluate`` runs, and
  ``on_generation`` hooks, checkpoint writes and monitor fetches run on
  background lanes. A workflow's ``host_evaluate`` hook, where it has one,
  takes the evaluation (with the candidates still on the card), and
  ``refit_due``/``dispatch_refit`` refit a surrogate after a tell
  (``workflows/surrogate.py``). At ``max_staleness=0`` the order is
  ``wf.step``'s and the evaluation runs on the calling thread (the tell
  needs its fitness, so nothing could overlap it), so the states are a
  ``wf.step`` loop's bit for bit.
- **Stale tells** (``max_staleness=K > 0``): up to ``K+1`` evaluations in
  flight on a pool of ``K+1`` worker threads, and a tell admitted at a lag
  of at most ``K`` tells. Each tell keeps its own matched (ask artifacts,
  fitness) pair: the leaves a probe ask changes, and every seed leaf, are
  grafted from the tell's own ask onto the newest told state, so updates
  accumulate while the sampling distribution lags by at most ``K`` tells.
  An ask issued while tells are pending gets fresh seeds,
  ``fold_in_seed(entry_seed, generation)``. The loop's order does not
  depend on timing (an ask is issued while ``asked - told <= K``, a tell
  waits on the oldest evaluation), so runs are deterministic. Each
  in-flight generation's candidates sit in their own pinned block from
  PyTorch's caching host allocator, waited on by their own CUDA event; a
  block goes back to the allocator only when its evaluation has returned
  and dropped it.
- **Background I/O lanes**: one worker thread each (work lands in
  submission order) with a bounded in-flight queue; ``submit`` waits on
  the oldest task when the lane is full, and a task's error is raised at
  the next ``submit`` or ``drain``. The checkpoint lane is drained before
  a run returns.
- **Metrics** (``metrics=``, a
  :class:`~evox_tpu_torch.workflows.flightrec.FlightRecorder`): dispatch
  counts and milliseconds, the counter tracks as gauges, integrity events
  and monitor fetches. ``None`` changes nothing.

- **Supervision as hooks** (``supervisor=``, a
  :class:`~evox_tpu_torch.workflows.supervisor.RunSupervisor`): every
  chunk of a fused run, and every chunked pipelined segment, is dispatched
  through ``supervisor.call`` (the deadline, the classified retry, the
  restore rung replaying from the newest snapshot, and for pipelined runs
  the degrade rung halving ``eval_chunk``). Restores are bounded a run.

Every CUDA call of an unsupervised run stays on the calling thread: the
lanes' and the evaluation pool's worker threads see numpy and host
tensors, and wait only on CUDA events the calling thread recorded after the
copies they read; a supervisor with a deadline dispatches each chunk from
its watchdog thread. A pod supervisor (``pod_supervisor=``,
``core/pod_supervisor.py``) wraps each chunk of a fused run in its
collective deadline, innermost, and ends each chunk in its rendezvous: a
coordinated drain finishes the chunk, saves a final snapshot and returns.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from .attest import IntegrityError
from .state_io import host_copy_async
from .struct import named_leaves

__all__ = ["GenerationExecutor"]

# ask-side monitor hooks: an admitted stale tell's monitor chain comes from
# the newest told state, so monitors whose state advances in these hooks
# would lose generations
_ASK_SIDE_HOOKS = ("pre_step", "pre_ask", "post_ask", "pre_eval")
# a seed leaf: a field named ``seed`` or ``*_seed`` (states hold integer
# seeds where the JAX package holds keys)
_SEED_PATH = re.compile(r"\.(\w+_)?seed$")

_MAX_TRACE_SPANS = 20_000
_MAX_COUNTER_SAMPLES = 20_000


class _IoLane:
    """One ordered background I/O lane: a single worker thread (so tasks
    land in submission order) and a bounded in-flight deque. ``submit``
    applies backpressure by joining the oldest task when the lane is full.
    Errors are re-raised at the next ``submit``/``drain``."""

    def __init__(self, name: str, max_inflight: int):
        self.name = name
        self.max_inflight = max(1, int(max_inflight))
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"executor-{name}")
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self.submitted = 0
        self.busy_s = 0.0
        self.high_water = 0

    def submit(self, fn: Callable[[], Any]) -> Future:
        while len(self._pending) >= self.max_inflight:
            self._pending.popleft().result()  # backpressure + error surface

        def timed():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                with self._lock:
                    self.busy_s += time.perf_counter() - t0

        fut = self._pool.submit(timed)
        self._pending.append(fut)
        self.submitted += 1
        self.high_water = max(self.high_water, len(self._pending))
        return fut

    def depth(self) -> int:
        return sum(1 for f in self._pending if not f.done())

    def drain(self) -> None:
        """Join every pending task, re-raising the first error."""
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class _InflightEval:
    """One generation's in-flight evaluation: its loop index, the ask's
    ctx, the future of the host evaluation, and ``base_told`` — how many
    tells the base state had absorbed when this ask sampled from it. A
    tell admitted after further tells landed is stale by the difference."""

    __slots__ = ("g", "ctx", "fut", "base_told")

    def __init__(self, g: int, ctx: Any, fut: Future, base_told: int):
        self.g = g
        self.ctx = ctx
        self.fut = fut
        self.base_told = base_told


def _is_seed_path(path: str) -> bool:
    return _SEED_PATH.search(path) is not None


def _seed_leaves(algo: Any) -> Dict[str, int]:
    """path -> value of every seed leaf of an algorithm state."""
    return {path: leaf for path, leaf in named_leaves(algo) if _is_seed_path(path)}


def _ask_artifacts(pre_algo: Any, post_algo: Any) -> Set[str]:
    """The paths of the algorithm-state leaves ``ask`` writes: compared
    leaf by leaf between the state before and after one probe ask (unequal
    leaves, NaN equal to NaN), plus every seed leaf, which always follows
    the ask. The tensor comparisons are read back in one host read."""
    pre = dict(named_leaves(pre_algo))
    artifacts: Set[str] = set()
    pending: List[Tuple[str, torch.Tensor]] = []
    for path, b in named_leaves(post_algo):
        a = pre.get(path)
        if _is_seed_path(path):
            artifacts.add(path)
        elif isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
                artifacts.add(path)
            else:
                same = a == b
                if a.is_floating_point():
                    same = same | (torch.isnan(a) & torch.isnan(b))
                pending.append((path, same.all()))
        elif isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor) or not (
                a == b or (a != a and b != b)):
            artifacts.add(path)
    if pending:
        flags = torch.stack([f.to(pending[0][1].device) for _, f in pending]).cpu().tolist()
        artifacts.update(path for (path, _), same in zip(pending, flags) if not same)
    return artifacts


def _graft(base: Any, ask: Any, artifacts: Set[str]) -> Any:
    """``base`` with the leaves at ``artifacts`` taken from ``ask``."""
    return _replace_leaves(base, {path: leaf for path, leaf in named_leaves(ask)
                                  if path in artifacts})


def _rekey(algo: Any, entry_seeds: Dict[str, int], g: int) -> Any:
    """Fresh deterministic seeds for an ask issued while earlier tells are
    pending (two asks from one told state would otherwise draw alike):
    each seed leaf becomes ``fold_in_seed(entry_seed, g)``."""
    from ..utils.common import fold_in_seed

    return _replace_leaves(algo, {path: fold_in_seed(seed, g) for path, seed in entry_seeds.items()})


def _replace_leaves(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """``tree`` with the leaves at the paths of ``values`` (``named_leaves``
    form; static fields untouched) replaced by those values."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _replace_leaves(getattr(tree, f.name), values, f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree) if not f.metadata.get("static", False)})
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, values, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_leaves(v, values, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return values.get(prefix, tree)


class GenerationExecutor:
    """The generation loop (the module docstring has the design). One
    instance may drive many runs; counters and spans accumulate and
    :meth:`report` sums them up.

    Args:
        max_staleness: default tell-staleness bound ``K`` of
            :meth:`run_host` (a run may override it). ``0`` is a
            ``wf.step`` loop's order; ``K > 0`` keeps up to ``K+1`` host
            evaluations in flight and admits each tell at a lag of at most
            ``K`` tells (needs an algorithm state with a seed, no
            ``dtype_policy``, no ``donate_carries`` and no ask-side monitor
            hooks; the host ``evaluate`` must take concurrent calls).
        io_inflight: bound on in-flight background tasks per lane.
        fetch_monitors_every: every N generations of :meth:`run_host`, copy
            ``state.monitors`` to the host on the fetch lane and keep the
            newest copy in ``last_monitor_fetch``.
        metrics: a :class:`~evox_tpu_torch.workflows.flightrec.
            FlightRecorder` (or anything with its ``count``/``set``/
            ``observe``/``event``); ``None`` records nothing.
    """

    def __init__(
        self,
        max_staleness: int = 0,
        io_inflight: int = 4,
        supervisor: Any = None,
        pod_supervisor: Any = None,
        fetch_monitors_every: Optional[int] = None,
        metrics: Any = None,
    ):
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if io_inflight < 1:
            raise ValueError(f"io_inflight must be >= 1, got {io_inflight}")
        if fetch_monitors_every is not None and fetch_monitors_every < 1:
            raise ValueError("fetch_monitors_every must be >= 1")
        self.max_staleness = int(max_staleness)
        self.io_inflight = int(io_inflight)
        self.fetch_monitors_every = fetch_monitors_every
        self.metrics = metrics
        self.supervisor = supervisor
        # the pod fault domain (core/pod_supervisor.py): every chunk of a
        # fused run under its collective deadline, each chunk ending in its
        # rendezvous; None leaves the loop as it was
        self.pod_supervisor = pod_supervisor
        self._clock = time.perf_counter
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "runs": 0,
            "chunks": 0,
            "generations": 0,
            "asks": 0,
            "tells": 0,
            "stale_tells": 0,
            "max_lag": 0,
            "bg_checkpoint": 0,
            "bg_hook": 0,
            "bg_fetch": 0,
            # surrogate refits dispatched between tells (refit_due/dispatch_refit)
            "bg_refit": 0,
            # the voted re-dispatch: extra dispatches, chunks whose digests
            # agreed, mismatches, and mismatches healed by the 2-of-3 vote;
            # verify_dispatches == verified_chunks + 2 * mismatches
            "verify_dispatches": 0,
            "verified_chunks": 0,
            "integrity_mismatches": 0,
            "integrity_healed": 0,
            # chunks dispatched through a supervisor's ladder
            "supervised_chunks": 0,
        }
        # the newest run's verify cadence (None: the rung never armed) and
        # the no-majority aborts
        self.integrity: Dict[str, Any] = {"verify_every": None, "aborts": 0}
        self.queue_stats: Dict[str, int] = {"io_inflight_limit": self.io_inflight,
                                            "io_inflight_max": 0, "stale_window_max": 0}
        # seconds: host time spent issuing the device halves (PyTorch
        # returns before the card finishes), host evaluation busy time
        # (summed over the evaluation threads, so it may exceed the wall at
        # K > 0), background I/O busy time, and the wall time of runs
        self.overlap: Dict[str, float] = {
            "device_dispatch_s": 0.0,
            "host_eval_s": 0.0,
            "io_s": 0.0,
            "wall_s": 0.0,
        }
        self.last_monitor_fetch: Optional[Tuple[int, Any]] = None
        # the largest per-run max_staleness driven: the report's bound
        # covers every run's admitted lag
        self._max_k_seen = 0
        self._trace_spans: List[dict] = []
        self._dropped_spans = 0
        self._counter_samples: Dict[str, List[Tuple[float, float]]] = {
            "executor/io_queue_depth": [],
            "executor/stale_lag": [],
        }
        self._named_lanes: Dict[str, _IoLane] = {}

    # ------------------------------------------------------------- recording
    def _span(self, track: str, name: str, t0: float, dt: float, **args) -> None:
        with self._lock:
            if len(self._trace_spans) >= _MAX_TRACE_SPANS:
                self._dropped_spans += 1
                return
            span = {"track": track, "name": name, "t_abs": t0, "dur": dt}
            if args:
                span["args"] = args
            self._trace_spans.append(span)

    def _sample(self, track: str, value: float) -> None:
        with self._lock:
            samples = self._counter_samples[track]
            if len(samples) < _MAX_COUNTER_SAMPLES:
                samples.append((self._clock(), float(value)))
        if self.metrics is not None:
            # metric names are dotted, trace tracks slash-separated
            self.metrics.set(track.replace("/", "."), float(value))

    def _timed_dispatch(self, name: str, fn: Callable[[], Any]) -> Any:
        t0 = self._clock()
        try:
            return fn()
        finally:
            dt = self._clock() - t0
            self.overlap["device_dispatch_s"] += dt
            self._span("device", name, t0, dt)
            if self.metrics is not None:
                self.metrics.count("executor.dispatches")
                self.metrics.observe("executor.dispatch_ms", dt * 1e3)

    # ---------------------------------------------------------------- report
    def report(self) -> dict:
        """Counters, queue high-water marks and the overlap accounting, as
        strict JSON. ``max_staleness`` is the effective bound (per-run
        overrides widen it); ``overlap_efficiency`` is wall / max(dispatch,
        host evaluation): 1.0 is full overlap."""
        device = self.overlap["device_dispatch_s"]
        host = self.overlap["host_eval_s"]
        wall = self.overlap["wall_s"]
        bound = max(device, host)
        out = {
            "max_staleness": max(self.max_staleness, self._max_k_seen),
            "counters": dict(self.counters),
            "queue": dict(self.queue_stats),
            "overlap": {
                "device_dispatch_s": round(device, 6),
                "host_eval_s": round(host, 6),
                "io_s": round(self.overlap["io_s"], 6),
                "wall_s": round(wall, 6),
                "overlap_efficiency": (
                    round(wall / bound, 4) if bound > 1e-9 and wall > 0 else None
                ),
            },
        }
        if self._dropped_spans:
            out["dropped_spans"] = self._dropped_spans
        return out

    def trace_spans(self) -> List[dict]:
        """Recorded spans (absolute ``clock`` timestamps): device dispatches,
        host evaluations and background I/O."""
        with self._lock:
            return list(self._trace_spans)

    def counter_samples(self) -> Dict[str, List[Tuple[float, float]]]:
        """(t_abs, value) samples per counter track (queue depth, stale lag)."""
        with self._lock:
            return {k: list(v) for k, v in self._counter_samples.items()}

    # ------------------------------------------------------------ fused runs
    def run_fused(
        self,
        wf: Any,
        state: Any,
        n_steps: int,
        checkpointer: Any = None,
        chunk: Optional[int] = None,
        resume_from: Any = None,
        supervisor: Any = None,
        pod_supervisor: Any = None,
        attest: Any = None,
        verify_every: Optional[int] = None,
    ) -> Any:
        """``wf.run(state, n)`` in chunks that end on the checkpoint cadence
        (or on ``chunk`` without a checkpointer), each snapshot written on
        the background checkpoint lane (drained before return). ``n_steps``
        counts remaining generations; ``resume_from`` makes it the total,
        as ``wf.run`` does.

        ``verify_every=K`` (with ``attest``, a :class:`~evox_tpu_torch.
        core.attest.StateAttestor`; one on the workflow's device is built
        if omitted): every K-th completed chunk is dispatched again from its
        entry state and the two results' digests compared. On a mismatch a
        third dispatch votes: the 2-of-3 majority proceeds, and no majority
        raises :class:`~evox_tpu_torch.core.attest.IntegrityError`.
        ``None`` (the default) adds no dispatch.

        ``supervisor`` (default the executor's own): every chunk dispatch
        runs under its ladder (module docstring); its checkpointer takes the
        place of a missing ``checkpointer``.

        ``pod_supervisor`` (default the executor's own, a
        :class:`~evox_tpu_torch.core.pod_supervisor.PodSupervisor`): every
        chunk runs under its collective deadline with the census-refined
        classification (:class:`~evox_tpu_torch.core.pod_supervisor.
        PodFailureError`, fatal to the ladder), each chunk ends in its
        :meth:`chunk_boundary`, and a coordinated drain finishes the chunk,
        writes a final barrier snapshot (off the cadence too), drains the
        lane and returns early. The workflow advertises it as
        ``_pod_supervisor`` (``run_report``, ``write_chrome_trace``)."""
        from ..workflows.checkpoint import chunk_to_boundary, enter_run

        supervisor = self.supervisor if supervisor is None else supervisor
        pod = self.pod_supervisor if pod_supervisor is None else pod_supervisor
        wf._run_executor = self
        if supervisor is not None:
            wf._run_supervisor = supervisor
        if pod is not None:
            wf._pod_supervisor = pod
        state, n_steps, ckpt = enter_run(state, n_steps, checkpointer, resume_from,
                                         expect_like=state, device=wf.device)
        if ckpt is None and supervisor is not None:
            ckpt = getattr(supervisor, "checkpointer", None)
        self.counters["runs"] += 1
        if verify_every is not None:
            if verify_every < 1:
                raise ValueError(f"verify_every must be >= 1, got {verify_every}")
            if attest is None:
                from .attest import StateAttestor

                attest = StateAttestor(device=wf.device)
            self.integrity["verify_every"] = int(verify_every)
        total = n_steps + int(state.generation)
        chunk_i = 0  # completed chunks of this run: the verify cadence
        budget = {"used": 0}  # restores are bounded a run, not a chunk
        lane = _IoLane("checkpoint", self.io_inflight)
        restore = self._restore_thunk(supervisor, ckpt, wf, state, lane)
        t_run0 = self._clock()
        try:
            while int(state.generation) < total:
                remaining = total - int(state.generation)
                step = min(remaining, chunk_to_boundary(state, ckpt, chunk))
                attempted = state
                run = lambda: wf.run(attempted, step)  # noqa: E731
                # innermost: the pod's watchdog classifies a hung collective
                # before the ladder sees it
                chunk_fn = run if pod is None else (lambda: pod.supervised(run, entry="run"))
                dispatch = lambda: self._timed_dispatch("run", chunk_fn)  # noqa: E731
                if supervisor is not None:
                    self.counters["supervised_chunks"] += 1
                    state = supervisor.call(dispatch, entry="run", restore=restore,
                                            restore_budget=budget)
                else:
                    state = dispatch()
                chunk_i += 1
                # only a chunk that ran to its end can be dispatched again: a
                # restore's result is an older snapshot
                if (attest is not None and verify_every is not None
                        and chunk_i % verify_every == 0
                        and int(state.generation) == int(attempted.generation) + step):
                    state = self._verify_chunk(wf, attempted, state, step, attest, pod=pod)
                self.counters["chunks"] += 1
                gen = int(state.generation)
                if gen <= int(attempted.generation):
                    continue  # the restore rung went back: replay from there
                self.counters["generations"] += gen - int(attempted.generation)
                # the pod's rendezvous comes before the snapshot: a drain
                # decided here forces a final (off-cadence) save below
                drain = pod is not None and pod.chunk_boundary(gen) == "drain"
                if ckpt is not None and (gen % ckpt.every == 0 or gen >= total or drain):
                    self._submit_checkpoint(lane, ckpt, state, pod=pod)
                if drain:
                    # the chunk in flight finished and its snapshot is on
                    # the lane: make every snapshot durable, record, return
                    lane.drain()
                    pod.note_drained(gen, checkpointed=ckpt is not None)
                    return state
            lane.drain()  # every snapshot durable before the run returns
            return state
        except BaseException:
            _drain_quietly(lane)
            raise
        finally:
            lane.close()
            self._account_lane(lane)
            self.overlap["wall_s"] += self._clock() - t_run0

    # ------------------------------------------------------- integrity rung
    def _verify_chunk(self, wf: Any, attempted: Any, state: Any, step: int, attest: Any,
                      pod: Any = None) -> Any:
        """Dispatch the chunk again from its entry state and compare the
        digests; on a mismatch a third dispatch votes 2 of 3 (the dissent
        noted against the pod, ``integrity_dissent``, when a pod supervisor
        runs the chunk). No majority raises :class:`IntegrityError`: three
        disagreeing results leave nothing to continue from."""

        def again() -> Any:
            run = lambda: wf.run(attempted, step)  # noqa: E731
            fn = run if pod is None else (lambda: pod.supervised(run, entry="run:verify"))
            return self._timed_dispatch("run:verify", fn)

        def words(*states: Any) -> List[Tuple[int, ...]]:
            rows = torch.stack([attest.digest(s) for s in states]).cpu().tolist()
            return [tuple(r) for r in rows]

        gen = int(state.generation)
        self.counters["verify_dispatches"] += 1
        redo = again()
        d0, d1 = words(state, redo)
        if d0 == d1:
            self.counters["verified_chunks"] += 1
            return state
        self.counters["integrity_mismatches"] += 1
        if self.metrics is not None:
            self.metrics.count("executor.integrity_mismatches")
            self.metrics.event("integrity.mismatch", entry="run", generation=gen)
        self.counters["verify_dispatches"] += 1
        third = again()
        (d2,) = words(third)
        if d2 == d1:
            winner, dissent = redo, "first"
        elif d2 == d0:
            winner, dissent = state, "redo"
        else:
            self.integrity["aborts"] += 1
            raise IntegrityError(
                f"no 2-of-3 majority at generation {gen}: three dispatches of the "
                f"same chunk produced three distinct digests — nothing trustworthy "
                f"to continue from",
                generation=gen,
                where="run:verify",
            )
        self.counters["integrity_healed"] += 1
        if self.metrics is not None:
            self.metrics.count("executor.integrity_healed")
            self.metrics.event("integrity.heal", entry="run", generation=gen, dissent=dissent)
        if pod is not None:
            pod.note_integrity_dissent(generation=gen, entry="run", dissent=dissent)
        return winner

    def integrity_counters(self) -> Optional[Dict[str, Any]]:
        """The executor's part of ``run_report``'s ``integrity`` section
        (``None`` when the verify rung never armed)."""
        if self.integrity["verify_every"] is None:
            return None
        return {
            "verify_every": self.integrity["verify_every"],
            "redispatches": self.counters["verify_dispatches"],
            "verified_chunks": self.counters["verified_chunks"],
            "mismatches": self.counters["integrity_mismatches"],
            "healed": self.counters["integrity_healed"],
            "aborted": self.integrity["aborts"],
        }

    # ------------------------------------------------------------ host runs
    def run_host(
        self,
        wf: Any,
        state: Any,
        n_steps: int,
        on_generation: Optional[Callable[[int, Any, Any], None]] = None,
        checkpointer: Any = None,
        resume_from: Any = None,
        eval_chunk: Optional[int] = None,
        max_staleness: Optional[int] = None,
        supervisor: Any = None,
        chunk: Optional[int] = None,
    ) -> Any:
        """The host-evaluation loop (external problems): generation ``k``'s
        device halves and host ``evaluate`` while the previous generation's
        ``on_generation`` runs on the hook lane. At ``max_staleness=0``
        (``None``: the executor's own bound) the states equal a
        ``wf.step`` loop's bit for bit; ``K > 0`` runs stale tells (the
        module docstring). With a ``supervisor`` (default the executor's
        own) or a ``chunk``, the loop runs in segments that end on the
        checkpoint cadence (or every ``chunk`` generations), each segment
        under the supervisor's ladder with the OOM degrade rung halving
        ``eval_chunk`` (floored at ``supervisor.min_eval_chunk``)."""
        from ..workflows.checkpoint import chunk_to_boundary, enter_run

        if not getattr(wf, "external", False):
            raise ValueError(
                "run_host is for external (host) problems; jittable problems "
                "should use run_fused / wf.run"
            )
        supervisor = self.supervisor if supervisor is None else supervisor
        K = self.max_staleness if max_staleness is None else int(max_staleness)
        if K < 0:
            raise ValueError(f"max_staleness must be >= 0, got {K}")
        self._max_k_seen = max(self._max_k_seen, K)
        if K > 0:
            self._check_stale_support(wf)
            if not _seed_leaves(state.algo):
                raise ValueError(
                    "max_staleness > 0 needs an algorithm state with a seed leaf "
                    "(the fresh ask seeds fold from it); "
                    f"{type(state.algo).__name__} has none"
                )
        wf._run_executor = self
        if supervisor is not None:
            wf._run_supervisor = supervisor
        state, n_steps, ckpt = enter_run(state, n_steps, checkpointer, resume_from,
                                         expect_like=state, device=wf.device)
        if ckpt is None and supervisor is not None:
            ckpt = getattr(supervisor, "checkpointer", None)
        if n_steps <= 0:
            return state
        self.counters["runs"] += 1
        t_run0 = self._clock()
        try:
            if supervisor is None and chunk is None:
                state = self._pipeline_segment(wf, state, n_steps, on_generation, ckpt,
                                               eval_chunk, K)
                self.counters["chunks"] += 1
                return state
            # segments under the ladder; the degrade rung changes the
            # evaluation chunk the next attempt reads
            total = n_steps + int(state.generation)
            cell = {"eval_chunk": eval_chunk}
            degrade = self._degrade_thunk(supervisor, wf, cell) if supervisor is not None else None
            budget = {"used": 0}
            restore = self._restore_thunk(supervisor, ckpt, wf, state, None)
            while int(state.generation) < total:
                step = min(total - int(state.generation), chunk_to_boundary(state, ckpt, chunk))
                attempted = state
                segment = lambda: self._pipeline_segment(  # noqa: E731
                    wf, attempted, step, on_generation, ckpt, cell["eval_chunk"], K)
                if supervisor is not None:
                    self.counters["supervised_chunks"] += 1
                    state = supervisor.call(segment, entry="pipelined", restore=restore,
                                            degrade=degrade, restore_budget=budget)
                else:
                    state = segment()
                self.counters["chunks"] += 1
            return state
        finally:
            self.overlap["wall_s"] += self._clock() - t_run0

    def _degrade_thunk(self, supervisor: Any, wf: Any, cell: dict) -> Callable[[], bool]:
        """The OOM degrade rung: halve the host evaluation chunk (the whole
        population when none is set), floored at the supervisor's
        ``min_eval_chunk``; False when it cannot halve further."""
        floor = max(1, int(getattr(supervisor, "min_eval_chunk", 1)))

        def degrade() -> bool:
            cur = cell["eval_chunk"]
            if cur is None:
                pop = getattr(getattr(wf, "algorithm", None), "pop_size", None)
                if pop is None:
                    return False
                nxt = max(int(pop) // 2, floor)
            elif cur <= floor:
                return False
            else:
                nxt = max(cur // 2, floor)
            if nxt == cur:
                return False
            cell["eval_chunk"] = nxt
            return True

        return degrade

    def _restore_thunk(self, supervisor: Any, ckpt: Any, wf: Any, expect_like: Any,
                       lane: Optional[_IoLane]) -> Optional[Callable[[], Any]]:
        """The supervisor's replay rung, with the run's in-flight snapshots
        drained first, so a restore never reads a half-landed save."""
        if supervisor is None or ckpt is None:
            return None
        restorer = getattr(supervisor, "_restorer", None)
        inner = restorer(ckpt, wf, expect_like) if restorer is not None else None
        if inner is None:
            return None

        def restore() -> Any:
            if lane is not None:
                _drain_quietly(lane)
            return inner()

        return restore

    def _check_stale_support(self, wf: Any) -> None:
        if getattr(wf, "dtype_policy", None) is not None:
            raise ValueError(
                "max_staleness > 0 cannot compose with a dtype_policy: the "
                "stale-tell graft splices storage- and compute-dtype state "
                "branches; run stale tells at full precision"
            )
        if getattr(wf, "donate_carries", False):
            raise ValueError(
                "max_staleness > 0 cannot compose with donate_carries: a donated "
                "tell's ctx would alias the base state's buffers, which stale "
                "tells keep reusing"
            )
        table = getattr(wf, "_hook_table", None)
        if table is not None:
            ask_side = [n for n in _ASK_SIDE_HOOKS if table.get(n)]
            if ask_side:
                raise ValueError(
                    "max_staleness > 0 skips ask-side monitor hooks "
                    f"({ask_side} are implemented by attached monitors): stale "
                    "tells chain monitor state through tells only. Use tell-side "
                    "monitors (TelemetryMonitor) with stale runs."
                )

    def _pipeline_segment(
        self,
        wf: Any,
        state: Any,
        n_steps: int,
        on_generation: Optional[Callable],
        checkpointer: Any,
        eval_chunk: Optional[int],
        K: int,
    ) -> Any:
        """One uninterrupted stretch of ``n_steps`` generations. ``K = 0``:
        ask, the host evaluation on the calling thread, tell, in
        ``wf.step``'s order. ``K > 0``: up to ``K+1`` evaluations in flight
        on worker threads, and stale tells grafted with their own ask's
        artifacts. The hook of generation ``g`` runs while later
        generations are asked and evaluated; its error surfaces before the
        next tell."""
        from ..workflows.pipelined import chunked_evaluate

        gen0 = int(state.generation)
        eval_pool = (ThreadPoolExecutor(max_workers=K + 1, thread_name_prefix="executor-eval")
                     if K > 0 else None)
        ckpt_lane = _IoLane("checkpoint", self.io_inflight)
        hook_lane = _IoLane("hook", self.io_inflight)
        fetch_lane = _IoLane("fetch", self.io_inflight)
        hook_fut: Optional[Future] = None
        link = wf.host_link
        # stale bookkeeping: the entry seeds make the fresh ask seeds; the
        # artifact set is probed at the first steady ask (a first-step ask
        # may write other leaves)
        entry_seeds = _seed_leaves(state.algo) if K > 0 else {}
        artifacts: Optional[Set[str]] = None
        pending: deque = deque()
        asked = told = 0
        base = state
        # a SurrogateWorkflow's hooks (duck-typed): host_evaluate evaluates
        # only the screened rows (on the calling thread: it reads the card);
        # refit_due/dispatch_refit refit the model after a tell
        host_eval = getattr(wf, "host_evaluate", None)
        refit_due = getattr(wf, "refit_due", None)
        dispatch_refit = getattr(wf, "dispatch_refit", None)

        def evaluate(cand, pstate, ready=None):
            if ready is not None:
                ready.synchronize()
            t0 = self._clock()
            try:
                if host_eval is not None:
                    return host_eval(pstate, cand, eval_chunk)
                return chunked_evaluate(wf.problem, pstate, cand, eval_chunk)
            finally:
                dt = self._clock() - t0
                with self._lock:
                    self.overlap["host_eval_s"] += dt
                self._span("host_eval", "evaluate", t0, dt)

        def submit_eval(cand, pstate) -> Future:
            if host_eval is not None:
                fut: Future = Future()
                fut.set_result(evaluate(cand, pstate))
                return fut
            host, ready = link.to_host(cand)
            if eval_pool is None:
                fut = Future()
                fut.set_result(evaluate(host, pstate, ready))
                return fut
            return eval_pool.submit(evaluate, host, pstate, ready)

        try:
            while told < n_steps:
                # ------------------------------------------------ issue asks
                while asked < n_steps and asked - told <= K:
                    ask_state = base
                    if pending:
                        # an ask with tells still pending must not draw as
                        # the base state's ask would: fresh seeds
                        ask_state = base.replace(
                            algo=_rekey(base.algo, entry_seeds, gen0 + asked))
                    probe = K > 0 and artifacts is None and not ask_state.first_step
                    cand, ctx = self._timed_dispatch("pipeline_ask",
                                                     lambda: wf.pipeline_ask(ask_state))
                    if probe:
                        artifacts = _ask_artifacts(ask_state.algo, ctx[0])
                    self.counters["asks"] += 1
                    pending.append(_InflightEval(asked, ctx, submit_eval(cand, base.prob), told))
                    asked += 1
                    self.queue_stats["stale_window_max"] = max(
                        self.queue_stats["stale_window_max"], len(pending))
                    if K > 0 and artifacts is None:
                        break  # hold the window at one until the steady artifacts are known
                # ------------------------------------------------ admit a tell
                ev = pending.popleft()
                fitness, _ = ev.fut.result()
                if hook_fut is not None:
                    hook_fut.result()  # the hook's error surfaces before the tell
                    hook_fut = None
                # staleness in tells: updates that landed after this
                # generation's candidates were drawn
                lag = told - ev.base_told
                self._sample("executor/stale_lag", lag)
                if lag > 0:
                    self.counters["stale_tells"] += 1
                    self.counters["max_lag"] = max(self.counters["max_lag"], lag)
                    # the tell's own ask artifacts on the newest told state,
                    # with the newest monitor chain
                    hybrid = _graft(base.algo, ev.ctx[0], artifacts)
                    ctx = (hybrid, tuple(base.monitors), ev.ctx[2])
                else:
                    ctx = ev.ctx
                told_state = base
                base = self._timed_dispatch(
                    "pipeline_tell",
                    lambda: wf.pipeline_tell(told_state, ctx, fitness, told_state.prob))
                told += 1
                self.counters["tells"] += 1
                self.counters["generations"] += 1
                if refit_due is not None and dispatch_refit is not None and refit_due(gen0 + told):
                    # before the snapshot: a checkpoint at this generation
                    # holds the refit, so a resumed run keeps the schedule
                    self.counters["bg_refit"] += 1
                    refit_from = base
                    base = self._timed_dispatch("surrogate_refit",
                                                lambda: dispatch_refit(refit_from, gen0 + told))
                if checkpointer is not None and int(base.generation) % checkpointer.every == 0:
                    self._submit_checkpoint(ckpt_lane, checkpointer, base)
                if on_generation is not None:
                    self.counters["bg_hook"] += 1
                    snapshot, fit_snapshot, g_abs = base, fitness, gen0 + ev.g
                    hook_fut = hook_lane.submit(
                        lambda: on_generation(g_abs, snapshot, fit_snapshot))
                if (self.fetch_monitors_every and told % self.fetch_monitors_every == 0
                        and getattr(base, "monitors", None)):
                    self._submit_monitor_fetch(fetch_lane, base)
            if hook_fut is not None:
                hook_fut.result()
            hook_lane.drain()
            if checkpointer is not None and int(base.generation) % checkpointer.every != 0:
                self._submit_checkpoint(ckpt_lane, checkpointer, base)
            ckpt_lane.drain()
            fetch_lane.drain()
            return base
        except BaseException:
            _drain_quietly(ckpt_lane)
            raise
        finally:
            if eval_pool is not None:
                eval_pool.shutdown(wait=True)  # no worker outlives the run
            for lane in (ckpt_lane, hook_lane, fetch_lane):
                lane.close()
                self._account_lane(lane)

    # ------------------------------------------------------- background lanes
    def background_lane(self, name: str) -> _IoLane:
        """A persistent ordered background lane owned by this executor
        (created on first use, one worker thread, bounded in-flight)."""
        lane = self._named_lanes.get(name)
        if lane is None:
            lane = self._named_lanes[name] = _IoLane(name, self.io_inflight)
        return lane

    def submit_background(self, name: str, fn: Callable[[], Any], counter: str = "bg_task") -> None:
        """Submit ``fn`` to the named persistent lane, counting it under
        ``counter`` and recording a span. ``fn`` must not touch the card."""
        lane = self.background_lane(name)
        self.counters[counter] = self.counters.get(counter, 0) + 1
        t0 = self._clock()

        def task():
            try:
                return fn()
            finally:
                self._span(f"io:{name}", counter, t0, self._clock() - t0)

        lane.submit(task)
        self._sample("executor/io_queue_depth", lane.depth())

    def drain_lane(self, name: str) -> None:
        """Join every pending task of a named lane (no-op for a name never
        used), re-raising the first error."""
        lane = self._named_lanes.get(name)
        if lane is not None:
            lane.drain()
            self._account_lane(lane)
            lane.busy_s = 0.0

    def close(self) -> None:
        """Drain every named lane (a failed write still surfaces), then shut
        their threads down. Idempotent; lanes are made again if used."""
        first_err: Optional[BaseException] = None
        for name, lane in list(self._named_lanes.items()):
            try:
                self.drain_lane(name)
            except Exception as e:  # keep closing the rest, raise the first
                if first_err is None:
                    first_err = e
            lane.close()
        self._named_lanes = {}
        if first_err is not None:
            raise first_err

    def _submit_checkpoint(self, lane: _IoLane, ckpt: Any, state: Any, pod: Any = None) -> None:
        """Copy ``state`` to the host without blocking, then pickle and
        fsync it on ``lane`` once the copy has landed. In a process group
        the save (which ends in a commit barrier) runs on the calling
        thread, in lockstep with the other processes, and under a pod
        supervisor as a supervised point with its checkpoint deadline."""
        from ..workflows.checkpoint import _device_name
        from .distributed import process_count

        self.counters["bg_checkpoint"] += 1
        t0 = self._clock()
        if process_count() > 1:
            if pod is not None:
                pod.supervised(lambda: ckpt.save(state), entry="checkpoint",
                               deadline_s=pod.checkpoint_deadline_s)
            else:
                ckpt.save(state)
            self._span("io:checkpoint", "save", t0, self._clock() - t0,
                       generation=int(state.generation))
            return
        host, ready = host_copy_async(state)
        device = _device_name(state)

        def save():
            if ready is not None:
                ready.synchronize()
            ckpt.write(host, device)
            self._span("io:checkpoint", "save", t0, self._clock() - t0,
                       generation=int(host.generation))

        lane.submit(save)
        self._sample("executor/io_queue_depth", lane.depth())

    def _submit_monitor_fetch(self, lane: _IoLane, state: Any) -> None:
        self.counters["bg_fetch"] += 1
        gen = int(state.generation)
        host, ready = host_copy_async(state.monitors)

        def fetch():
            t0 = self._clock()
            if ready is not None:
                ready.synchronize()
            self.last_monitor_fetch = (gen, host)
            dt = self._clock() - t0
            self._span("io:fetch", "monitors", t0, dt, generation=gen)
            if self.metrics is not None:
                self.metrics.count("executor.monitor_fetches")
                self.metrics.observe("executor.monitor_fetch_ms", dt * 1e3)
                self.metrics.set("executor.monitor_fetch_gen", gen)

        lane.submit(fetch)
        self._sample("executor/io_queue_depth", lane.depth())

    def _account_lane(self, lane: _IoLane) -> None:
        self.overlap["io_s"] += lane.busy_s
        self.queue_stats["io_inflight_max"] = max(self.queue_stats["io_inflight_max"],
                                                  lane.high_water)


def _drain_quietly(lane: _IoLane) -> None:
    """Flush what a failing run can, without masking its error."""
    try:
        lane.drain()
    except Exception:  # the run's own error is the one raised
        pass
