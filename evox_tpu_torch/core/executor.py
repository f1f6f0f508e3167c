"""GenerationExecutor — the port of ``evox_tpu/core/executor.py``: the one
generation loop behind ``checkpointed_run`` and ``run_host_pipelined``.

- **Fused runs** (:meth:`GenerationExecutor.run_fused`): ``wf.run`` in
  chunks that end on the checkpoint cadence; each snapshot is copied to
  the host without blocking and pickled and fsynced on a background
  checkpoint lane while the next chunk runs. The chunks change no
  arithmetic, so the final state is the unchunked run's.
- **Host problems** (:meth:`GenerationExecutor.run_host`): each
  generation's candidates go to the host (``wf.host_link``, pinned
  buffers and a CUDA event), the host ``evaluate`` runs on the calling
  thread, and ``on_generation`` hooks, checkpoint writes and monitor
  fetches run on background lanes, so the user's per-generation host work
  overlaps the next generation. A workflow's ``host_evaluate`` hook, where
  it has one, takes the evaluation (with the candidates still on the
  card), and ``refit_due``/``dispatch_refit`` refit a surrogate after a
  tell (``workflows/surrogate.py``). The dispatch, tell and hook order is
  ``wf.step``'s, so the states are a ``wf.step`` loop's bit for bit. At
  ``max_staleness=0`` the tell needs the evaluation's fitness, so nothing
  of the device could overlap the evaluation and it gets no thread of its
  own; stale tells, which would overlap them, wait (ROADMAP A5).
- **Background I/O lanes**: one worker thread each (work lands in
  submission order) with a bounded in-flight queue; ``submit`` waits on
  the oldest task when the lane is full, and a task's error is raised at
  the next ``submit`` or ``drain``. The checkpoint lane is drained before
  a run returns.

Every CUDA call stays on the calling thread: the lanes' worker threads
see numpy and host tensors, and wait only on CUDA events the calling
thread recorded after the copies they read.

The JAX package's stale tells (``max_staleness > 0``) wait for ROADMAP
A5, its supervisor and pod supervisor for A11, and its voted re-dispatch
(``attest``, ``verify_every``) for A12: each raises
``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from .state_io import host_copy_async

__all__ = ["GenerationExecutor"]

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


class GenerationExecutor:
    """The generation loop (the module docstring has the design). One
    instance may drive many runs; counters and spans accumulate and
    :meth:`report` sums them up.

    Args:
        max_staleness: only ``0`` (a ``wf.step`` loop's order) is ported.
        io_inflight: bound on in-flight background tasks per lane.
        fetch_monitors_every: every N generations of :meth:`run_host`, copy
            ``state.monitors`` to the host on the fetch lane and keep the
            newest copy in ``last_monitor_fetch``.
    """

    def __init__(
        self,
        max_staleness: int = 0,
        io_inflight: int = 4,
        supervisor: Any = None,
        pod_supervisor: Any = None,
        fetch_monitors_every: Optional[int] = None,
    ):
        from ..workflows.common import refuse_deferred

        _refuse_stale(max_staleness)
        refuse_deferred("GenerationExecutor", supervisor=supervisor,
                        pod_supervisor=pod_supervisor)
        if io_inflight < 1:
            raise ValueError(f"io_inflight must be >= 1, got {io_inflight}")
        if fetch_monitors_every is not None and fetch_monitors_every < 1:
            raise ValueError("fetch_monitors_every must be >= 1")
        self.max_staleness = 0
        self.io_inflight = int(io_inflight)
        self.fetch_monitors_every = fetch_monitors_every
        self._clock = time.perf_counter
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "runs": 0,
            "chunks": 0,
            "generations": 0,
            "asks": 0,
            "tells": 0,
            # stale tells and their lag stay 0: only max_staleness 0 is
            # ported (the JAX package's report carries them)
            "stale_tells": 0,
            "max_lag": 0,
            "bg_checkpoint": 0,
            "bg_hook": 0,
            "bg_fetch": 0,
            # surrogate refits dispatched between tells (refit_due/dispatch_refit)
            "bg_refit": 0,
        }
        self.queue_stats: Dict[str, int] = {"io_inflight_limit": self.io_inflight,
                                            "io_inflight_max": 0, "stale_window_max": 0}
        # seconds: host time spent issuing the device halves (PyTorch
        # returns before the card finishes), host evaluation busy time,
        # background I/O busy time, and the wall time of executor runs
        self.overlap: Dict[str, float] = {
            "device_dispatch_s": 0.0,
            "host_eval_s": 0.0,
            "io_s": 0.0,
            "wall_s": 0.0,
        }
        self.last_monitor_fetch: Optional[Tuple[int, Any]] = None
        self._trace_spans: List[dict] = []
        self._dropped_spans = 0
        self._counter_samples: Dict[str, List[Tuple[float, float]]] = {
            "executor/io_queue_depth": [],
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

    def _timed_dispatch(self, name: str, fn: Callable[[], Any]) -> Any:
        t0 = self._clock()
        try:
            return fn()
        finally:
            dt = self._clock() - t0
            self.overlap["device_dispatch_s"] += dt
            self._span("device", name, t0, dt)

    # ---------------------------------------------------------------- report
    def report(self) -> dict:
        """Counters, queue high-water marks and the overlap accounting, as
        strict JSON. ``overlap_efficiency`` is wall / max(dispatch, host
        evaluation): 1.0 is full overlap."""
        device = self.overlap["device_dispatch_s"]
        host = self.overlap["host_eval_s"]
        wall = self.overlap["wall_s"]
        bound = max(device, host)
        out = {
            "max_staleness": self.max_staleness,
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
        """(t_abs, value) samples per counter track (queue depth)."""
        with self._lock:
            return {k: list(v) for k, v in self._counter_samples.items()}

    # ------------------------------------------------------------ fused runs
    def run_fused(
        self,
        wf: Any,
        state: Any,
        n_steps: int,
        checkpointer: Any = None,
        resume_from: Any = None,
        supervisor: Any = None,
        pod_supervisor: Any = None,
        attest: Any = None,
        verify_every: Optional[int] = None,
    ) -> Any:
        """``wf.run(state, n)`` in chunks that end on the checkpoint
        cadence, each snapshot written on the background checkpoint lane
        (drained before return). ``n_steps`` counts remaining generations;
        ``resume_from`` makes it the total, as ``wf.run`` does."""
        from ..workflows.checkpoint import chunk_to_boundary, enter_run
        from ..workflows.common import refuse_deferred

        refuse_deferred("GenerationExecutor.run_fused", supervisor=supervisor,
                        pod_supervisor=pod_supervisor)
        refuse_deferred("GenerationExecutor.run_fused", item="A12", attest=attest,
                        verify_every=verify_every)
        wf._run_executor = self
        state, n_steps, ckpt = enter_run(state, n_steps, checkpointer, resume_from,
                                         expect_like=state, device=wf.device)
        self.counters["runs"] += 1
        total = n_steps + int(state.generation)
        lane = _IoLane("checkpoint", self.io_inflight)
        t_run0 = self._clock()
        try:
            while int(state.generation) < total:
                remaining = total - int(state.generation)
                step = min(remaining, chunk_to_boundary(state, ckpt))
                attempted = state
                state = self._timed_dispatch("run", lambda: wf.run(attempted, step))
                self.counters["chunks"] += 1
                gen = int(state.generation)
                self.counters["generations"] += gen - int(attempted.generation)
                if ckpt is not None and (gen % ckpt.every == 0 or gen >= total):
                    self._submit_checkpoint(lane, ckpt, state)
            lane.drain()  # every snapshot durable before the run returns
            return state
        except BaseException:
            _drain_quietly(lane)
            raise
        finally:
            lane.close()
            self._account_lane(lane)
            self.overlap["wall_s"] += self._clock() - t_run0

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
    ) -> Any:
        """The host-evaluation loop (external problems): generation ``k``'s
        device halves and host ``evaluate`` run on the calling thread while
        the previous generation's ``on_generation`` runs on the hook lane.
        States equal a ``wf.step`` loop's bit for bit."""
        from ..workflows.checkpoint import enter_run
        from ..workflows.common import refuse_deferred

        if not getattr(wf, "external", False):
            raise ValueError(
                "run_host is for external (host) problems; jittable problems "
                "should use run_fused / wf.run"
            )
        _refuse_stale(max_staleness or 0)
        refuse_deferred("GenerationExecutor.run_host", supervisor=supervisor)
        wf._run_executor = self
        state, n_steps, ckpt = enter_run(state, n_steps, checkpointer, resume_from,
                                         expect_like=state, device=wf.device)
        if n_steps <= 0:
            return state
        self.counters["runs"] += 1
        t_run0 = self._clock()
        try:
            state = self._pipeline_segment(wf, state, n_steps, on_generation, ckpt, eval_chunk)
            self.counters["chunks"] += 1
            return state
        finally:
            self.overlap["wall_s"] += self._clock() - t_run0

    def _pipeline_segment(
        self,
        wf: Any,
        state: Any,
        n_steps: int,
        on_generation: Optional[Callable],
        checkpointer: Any,
        eval_chunk: Optional[int],
    ) -> Any:
        """One uninterrupted stretch of ``n_steps`` generations: ask, the
        host evaluation, tell, in ``wf.step``'s order; the hook of
        generation ``g`` runs while generation ``g+1`` is asked and
        evaluated, and its error surfaces before tell ``g+1``."""
        from ..workflows.common import host_candidates
        from ..workflows.pipelined import chunked_evaluate

        gen0 = int(state.generation)
        ckpt_lane = _IoLane("checkpoint", self.io_inflight)
        hook_lane = _IoLane("hook", self.io_inflight)
        fetch_lane = _IoLane("fetch", self.io_inflight)
        hook_fut: Optional[Future] = None
        link = wf.host_link
        base = state
        # a SurrogateWorkflow's hooks (duck-typed): host_evaluate evaluates
        # only the screened rows; refit_due/dispatch_refit refit the model
        # after a tell, queued on the card's stream without a wait, so the
        # model an ask reads lags the archive by at most the refit cadence
        host_eval = getattr(wf, "host_evaluate", None)
        refit_due = getattr(wf, "refit_due", None)
        dispatch_refit = getattr(wf, "dispatch_refit", None)

        def run_eval(cand, pstate):
            if host_eval is None:
                cand = host_candidates(link, cand)
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

        try:
            for g in range(n_steps):
                asked = base
                cand, ctx = self._timed_dispatch("pipeline_ask", lambda: wf.pipeline_ask(asked))
                self.counters["asks"] += 1
                fitness, _ = run_eval(cand, asked.prob)
                if hook_fut is not None:
                    hook_fut.result()  # the hook's error surfaces before the tell
                    hook_fut = None
                base = self._timed_dispatch(
                    "pipeline_tell", lambda: wf.pipeline_tell(asked, ctx, fitness, asked.prob)
                )
                self.counters["tells"] += 1
                self.counters["generations"] += 1
                if refit_due is not None and dispatch_refit is not None and refit_due(gen0 + g + 1):
                    # before the snapshot: a checkpoint at this generation
                    # holds the refit, so a resumed run keeps the schedule
                    self.counters["bg_refit"] += 1
                    told = base
                    base = self._timed_dispatch("surrogate_refit",
                                                lambda: dispatch_refit(told, gen0 + g + 1))
                if checkpointer is not None and int(base.generation) % checkpointer.every == 0:
                    self._submit_checkpoint(ckpt_lane, checkpointer, base)
                if on_generation is not None:
                    self.counters["bg_hook"] += 1
                    snapshot, fit_snapshot, g_abs = base, fitness, gen0 + g
                    hook_fut = hook_lane.submit(
                        lambda: on_generation(g_abs, snapshot, fit_snapshot)
                    )
                if (self.fetch_monitors_every and (g + 1) % self.fetch_monitors_every == 0
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

    def _submit_checkpoint(self, lane: _IoLane, ckpt: Any, state: Any) -> None:
        """Copy ``state`` to the host without blocking, then pickle and
        fsync it on ``lane`` once the copy has landed."""
        from ..workflows.checkpoint import _device_name

        self.counters["bg_checkpoint"] += 1
        t0 = self._clock()
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
            self._span("io:fetch", "monitors", t0, self._clock() - t0, generation=gen)

        lane.submit(fetch)
        self._sample("executor/io_queue_depth", lane.depth())

    def _account_lane(self, lane: _IoLane) -> None:
        self.overlap["io_s"] += lane.busy_s
        self.queue_stats["io_inflight_max"] = max(self.queue_stats["io_inflight_max"],
                                                  lane.high_water)


def _refuse_stale(max_staleness: int) -> None:
    if max_staleness < 0:
        raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
    if max_staleness > 0:
        raise NotImplementedError(
            "GenerationExecutor(max_staleness > 0): stale tells are not ported yet (ROADMAP A5)"
        )


def _drain_quietly(lane: _IoLane) -> None:
    """Flush what a failing run can, without masking its error."""
    try:
        lane.drain()
    except Exception:  # the run's own error is the one raised
        pass
