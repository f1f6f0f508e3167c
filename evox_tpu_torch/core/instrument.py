"""Host-side instrumentation of a workflow's entry points — the port of
``evox_tpu/core/instrument.py``.

The device half of observability (``TelemetryMonitor``) lives in the
monitor state on the card; this module is the host half. It wraps a
workflow's entry points (``init`` / ``step`` / ``run`` / ``pipeline_ask`` /
``pipeline_tell``) with wall-clock timing around each call.

Semantics under CUDA's asynchronous launches: a warm call returns once its
work is queued, so its duration is the host's enqueue time (the eager
operators' launches, host reads, Python). ``block_dispatch=True`` waits
for the call's work on the card inside the timed region (a stream
synchronize after the call), so a call's time then covers the card's work
too: roofline rates need that. The first call of an entry is reported
apart (``first_call_s``, and ``compile_s``, the first call less the steady
median: eager PyTorch compiles nothing, but a first call still pays the
caching allocator's growth, library handles and lazy module loads). Host
reads go through :meth:`DispatchRecorder.fetch`, which counts bytes and
seconds by fetch site.

- **Work-normalised timing**: each call carries a work count (``run``'s
  ``n_steps``, 1 elsewhere). An entry called at two work counts gets the
  differenced slope ``(t(n2) - t(n1)) / (n2 - n1)`` a generation, which
  cancels the per-call overhead; else the steady median, flagged
  ``latency_confounded``.
- **Signature changes**: every call's argument signature (tensor shapes
  and dtypes, ``core/cost.py``'s ``abstract_signature``) is recorded. A new
  one after an entry's first call is what the JAX package flags as a
  retrace; eager PyTorch recompiles nothing, but the change (a shape or
  dtype that moves between calls) is flagged the same way
  (``retrace_flags``) and raises :class:`RetraceError` under
  ``strict_retrace=True``. Changes of static fields only (the designed
  ``first_step`` flip) are counted apart and never flagged.
- **Spans**: every timed call and fetch keeps its ``(start, duration)``, so
  :func:`write_chrome_trace` exports the run as Chrome trace-event JSON
  (Perfetto, chrome://tracing), with ``TelemetryMonitor``'s rings and the
  executor's spans and queue depth as tracks.

:func:`run_report` merges the recorder's summary with the reports of the
workflow's monitors and producers (``TelemetryMonitor``, a
``GuardedAlgorithm``'s health, IPOP's events, ``SurrogateWorkflow``'s
ledger, the ``GenerationExecutor``, a ``FlightRecorder``'s metrics and SLO
ledger, a ``LineageMonitor``'s search section, a ``StateAttestor``'s ring
with the executor's voted re-dispatch and a ``bisect_divergence``
report) into one strict-JSON dict, the JAX
package's schema ``evox_tpu.run_report/v14``, plus a ``roofline`` section
when a :class:`~evox_tpu_torch.core.cost.CostAnalyzer` is attached
(``instrument(wf, analyze=True)``). Sections whose producers are not
ported raise ``NotImplementedError`` naming their ROADMAP item when asked
for; none is left out silently.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cost import CostAnalyzer, abstract_signature, roofline_section, tensor_leaves

__all__ = [
    "DispatchRecorder",
    "RetraceError",
    "instrument",
    "run_report",
    "sanitize_json",
    "write_chrome_trace",
    "write_report_jsonl",
]

SCHEMA = "evox_tpu.run_report/v14"
SCHEMA_VERSION = 14


def sanitize_json(obj: Any) -> Any:
    """Non-finite floats replaced by ``None``, recursively: the result is
    strict (RFC 8259) JSON, where ``json.dumps`` would write bare
    ``Infinity``/``NaN`` (telemetry holds +inf before any finite
    generation, and inf-padded ring slots)."""
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


# wrapped on the workflow INSTANCE, so instrumentation is per workflow and
# never reaches other workflows of the same class
DEFAULT_ENTRY_POINTS = (
    "init",
    "step",
    "run",
    "pipeline_ask",
    "pipeline_tell",
)


class RetraceError(RuntimeError):
    """An instrumented entry point was called with another argument
    signature (a tensor leaf's shape or dtype) than its earlier calls: the
    JAX package's recompile, raised instead of recorded when
    ``DispatchRecorder(strict_retrace=True)``."""


def _run_work(args: tuple, kwargs: dict) -> int:
    """Work units of a ``run(state, n_steps, ...)`` call. Restart and resume
    drivers may run fewer generations than asked; ``n_steps`` is still the
    honest upper bound, and exact for a plain run."""
    n = kwargs.get("n_steps", args[1] if len(args) > 1 else 1)
    try:
        return max(int(n), 1)
    except (TypeError, ValueError):
        return 1


DEFAULT_WORK_EXTRACTORS: Dict[str, Callable[[tuple, dict], int]] = {
    "run": _run_work,
}


class _EntryStats:
    __slots__ = ("times", "works", "spans", "sigs", "aval_sigs", "retraces")

    def __init__(self) -> None:
        self.times: list = []  # call durations, [0] is the cold call
        self.works: list = []  # work units a call (run: n_steps)
        self.spans: list = []  # (abs_start_s, duration_s, work)
        self.sigs: Dict[str, int] = {}  # full (leaf|static) signature -> calls
        self.aval_sigs: Dict[str, int] = {}  # leaf signature -> calls
        self.retraces: list = []  # {"call", "kind", "t"} events

    # ------------------------------------------------------------ retrace
    def observe_signature(self, sig: Tuple[str, str], t: float) -> Optional[str]:
        """Record a call's (leaf, static) signature; returns the change's
        kind (``"aval"``/``"static"``) when an entry already called sees a
        new one, else None. The first signature is never a change."""
        aval, static = sig
        full = aval + "|" + static
        kind = None
        if self.sigs and full not in self.sigs:
            kind = "aval" if aval not in self.aval_sigs else "static"
            self.retraces.append({"call": len(self.times) + 1, "kind": kind, "t": t})
        self.sigs[full] = self.sigs.get(full, 0) + 1
        self.aval_sigs[aval] = self.aval_sigs.get(aval, 0) + 1
        return kind

    @property
    def aval_retraces(self) -> int:
        return sum(1 for r in self.retraces if r["kind"] == "aval")

    # ------------------------------------------------------------- timing
    def _per_work(self) -> Optional[dict]:
        """Seconds a work unit: the differenced slope over the two extreme
        distinct work counts when there are two (the per-call overhead
        cancels), else the steady median over its median work, flagged
        latency-confounded. The cold call is left out whenever warmer
        calls exist."""
        if not self.times:
            return None
        steady = (self.times[1:], self.works[1:]) if len(self.times) > 1 else None
        for source, cold_included in ((steady, False), ((self.times, self.works), True)):
            if source is None:
                continue
            times, works = source
            best: Dict[int, float] = {}
            for w, t in zip(works, times):
                best[w] = min(t, best.get(w, math.inf))
            if len(best) < 2:
                continue
            w1, w2 = min(best), max(best)
            slope = (best[w2] - best[w1]) / (w2 - w1)
            # noise (or a cold call at the smaller count) can invert the
            # pair: fall through to the median rather than report it
            if slope > 0:
                out = {
                    "seconds": round(slope, 9),
                    "method": "differenced",
                    "latency_confounded": False,
                    "work_pair": [w1, w2],
                }
                if cold_included:
                    # one end of the slope is a cold call: warm both counts
                    out["cold_call_included"] = True
                return out
        times, works = (self.times, self.works) if steady is None else steady
        med_t = float(np.median(times))
        med_w = max(float(np.median(works)), 1.0)
        return {
            "seconds": round(med_t / med_w, 9),
            "method": "median_per_work",
            # one work count cannot cancel the per-call overhead
            "latency_confounded": True,
        }

    def summary(self) -> dict:
        first = self.times[0]
        steady = self.times[1:]
        out = {
            "calls": len(self.times),
            "first_call_s": round(first, 6),
            "total_s": round(sum(self.times), 6),
            "work_total": int(sum(self.works)),
        }
        if steady:
            p50 = float(np.percentile(steady, 50))
            out["dispatch_s"] = {
                "mean": round(float(np.mean(steady)), 6),
                "p50": round(p50, 6),
                "min": round(float(np.min(steady)), 6),
                "max": round(float(np.max(steady)), 6),
            }
            # the cold call less the steady median: what a first call pays
            # beyond a warm one (floored: noise can invert it)
            out["compile_s"] = round(max(first - p50, 0.0), 6)
        else:
            out["dispatch_s"] = None
            out["compile_s"] = round(first, 6)
        out["per_work_s"] = self._per_work()
        out["signatures"] = {
            "aval": len(self.aval_sigs),
            "static": len(self.sigs),
            "retraces": len(self.retraces),
            "aval_retraces": self.aval_retraces,
            # static-only changes (the designed first_step flip) are
            # recorded above, but only leaf (shape/dtype) changes flag
            "flagged": self.aval_retraces > 0,
        }
        return out


def _wait(out: Any) -> None:
    """Wait until the card has done the work queued for ``out``: each CUDA
    device among its tensors has its current stream synchronized."""
    for index in sorted({t.device.index or 0 for t in tensor_leaves(out) if t.is_cuda}):
        torch.cuda.current_stream(index).synchronize()


def _to_host(tree: Any) -> Tuple[Any, int]:
    """``(tree with numpy leaves, bytes)``. A tensor is copied to the host
    (bfloat16 widened to float32 for numpy, its bytes counted at 2 an
    element); a Python number becomes the 32-bit numpy scalar the JAX
    package's state holds in its place (``generation`` is an int32 there),
    and counts as such."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        host = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        return host, t.numel() * t.element_size()
    if isinstance(tree, bool):
        return np.bool_(tree), 1
    if isinstance(tree, int):
        return np.int32(tree), 4
    if isinstance(tree, float):
        return np.float32(tree), 4
    if isinstance(tree, np.ndarray):
        return tree, tree.nbytes
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        total, changes = 0, {}
        for f in dataclasses.fields(tree):
            if f.metadata.get("static", False):
                continue
            changes[f.name], n = _to_host(getattr(tree, f.name))
            total += n
        return dataclasses.replace(tree, **changes), total
    if isinstance(tree, dict):
        pairs = {k: _to_host(v) for k, v in tree.items()}
        return {k: v for k, (v, _) in pairs.items()}, sum(n for _, n in pairs.values())
    if isinstance(tree, (list, tuple)):
        pairs = [_to_host(v) for v in tree]
        return type(tree)(v for v, _ in pairs), sum(n for _, n in pairs)
    return tree, 0


class DispatchRecorder:
    """Per-entry-point wall-clock registry; all accounting on the host.

    Args:
        clock: monotonic seconds (default ``time.perf_counter``).
        strict_retrace: raise :class:`RetraceError` before running a call
            whose argument signature (tensor shapes and dtypes) differs
            from the entry's earlier calls. Static-only changes (the
            designed ``first_step`` flip) never raise.
        max_spans: cap on the ``(start, duration)`` spans kept across all
            entries and fetches (the trace export's memory bound); beyond
            it spans are dropped (counted) while the statistics go on.
        block_dispatch: wait for the call's work on the card inside the
            timed region (the JAX package's ``block_until_ready``). Off, a
            warm call's duration is the host's enqueue time. Turn it on for
            roofline rates: the differenced slope needs durations that grow
            with the work.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        strict_retrace: bool = False,
        max_spans: int = 100_000,
        block_dispatch: bool = False,
    ):
        self._clock = clock
        self._entries: Dict[str, _EntryStats] = {}
        self._fetches: Dict[str, dict] = {}
        self._fetch_spans: List[dict] = []
        self._created = clock()
        self.strict_retrace = strict_retrace
        self.max_spans = max_spans
        self.block_dispatch = block_dispatch
        self._span_count = 0
        self._dropped_spans = 0
        self.analyzer: Optional[CostAnalyzer] = None

    def _keep_span(self) -> bool:
        if self._span_count >= self.max_spans:
            self._dropped_spans += 1
            return False
        self._span_count += 1
        return True

    # ------------------------------------------------------------- recording
    @contextlib.contextmanager
    def record(self, name: str, work: int = 1):
        """Time a block on the host as one call of entry point ``name``
        covering ``work`` units (generations) of progress."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            stats = self._entries.setdefault(name, _EntryStats())
            stats.times.append(dt)
            stats.works.append(work)
            if self._keep_span():
                stats.spans.append((t0, dt, work))

    def wrap(
        self,
        name: str,
        fn: Callable,
        work_fn: Optional[Callable[[tuple, dict], int]] = None,
    ) -> Callable:
        """Wrap ``fn`` so every call is recorded under ``name``, with its
        argument signature tracked."""

        def wrapped(*args: Any, **kwargs: Any):
            stats = self._entries.setdefault(name, _EntryStats())
            sig = abstract_signature(args, kwargs)
            # strict mode raises before the signature is recorded, so a
            # retried call with the same shape raises again
            if self.strict_retrace and stats.sigs and sig[0] not in stats.aval_sigs:
                raise RetraceError(
                    f"entry point '{name}' changed its argument signature to "
                    f"{sig[0][:200]} after {len(stats.times)} call(s): a tensor "
                    "leaf's shape or dtype moved between calls (the JAX package "
                    "recompiles there). Fix the shape instability, or drop "
                    "strict_retrace to record it instead."
                )
            stats.observe_signature(sig, self._clock() - self._created)
            work = work_fn(args, kwargs) if work_fn is not None else 1
            with self.record(name, work=work):
                out = fn(*args, **kwargs)
                if self.block_dispatch:
                    # an error the card raises here is real and propagates
                    _wait(out)
                return out

        wrapped._dispatch_recorder = self  # marks the wrapper for attach
        wrapped.__wrapped__ = fn
        return wrapped

    def attach(
        self,
        workflow: Any,
        entry_points: Sequence[str] = DEFAULT_ENTRY_POINTS,
    ) -> Any:
        """Wrap the workflow's entry points in place (instance attributes
        shadow the class methods; other instances are untouched). ``run``
        peels its first generation through ``step`` when the state is
        fresh or the carries are donated (``workflows/common.py``'s
        ``fused_run``), so such a ``run`` also records one ``step``, as in
        the JAX package; its other generations and ``step``'s own halves
        are not separate calls. Attaching the same recorder again changes
        nothing."""
        for name in entry_points:
            fn = getattr(workflow, name, None)
            if fn is None or not callable(fn):
                continue
            if getattr(fn, "_dispatch_recorder", None) is self:
                continue
            setattr(workflow, name, self.wrap(name, fn, DEFAULT_WORK_EXTRACTORS.get(name)))
        return workflow

    def fetch(self, tree: Any, name: str = "fetch") -> Any:
        """Bring ``tree`` to the host, counting bytes and seconds under
        ``name``; returns the tree with numpy leaves. Instrumented code
        reads device data through here, so its host reads are accounted
        (a Python number counts as the 32-bit scalar the JAX package's
        state holds in its place)."""
        t0 = self._clock()
        host, nbytes = _to_host(tree)
        dt = self._clock() - t0
        agg = self._fetches.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
        agg["calls"] += 1
        agg["bytes"] += int(nbytes)
        agg["seconds"] += dt
        if self._keep_span():
            self._fetch_spans.append({"name": name, "t0": t0, "dt": dt, "bytes": int(nbytes)})
        return host

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        out = {
            "entry_points": {
                name: stats.summary() for name, stats in sorted(self._entries.items())
            },
            "fetches": {
                name: {
                    "calls": agg["calls"],
                    "bytes": agg["bytes"],
                    "seconds": round(agg["seconds"], 6),
                }
                for name, agg in sorted(self._fetches.items())
            },
            "wall_s": round(self._clock() - self._created, 6),
            "retrace_flags": sorted(
                name for name, stats in self._entries.items() if stats.aval_retraces > 0
            ),
        }
        if self._dropped_spans:
            out["dropped_spans"] = self._dropped_spans
        return out


def instrument(
    workflow: Any,
    recorder: Optional[DispatchRecorder] = None,
    entry_points: Sequence[str] = DEFAULT_ENTRY_POINTS,
    analyze: bool = False,
    strict_retrace: bool = False,
    block_dispatch: bool = False,
) -> DispatchRecorder:
    """Attach (or create) a :class:`DispatchRecorder` to ``workflow``.

    ``analyze=True`` also attaches a :class:`~evox_tpu_torch.core.cost.
    CostAnalyzer`: the first ``run_report`` runs each entry point the
    workflow advertises once more under the operator counter (its result
    thrown away) and the report gains a ``roofline`` section.
    ``strict_retrace=True`` makes a signature change of an instrumented
    entry raise :class:`RetraceError`. ``block_dispatch=True`` makes timed
    calls wait for the card (needed for meaningful roofline rates).

    Usage::

        rec = instrument(wf, analyze=True, block_dispatch=True)
        state = wf.init(seed)
        state = wf.run(state, 100)   # warm
        state = wf.run(state, 300)   # a second work count: differenced
        report = run_report(wf, state, recorder=rec)
    """
    recorder = recorder if recorder is not None else DispatchRecorder(
        strict_retrace=strict_retrace, block_dispatch=block_dispatch
    )
    if strict_retrace:
        recorder.strict_retrace = True
    if block_dispatch:
        recorder.block_dispatch = True
    recorder.attach(workflow, entry_points)
    if analyze and recorder.analyzer is None:
        recorder.analyzer = CostAnalyzer()
    return recorder


# ------------------------------------------------------------------ report


def _not_ported(section: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"run_report's {section} section is not ported yet (ROADMAP {item})")


def _refuse_unported(workflow: Any, analyzer: Any, executor: Any) -> None:
    """Raise for every section asked for (advertised by the workflow as the
    JAX package's ``run_report`` picks it up) whose producer the port does
    not have yet."""
    wf = workflow
    asked = {
        "roofline.sharding": ("A11", analyzer is not None and bool(
            getattr(getattr(wf, "algorithm", None), "is_pop_sharded", False))),
        "roofline.multihost": ("A11", analyzer is not None
                               and torch.distributed.is_available()
                               and torch.distributed.is_initialized()
                               and torch.distributed.get_world_size() > 1),
    }
    for section, (item, wanted) in asked.items():
        if wanted:
            raise _not_ported(section, item)


def run_report(
    workflow: Any = None,
    state: Any = None,
    recorder: Optional[DispatchRecorder] = None,
    extra: Optional[dict] = None,
    analyzer: Optional[CostAnalyzer] = None,
    supervisor: Any = None,
    executor: Any = None,
    pod_supervisor: Any = None,
    metrics: Any = None,
    control_plane: Any = None,
) -> dict:
    """Merge device telemetry and host timings into one strict-JSON dict,
    the JAX package's schema ``evox_tpu.run_report/v14``.

    Device side: every monitor on ``workflow`` with ``report(mstate)``
    (``TelemetryMonitor``) is called with its slot of ``state.monitors``
    (the ``telemetry`` list). Host side: ``recorder.summary()`` (the
    ``dispatch`` section). Either half may be absent. Sections from the
    workflow's producers: ``guardrail`` (a ``GuardedAlgorithm``'s health,
    IPOP's events under ``guardrail.ipop``), ``surrogate``
    (``SurrogateWorkflow.surrogate_report``) and ``executor`` (the
    ``GenerationExecutor`` of the workflow's latest executor-backed run,
    or ``executor=``).

    Roofline: with ``analyzer`` (or the recorder's, ``instrument(wf,
    analyze=True)``), the workflow's ``analysis_targets`` are analysed
    (cached: once an entry and signature) and merged with the measured
    seconds a work unit (``core/cost.py``'s ``roofline_section``), with
    the ``dtype_policy`` the state is stored at and the ``donation``:
    eager PyTorch aliases no buffer, so ``alias_bytes`` maps no entry (no
    entry has an aliasing measurement) whatever ``donate_carries`` says,
    and ``aliased`` is false. Without an analyzer the report has no
    roofline.

    ``metrics=`` (or the workflow's ``_flight_recorder``): a
    :class:`~evox_tpu_torch.workflows.flightrec.FlightRecorder`'s report
    is the ``metrics`` section and its SLO ledger the ``slo`` section.
    ``search``: the first monitor with ``search_report`` (a
    ``LineageMonitor``). ``integrity``: the first monitor with
    ``integrity_report`` (a ``StateAttestor``'s ring), joined by the
    executor's voted re-dispatch counters and a ``bisect_divergence``
    report the workflow keeps as ``_integrity_forensics``, with one
    verdict (``clean``, ``detected``, ``healed``, ``aborted``).

    ``tenancy``: a fleet's ``tenancy_report`` (``VectorizedWorkflow``:
    the fleet's shape, each tenant's monitor reports and a ``RunQueue``'s
    ``queue`` section).

    ``supervisor``: ``supervisor=``, or the
    :class:`~evox_tpu_torch.workflows.supervisor.RunSupervisor` that
    drove the workflow's latest run (``workflow._run_supervisor``): its
    deadlines, retries, restores, degradations and aborts.

    ``serving``: a bucket workflow warmed through the serving cache
    (``workflows/elastic.py``'s ``warm_fleet_cache``) advertises it as
    ``_exec_cache`` and its lattice as ``_bucket_table``: the cache's
    ``report()`` and the lattice, the JAX package's schema.

    ``pod_supervisor``: ``pod_supervisor=``, or the workflow's
    ``_pod_supervisor`` (``core/pod_supervisor.py``): heartbeats,
    censuses, classified failures, drains and resumes (the JAX package's
    schema v9). ``control_plane``: ``control_plane=``, or the workflow's
    ``_control_plane`` (``workflows/control_plane.py``): the pod census,
    the ledger's counts, the steals and the exactly-once audit (v12).

    The roofline sharding and multihost (A11) sections raise
    ``NotImplementedError`` when the workflow asks for them: their
    producers are not ported.
    """
    if executor is None and workflow is not None:
        executor = getattr(workflow, "_run_executor", None)
    if analyzer is None and recorder is not None:
        analyzer = recorder.analyzer
    _refuse_unported(workflow, analyzer, executor)
    report: dict = {"schema": SCHEMA, "schema_version": SCHEMA_VERSION}
    if state is not None and hasattr(state, "generation"):
        report["generation"] = int(state.generation)
    if workflow is not None and state is not None:
        telemetry = []
        mstates = getattr(state, "monitors", None)
        if mstates is not None:
            for i, mon in enumerate(getattr(workflow, "monitors", ())):
                if hasattr(mon, "report"):
                    entry = mon.report(mstates[i])
                    entry["monitor"] = type(mon).__name__
                    entry["monitor_index"] = i
                    telemetry.append(entry)
        report["telemetry"] = telemetry
        # a fleet (VectorizedWorkflow): its per-tenant monitor states live
        # tenant-stacked under .tenants and come through the tenancy
        # section, with the fleet's shape and a RunQueue's bookkeeping
        if hasattr(workflow, "tenancy_report"):
            try:
                report["tenancy"] = workflow.tenancy_report(state)
            except Exception as e:  # decoration must never sink the report
                report["tenancy"] = {"error": f"{type(e).__name__}: {e}"}
        algo = getattr(workflow, "algorithm", None)
        astate = getattr(state, "algo", None)
        if hasattr(algo, "health_report") and hasattr(astate, "restarts"):
            report["guardrail"] = algo.health_report(astate)
        ipop_events = getattr(workflow, "_ipop_events", None)
        if ipop_events:
            report.setdefault("guardrail", {})["ipop"] = list(ipop_events)
        if hasattr(workflow, "surrogate_report"):
            try:
                report["surrogate"] = workflow.surrogate_report(state)
            except Exception as e:  # decoration must never sink the report
                report["surrogate"] = {"error": f"{type(e).__name__}: {e}"}
        # the first monitor with search_report (LineageMonitor) gives the
        # search section, the first with integrity_report (StateAttestor)
        # the integrity ring; a failing producer leaves an error entry
        if mstates is not None:
            for section, attr in (("search", "search_report"),
                                  ("integrity", "integrity_report")):
                for i, mon in enumerate(getattr(workflow, "monitors", ())):
                    if hasattr(mon, attr):
                        try:
                            report[section] = getattr(mon, attr)(mstates[i])
                        except Exception as e:  # must never sink the report
                            report[section] = {"error": f"{type(e).__name__}: {e}"}
                        break
    summary = recorder.summary() if recorder is not None else None
    if summary is not None:
        report["dispatch"] = summary
    if analyzer is not None:
        if workflow is not None and state is not None:
            try:
                analyzer.analyze_workflow(workflow, state)
            except Exception as e:
                # analyze_callable degrades per entry, but analysis_targets
                # itself can raise: keep telemetry and dispatch, note why
                report["roofline"] = {"error": f"{type(e).__name__}: {e}"}
        if "roofline" not in report and analyzer.analyses:
            report["roofline"] = roofline_section(analyzer.analyses, summary, analyzer.ceilings)
        if isinstance(report.get("roofline"), dict) and "entries" in report["roofline"]:
            from .dtype_policy import policy_report

            report["roofline"]["dtype_policy"] = policy_report(workflow)
            report["roofline"]["donation"] = {
                "donate_carries": bool(getattr(workflow, "donate_carries", False)),
                # eager PyTorch hands no buffer of a carried state to the
                # next call in place: no entry has alias bytes to report
                "alias_bytes": {},
                "aliased": False,
            }
    if executor is not None and hasattr(executor, "report"):
        report["executor"] = executor.report()
    cache = getattr(workflow, "_exec_cache", None)
    if cache is not None and hasattr(cache, "report"):
        serving: dict = {"cache": cache.report()}
        table = getattr(workflow, "_bucket_table", None)
        if table is not None and hasattr(table, "report"):
            serving["buckets"] = table.report()
        report["serving"] = serving
    if supervisor is None and workflow is not None:
        supervisor = getattr(workflow, "_run_supervisor", None)
    if supervisor is not None and hasattr(supervisor, "report"):
        report["supervisor"] = supervisor.report()
    # a pod-supervised run advertises its PodSupervisor as _pod_supervisor,
    # a multi-pod gateway's workflow its ControlPlane as _control_plane
    if pod_supervisor is None and workflow is not None:
        pod_supervisor = getattr(workflow, "_pod_supervisor", None)
    if pod_supervisor is not None and hasattr(pod_supervisor, "report"):
        report["pod_supervisor"] = pod_supervisor.report()
    if control_plane is None and workflow is not None:
        control_plane = getattr(workflow, "_control_plane", None)
    if control_plane is not None and hasattr(control_plane, "report"):
        report["control_plane"] = control_plane.report()
    if metrics is None and workflow is not None:
        metrics = getattr(workflow, "_flight_recorder", None)
    if metrics is not None and hasattr(metrics, "report"):
        report["metrics"] = metrics.report()
        if hasattr(metrics, "slo_ledger"):
            report["slo"] = metrics.slo_ledger()
    _join_integrity(report, executor, getattr(workflow, "_integrity_forensics", None))
    if extra:
        report["extra"] = dict(extra)
    return sanitize_json(report)


def _join_integrity(report: dict, executor: Any, forensics: Optional[dict]) -> None:
    """The executor's verify counters (``None`` until its rung armed) and a
    ``bisect_divergence`` report join the attestor's ring, and one verdict
    sums the section up."""
    verify = (executor.integrity_counters()
              if executor is not None and hasattr(executor, "integrity_counters") else None)
    integ = report.get("integrity")
    if isinstance(integ, dict) and "error" in integ:
        return  # the ring's producer failed: its error stands
    if integ is None and verify is None and forensics is None:
        return
    if integ is None:
        integ = {"enabled": True, "attestations": 0, "ring": []}
    if verify is not None:
        integ["verify"] = verify
    if forensics is not None:
        integ["bisection"] = dict(forensics)
    v = integ.get("verify") or {}
    if v.get("aborted"):
        integ["verdict"] = "aborted"
    elif v.get("healed"):
        integ["verdict"] = "healed"
    elif v.get("mismatches") or (forensics is not None
                                 and forensics.get("first_divergent_generation") is not None):
        integ["verdict"] = "detected"
    else:
        integ["verdict"] = "clean"
    report["integrity"] = integ


def write_report_jsonl(report: dict, path: str) -> None:
    """Append ``report`` as one strict-JSON line to a JSON-lines file."""
    with open(path, "a") as f:
        f.write(json.dumps(sanitize_json(report), allow_nan=False) + "\n")


# ------------------------------------------------------------ chrome trace

_US = 1e6  # trace-event timestamps are microseconds

#: trace pids are ``PID_STRIDE * process_index + local track``: track 0 =
#: host dispatch, 1 = device telemetry, 2 = host counters, 4 = generation
#: executor, 3 = run supervisor, 5 = pod supervisor. Per-process traces
#: land on disjoint pid ranges.
PID_STRIDE = 100


def _counter_events(track: str, samples: Sequence[Tuple[float, Any]], pid: int) -> List[dict]:
    """One ``ph: "C"`` event a finite sample; ``samples`` carry timestamps
    in seconds already relative to the trace's origin."""
    short = track.rsplit("/", 1)[-1]
    events = []
    for t, v in samples:
        v = float(v)
        if not math.isfinite(v) or not math.isfinite(t):
            continue
        events.append({
            "ph": "C",
            "name": track,
            "pid": pid,
            "ts": round(max(t, 0.0) * _US, 3),
            "args": {short: v},
        })
    return events


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return int(torch.distributed.get_rank())
    return 0


def write_chrome_trace(
    path: str,
    recorder: Optional[DispatchRecorder] = None,
    workflow: Any = None,
    state: Any = None,
    extra_counters: Optional[Dict[str, Sequence[Tuple[float, Any]]]] = None,
    supervisor: Any = None,
    executor: Any = None,
    pod_supervisor: Any = None,
    process_index: Optional[int] = None,
) -> dict:
    """Export a run as Chrome trace-event JSON (Perfetto, chrome://tracing)
    and return the trace dict.

    - The recorder's spans become complete (``ph: "X"``) slices: one thread
      an entry point under the "host dispatch" process, fetches on their
      own thread with their bytes in ``args``; signature changes are
      instant markers on the entry's thread.
    - ``TelemetryMonitor``'s rings (any monitor with
      ``counter_tracks(mstate)``) become counter (``ph: "C"``) tracks. The
      rings are indexed by generation, with no host timestamps, so their
      samples are spread evenly over the recorder's span window (1 ms a
      generation without a recorder): the shapes are exact, the time axis
      approximate.
    - ``extra_counters`` maps track names to ``(timestamp, value)`` samples
      on the recorder's clock (``time.perf_counter``); they land at their
      true host times.
    - The executor (``executor=``, or the workflow's latest
      ``GenerationExecutor``) lands on a "generation executor" process: its
      spans (device dispatch, host evaluation, background I/O; a thread a
      track) at their true host times, and its queue-depth counter.

    - Supervisor events (``supervisor=``, or the workflow's
      ``_run_supervisor``) become instant (``ph: "i"``) markers
      (``supervisor:retry``, ``:deadline``, ``:restore``, ``:degrade``,
      ``:abort``) on a "run supervisor" process at their host times.

    - Pod supervisor events (``pod_supervisor=``, or the workflow's
      ``_pod_supervisor``) become ``supervisor:pod:*`` instant markers
      (join, census, barrier_timeout, failure, drain_requested, drain,
      reform, resume) on a "pod supervisor" process at their host times.

    Every process gets ``process_name`` and
    ``thread_name`` metadata and the pid ``PID_STRIDE * process_index +
    track``; ``process_index`` defaults to the ``torch.distributed`` rank
    (0 outside a process group).
    """
    events: List[dict] = []
    t0 = recorder._created if recorder is not None else 0.0
    t_end = t0
    process_index = _process_index() if process_index is None else int(process_index)
    pid_base = PID_STRIDE * process_index
    # process 0 keeps unprefixed names; others carry their index
    prefix = f"p{process_index}: " if process_index else ""

    def meta(track: int, name: str, tid: Optional[int] = None) -> dict:
        e = {
            "ph": "M",
            "pid": pid_base + track,
            "name": "process_name" if tid is None else "thread_name",
            "args": {"name": name if tid is not None else prefix + name},
        }
        if tid is not None:
            e["tid"] = tid
        return e

    if recorder is not None:
        events.append(meta(0, "host dispatch"))
        names = sorted(recorder._entries)
        for tid, name in enumerate(names, start=1):
            stats = recorder._entries[name]
            events.append(meta(0, name, tid))
            for start, dur, work in stats.spans:
                t_end = max(t_end, start + dur)
                ev = {
                    "ph": "X",
                    "name": name,
                    "cat": "dispatch",
                    "pid": pid_base,
                    "tid": tid,
                    "ts": round((start - t0) * _US, 3),
                    "dur": round(dur * _US, 3),
                }
                if work != 1:
                    ev["args"] = {"work": work}
                events.append(ev)
            for r in stats.retraces:
                events.append({
                    "ph": "i",
                    "name": f"retrace:{r['kind']}",
                    "cat": "retrace",
                    "pid": pid_base,
                    "tid": tid,
                    "ts": round(max(r["t"], 0.0) * _US, 3),
                    "s": "t",
                })
        if recorder._fetch_spans:
            tid = len(names) + 1
            events.append(meta(0, "fetch", tid))
            for span in recorder._fetch_spans:
                t_end = max(t_end, span["t0"] + span["dt"])
                events.append({
                    "ph": "X",
                    "name": span["name"],
                    "cat": "fetch",
                    "pid": pid_base,
                    "tid": tid,
                    "ts": round((span["t0"] - t0) * _US, 3),
                    "dur": round(span["dt"] * _US, 3),
                    "args": {"bytes": span["bytes"]},
                })

    window_s = max(t_end - t0, 0.0)
    if workflow is not None and state is not None and getattr(state, "monitors", None) is not None:
        events.append(meta(1, "device telemetry"))
        for i, mon in enumerate(getattr(workflow, "monitors", ())):
            tracks_fn = getattr(mon, "counter_tracks", None)
            if tracks_fn is None:
                continue
            for track, samples in tracks_fn(state.monitors[i]).items():
                if not samples:
                    continue
                gens = [g for g, _ in samples]
                lo, hi = min(gens), max(gens)
                span = max(hi - lo, 1)
                scale = (window_s / span) if window_s > 0 else 1e-3
                rel = [((g - lo) * scale, v) for g, v in samples]
                events.extend(_counter_events(track, rel, pid=pid_base + 1))

    if extra_counters:
        events.append(meta(2, "host counters"))
        for track, samples in extra_counters.items():
            rel = [(t - t0, v) for t, v in samples]
            events.extend(_counter_events(track, rel, pid=pid_base + 2))

    if supervisor is None and workflow is not None:
        supervisor = getattr(workflow, "_run_supervisor", None)
    if supervisor is not None and hasattr(supervisor, "markers"):
        markers = supervisor.markers()
        if markers:
            events.append(meta(3, "run supervisor"))
            for m in markers:
                events.append({"ph": "i", "name": m["name"], "cat": "supervisor",
                               "pid": pid_base + 3, "tid": 1,
                               "ts": round(max(m["t_abs"] - t0, 0.0) * _US, 3), "s": "p",
                               "args": sanitize_json(m.get("args", {}))})

    if pod_supervisor is None and workflow is not None:
        pod_supervisor = getattr(workflow, "_pod_supervisor", None)
    if pod_supervisor is not None and hasattr(pod_supervisor, "markers"):
        markers = pod_supervisor.markers()
        if markers:
            events.append(meta(5, "pod supervisor"))
            for m in markers:
                events.append({"ph": "i", "name": m["name"], "cat": "supervisor",
                               "pid": pid_base + 5, "tid": 1,
                               "ts": round(max(m["t_abs"] - t0, 0.0) * _US, 3), "s": "p",
                               "args": sanitize_json(m.get("args", {}))})

    if executor is None and workflow is not None:
        executor = getattr(workflow, "_run_executor", None)
    if executor is not None and hasattr(executor, "trace_spans"):
        spans = executor.trace_spans()
        samples = executor.counter_samples() if hasattr(executor, "counter_samples") else {}
        if spans or any(samples.values()):
            events.append(meta(4, "generation executor"))
            tids: Dict[str, int] = {}
            for span in spans:
                tids.setdefault(span["track"], len(tids) + 1)
            for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
                events.append(meta(4, track, tid))
            for span in spans:
                ev = {
                    "ph": "X",
                    "name": span["name"],
                    "cat": "executor",
                    "pid": pid_base + 4,
                    "tid": tids[span["track"]],
                    "ts": round(max(span["t_abs"] - t0, 0.0) * _US, 3),
                    "dur": round(max(span["dur"], 0.0) * _US, 3),
                }
                if span.get("args"):
                    ev["args"] = sanitize_json(span["args"])
                events.append(ev)
            for track, track_samples in samples.items():
                rel = [(t - t0, v) for t, v in track_samples]
                events.extend(_counter_events(track, rel, pid=pid_base + 4))

    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "evox_tpu_torch.core.instrument.write_chrome_trace",
            "time_origin": "DispatchRecorder creation",
        },
    }
    with open(path, "w") as f:
        json.dump(trace, f, allow_nan=False)
    return trace
