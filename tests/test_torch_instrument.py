"""The port's recorder, ``instrument``, ``run_report`` and the Chrome trace
against the JAX package's on the CPU.

The same PSO/Sphere workflow and call sequence go through both packages'
``instrument``; the deterministic fields of the two summaries (calls,
work, first-call bookkeeping, signature counts, retrace flags, fetch bytes)
and the report's generation and telemetry counters must be equal. Timings
and rates are not compared. The port's report and trace must pass the
repo's own validators (``tools/check_report.py``)."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
import evox_tpu as jx
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.instrument import (
    DispatchRecorder,
    RetraceError,
    instrument,
    run_report,
    write_chrome_trace,
    write_report_jsonl,
)
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.problems.numerical import Sphere

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import check_report  # noqa: E402

DIM, POP = 4, 32
# the telemetry counters that count events (the port's draws are not JAX's,
# so best and stagnation differ)
EVENT_COUNTERS = ("generations", "evals", "nan_candidates", "inf_candidates", "nan_fitness",
                  "inf_fitness", "restarts", "last_trigger", "sur_true_evals",
                  "sur_fallback_gens", "capacity", "num_objectives")


def _jax_wf(monitors=(), **kw):
    return jx.StdWorkflow(JaxPSO(-10 * jnp.ones(DIM), 10 * jnp.ones(DIM), pop_size=POP),
                          JaxSphere(), monitors=monitors, **kw)


def _port_wf(monitors=(), **kw):
    return StdWorkflow(PSO(-10 * torch.ones(DIM), 10 * torch.ones(DIM), pop_size=POP,
                           device="cpu"), Sphere(), monitors=monitors, device="cpu", **kw)


def _sequence(wf, state, runs=(8, 8), steps=1):
    for n in runs:
        state = wf.run(state, n)
    for _ in range(steps):
        state = wf.step(state)
    return state


def _deterministic(summary):
    """The fields of a summary that do not depend on the clock (the timing
    method too, where every call of an entry has one work count)."""
    out = {"retrace_flags": summary["retrace_flags"],
           "fetches": {k: (v["calls"], v["bytes"]) for k, v in summary["fetches"].items()}}
    for name, e in summary["entry_points"].items():
        out[name] = {
            "calls": e["calls"],
            "work_total": e["work_total"],
            "warm_calls": e["dispatch_s"] is not None,
            "per_work": (e["per_work_s"]["method"], e["per_work_s"]["latency_confounded"],
                         e["per_work_s"].get("work_pair")),
            "signatures": e["signatures"],
            "keys": sorted(e),
        }
    return out


def _check_valid(report=None, trace=None):
    if report is not None:
        assert check_report.validate_run_report(json.loads(json.dumps(report))) == []
    if trace is not None:
        assert check_report.validate_chrome_trace(trace) == []


def test_instrument_and_run_report_match_jax(tmp_path):
    """``test_telemetry.py::test_instrument_and_run_report``'s sequence
    (init, run 8, run 8, step): init 1, run 2, step 2 in both packages (the
    first run peels its first generation through ``step``), the fetch of
    ``generation`` 4 bytes, the report at generation 17."""
    jtm, ttm = JaxTelemetryMonitor(capacity=8), TelemetryMonitor(capacity=8, device="cpu")
    jwf, twf = _jax_wf((jtm,)), _port_wf((ttm,))
    jrec, trec = jx.instrument(jwf), instrument(twf)
    jstate = _sequence(jwf, jwf.init(jax.random.PRNGKey(11)))
    tstate = _sequence(twf, twf.init(11))
    jrec.fetch(jstate.generation, name="gen")
    assert int(trec.fetch(tstate.generation, name="gen")) == 17
    jsum, tsum = jrec.summary(), trec.summary()
    assert {k: v["calls"] for k, v in tsum["entry_points"].items()} == {
        "init": 1, "run": 2, "step": 2}
    assert _deterministic(tsum) == _deterministic(jsum)
    assert tsum["fetches"]["gen"]["bytes"] == 4

    jrep = jx.run_report(jwf, jstate, recorder=jrec, extra={"tag": "unit"})
    trep = run_report(twf, tstate, recorder=trec, extra={"tag": "unit"})
    assert set(trep) == set(jrep)
    for key in ("schema", "schema_version", "generation", "extra"):
        assert trep[key] == jrep[key], key
    assert trep["generation"] == 17
    jtel, ttel = jrep["telemetry"][0], trep["telemetry"][0]
    assert set(ttel) == set(jtel)
    for key in EVENT_COUNTERS + ("monitor", "monitor_index"):
        assert ttel[key] == jtel[key], key
    assert ttel["trajectory"]["generation"] == jtel["trajectory"]["generation"]
    _check_valid(report=trep)

    path = str(tmp_path / "reports.jsonl")
    write_report_jsonl(trep, path)
    write_report_jsonl(trep, path)
    lines = Path(path).read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["generation"] == 17


def test_donated_runs_peel_every_run_as_jax():
    """``donate_carries=True``: every ``run`` peels one generation through
    ``step`` in the JAX package (the caller's buffers are never donated),
    and the port counts the same calls."""
    jwf, twf = _jax_wf(donate_carries=True), _port_wf(donate_carries=True)
    jrec, trec = jx.instrument(jwf), instrument(twf)
    _sequence(jwf, jwf.init(jax.random.PRNGKey(3)), runs=(4, 4), steps=2)
    _sequence(twf, twf.init(3), runs=(4, 4), steps=2)
    assert _deterministic(trec.summary()) == _deterministic(jrec.summary())
    assert trec.summary()["entry_points"]["step"]["calls"] == 4


def test_instrument_is_idempotent_per_recorder():
    wf = _port_wf()
    rec = instrument(wf)
    instrument(wf, recorder=rec)  # attached again: no double counting
    wf.step(wf.init(12))
    assert rec.summary()["entry_points"]["step"]["calls"] == 1


def _shape_sequence(rec, f, ones):
    f(ones(8))
    f(ones(8))
    flags = list(rec.summary()["retrace_flags"])
    f(ones(16))  # a shape change
    return flags, rec.summary()


def test_retrace_flags_match_jax():
    jrec, trec = jx.DispatchRecorder(), DispatchRecorder()
    jf = jrec.wrap("f", jax.jit(lambda x: x * 2.0))
    tf = trec.wrap("f", lambda x: x * 2.0)
    jflags, jsum = _shape_sequence(jrec, jf, jnp.ones)
    tflags, tsum = _shape_sequence(trec, tf, torch.ones)
    assert tflags == jflags == []
    assert tsum["retrace_flags"] == jsum["retrace_flags"] == ["f"]
    assert (tsum["entry_points"]["f"]["signatures"]
            == jsum["entry_points"]["f"]["signatures"])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_strict_retrace_raises_on_dtype_change(package):
    """A dtype change raises under ``strict_retrace``, again on retry, and
    the first signature still passes: the same in both packages."""
    if package == "jax":
        rec, ones, bf16 = jx.DispatchRecorder(strict_retrace=True), jnp.ones, jnp.bfloat16
        f = rec.wrap("f", jax.jit(lambda x: x * 2.0))
        error = jx.RetraceError
    else:
        rec, ones, bf16 = DispatchRecorder(strict_retrace=True), torch.ones, torch.bfloat16
        f = rec.wrap("f", lambda x: x * 2.0)
        error = RetraceError
    f(ones(8))
    for _ in range(2):
        with pytest.raises(error):
            f(ones(8, dtype=bf16))
    f(ones(8))
    assert rec.summary()["entry_points"]["f"]["calls"] == 2


def test_first_step_flip_is_static_and_never_flags():
    """``test_roofline.py::test_retrace_silent_across_fused_run``'s law: a
    run, a warm run and a step loop under ``strict_retrace`` do not raise;
    the first_step flip shows as a static signature."""
    wf = _port_wf()
    rec = instrument(wf, strict_retrace=True)
    _sequence(wf, wf.init(0), runs=(5, 3), steps=3)
    summary = rec.summary()
    assert summary["retrace_flags"] == []
    sigs = summary["entry_points"]["step"]["signatures"]
    assert sigs["aval_retraces"] == 0 and sigs["static"] > sigs["aval"]


def test_chrome_trace_validates_and_marks_retraces(tmp_path):
    tm = TelemetryMonitor(capacity=16, device="cpu")
    wf = _port_wf((tm,))
    rec = instrument(wf)
    state = _sequence(wf, wf.init(1), runs=(12,), steps=2)
    rec.fetch(state.algo.gbest_position, name="gbest")
    f = rec.wrap("f", lambda x: x + 1)
    f(torch.ones(3))
    f(torch.ones(5))
    path = tmp_path / "trace.json"
    trace = write_chrome_trace(str(path), recorder=rec, workflow=wf, state=state,
                               extra_counters={"host/queue": [(rec._created + 0.5, 2)]})
    assert json.loads(path.read_text()) == trace  # strict JSON on disk
    _check_valid(trace=trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"run", "step", "gbest", "telemetry/best_fitness", "host/queue"} <= names
    fetch = [e for e in trace["traceEvents"] if e.get("cat") == "fetch"]
    assert fetch and fetch[0]["args"]["bytes"] == DIM * 4
    assert any(e.get("cat") == "retrace" for e in trace["traceEvents"])


def _tensors(state):
    return [(p, x.clone()) for p, x in named_leaves(state) if isinstance(x, torch.Tensor)]


def test_analysis_changes_nothing_and_validates(tmp_path):
    """``analyze=True``: the roofline has ``step`` and ``run`` (one
    generation each), the report validates, and the analysis run leaves
    the state and every later generation as they were, bit for bit."""
    tm = TelemetryMonitor(capacity=8, device="cpu")
    wf = _port_wf((tm,), donate_carries=True)
    rec = instrument(wf, analyze=True, block_dispatch=True)
    state = _sequence(wf, wf.init(5), runs=(3, 6), steps=1)
    before = _tensors(state)
    report = run_report(wf, state, recorder=rec)
    _check_valid(report=report)
    roof = report["roofline"]
    assert set(roof["entries"]) == {"step", "run"}
    for entry in roof["entries"].values():
        assert entry["static"]["flops"] > 0 and entry["static"]["bytes_accessed"] > 0
        assert entry["classification"] in ("compute-bound", "memory-bound", "dispatch-bound")
    assert roof["entries"]["run"]["static"]["flops"] == roof["entries"]["step"]["static"]["flops"]
    assert roof["donation"] == {"donate_carries": True, "alias_bytes": {}, "aliased": False}
    assert roof["dtype_policy"] == {"storage": "float32", "compute": "float32", "active": False}
    for (p, x), (q, y) in zip(before, _tensors(state)):
        assert p == q and torch.equal(x, y), p
    # the next generation from the analysed state is the uninstrumented one's
    plain = _port_wf((TelemetryMonitor(capacity=8, device="cpu"),), donate_carries=True)
    ref = _sequence(plain, plain.init(5), runs=(3, 6), steps=2)
    for (p, x), (q, y) in zip(_tensors(wf.step(state)), _tensors(ref)):
        assert p == q and torch.equal(x, y), p


def test_report_without_analysis_is_the_plain_shape():
    wf = _port_wf()
    rec = instrument(wf)
    state = wf.run(wf.init(0), 5)
    report = run_report(wf, state, recorder=rec)
    assert set(report) == {"schema", "schema_version", "generation", "telemetry", "dispatch"}


def test_report_survives_analysis_targets_failure():
    wf = _port_wf((TelemetryMonitor(capacity=4, device="cpu"),))
    rec = instrument(wf, analyze=True)
    state = wf.run(wf.init(0), 3)

    def boom(_state):
        raise ValueError("analysis failed")

    wf.analysis_targets = boom
    report = run_report(wf, state, recorder=rec)
    assert report["roofline"] == {"error": "ValueError: analysis failed"}
    assert report["telemetry"] and report["dispatch"]["entry_points"]
    _check_valid(report=report)


class _PopShardedAlgorithm:
    """Stands for a ``ShardedES`` that names no shard count: the roofline's
    sharding subsection looks at every POP-sharded workflow, and under 4
    shards attaches nothing (the JAX package's rule)."""

    is_pop_sharded = True


@pytest.mark.parametrize("section,item,kwargs,attr", [
    ("roofline.sharding", "A11", {"analyzer": "analyzer"}, ("algorithm", _PopShardedAlgorithm())),
    ("roofline.sharding", "A11", {"recorder": "recorder"}, ("algorithm", _PopShardedAlgorithm())),
])
def test_unported_sections_raise_naming_their_item(section, item, kwargs, attr):
    """The sections that raised until ROADMAP ``item`` was ported now reach
    the report: asked for by a POP-sharded workflow, through an analyzer or
    a recorder's, the report is made and valid, and a shard count under 4
    attaches no subsection (``tests/test_torch_resident.py`` holds the
    attached ones against the JAX package's formulas)."""
    from evox_tpu_torch.core.cost import CostAnalyzer
    from evox_tpu_torch.core.instrument import instrument as port_instrument

    wf = _port_wf()
    state = wf.init(0)
    if kwargs.get("analyzer") == "analyzer":
        kwargs = {"analyzer": CostAnalyzer()}
    if kwargs.get("recorder") == "recorder":
        kwargs = {"recorder": port_instrument(wf, analyze=True)}
    if attr is not None:
        setattr(wf, *attr)
    report = run_report(wf, state, **kwargs)
    assert section.split(".")[1] not in report["roofline"]
    _check_valid(report=report)


class _SectionProducer:
    """Stands for a PodSupervisor or a ControlPlane: ``run_report`` takes
    its ``report()`` as the section and the trace its ``markers()``."""

    def __init__(self, section):
        self.section = section

    def report(self):
        return {"producer": self.section}

    def markers(self):
        return [{"t_abs": 0.0, "name": "supervisor:pod:join", "args": {"process_id": 0}}]


@pytest.mark.parametrize("section,passed", [
    ("pod_supervisor", True), ("control_plane", True),
    ("pod_supervisor", False), ("control_plane", False),
])
def test_pod_supervisor_and_control_plane_sections_come_from_their_producers(
        section, passed, tmp_path):
    """The sections that were refused until their producers were ported:
    passed as ``run_report``'s argument or advertised by the workflow
    (``_pod_supervisor``, ``_control_plane``), the producer's ``report()``
    is the section; a pod supervisor's markers land on the trace's pod
    supervisor track (pid 5)."""
    wf = _port_wf()
    state = wf.init(0)
    producer = _SectionProducer(section)
    if passed:
        report = run_report(wf, state, **{section: producer})
    else:
        setattr(wf, f"_{section}", producer)
        report = run_report(wf, state)
    assert report[section] == {"producer": section}
    if section == "pod_supervisor":
        kw = {"pod_supervisor": producer} if passed else {}
        trace = write_chrome_trace(str(tmp_path / "t.json"), workflow=wf, state=state, **kw)
        pod = [e for e in trace["traceEvents"] if e.get("pid") == 5]
        assert [e["name"] for e in pod if e["ph"] == "i"] == ["supervisor:pod:join"]


def test_serving_section_comes_from_the_serving_cache(tmp_path):
    """A workflow warmed through the serving cache advertises it: the
    report's ``serving`` section is the cache's report and the lattice, in
    the JAX package's schema (``tools/check_report.py``), and matches the
    JAX report's keys."""
    from evox_tpu.core.exec_cache import ExecutableCache as JaxCache
    from evox_tpu_torch.core.exec_cache import ExecutableCache
    from evox_tpu_torch.workflows.elastic import BucketTable

    wf = _port_wf()
    state = wf.init(0)
    wf._exec_cache = cache = ExecutableCache(directory=str(tmp_path))
    cache.get_or_compile("step", "fp", wf.step, (state,), bucket=(8, 4, 1), device="cpu")
    cache.get_or_compile("step", "fp", wf.step, (state,), bucket=(8, 4, 1), device="cpu")
    wf._bucket_table = BucketTable()
    report = run_report(wf, state)
    serving = report["serving"]
    assert serving["cache"]["counters"]["misses"] == 1 and serving["cache"]["counters"]["hits"] == 1
    assert serving["buckets"]["pop_rungs"][0] == 8
    assert sorted(serving["cache"]) == sorted(JaxCache().report())
    _check_valid(report=report)


def test_tenancy_section_comes_from_the_workflow():
    """The tenancy section is ported: a workflow's ``tenancy_report`` is
    the report's ``tenancy`` section, and a failing producer leaves an
    error entry without sinking the report."""
    wf = _port_wf()
    state = wf.init(0)
    wf.tenancy_report = lambda s: {"n_tenants": 1}
    assert run_report(wf, state)["tenancy"] == {"n_tenants": 1}
    wf.tenancy_report = lambda s: 1 / 0
    assert run_report(wf, state)["tenancy"] == {"error": "ZeroDivisionError: division by zero"}


def test_executor_section_from_a_checkpointed_run(tmp_path):
    """A checkpointed ``run`` goes through the ``GenerationExecutor``,
    which the report and the trace pick up from the workflow."""
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    wf = _port_wf()
    rec = instrument(wf)
    state = wf.run(wf.init(0), 4, checkpointer=WorkflowCheckpointer(str(tmp_path / "ck"), every=2))
    report = run_report(wf, state, recorder=rec)
    assert report["executor"]["counters"]
    trace = write_chrome_trace(str(tmp_path / "t.json"), recorder=rec, workflow=wf, state=state)
    assert any(e.get("cat") == "executor" for e in trace["traceEvents"])
    _check_valid(report=report, trace=trace)
