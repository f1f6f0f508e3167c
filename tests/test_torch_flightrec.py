"""The metrics plane of the port — ``core/metrics.py``,
``workflows/journal.py`` and ``workflows/flightrec.py`` — against the JAX
package's on the CPU: the registry's snapshots and OpenMetrics text, the
hash-chained log's torn tail and tampered middle, ``read_stream``,
``merge_pod_streams``, and the executor's ``metrics=`` (``None`` an exact
no-op). The modules are host Python on both sides: every comparison is
equality, except wall-clock fields (``t``, ``tm``, rates), which the
comparisons leave out."""

import json

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.core.metrics import MetricsRegistry as JaxRegistry
from evox_tpu.workflows import flightrec as jflightrec
from evox_tpu.workflows import journal as jjournal
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.pso import CSO
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.instrument import run_report
from evox_tpu_torch.core.metrics import DEFAULT_MS_BUCKETS, MetricsRegistry
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.problems.numerical import Ackley
from evox_tpu_torch.workflows.flightrec import (
    PID_STRIDE,
    FlightRecorder,
    MetricsStream,
    merge_pod_streams,
    read_stream,
)
from evox_tpu_torch.workflows.journal import (
    EVENT_KINDS,
    ChainedLog,
    JournalIntegrityError,
    RunJournal,
    jsonable,
)

from tests.test_torch_instrument import _check_valid, check_report

WALL = ("t", "tm", "tm_aligned", "elapsed_s", "tenant_gens_per_s", "started_wall", "t_wall", "ts",
        "sha", "prev", "exporter", "path")


def _drive(reg):
    reg.count("executor.dispatches", 3)
    reg.count("slo.tenant_gens", 8)
    reg.set("executor.io_queue_depth", 2)
    reg.set("worker.sigma", 0.25)
    for v in (0.5, 3.0, 40.0, 7000.0):
        reg.observe("executor.dispatch_ms", v)
    reg.observe("fit_ms", 2.0, buckets=(1.0, 10.0))


def test_registry_snapshot_and_openmetrics_equal_jax():
    ours, theirs = MetricsRegistry(), JaxRegistry()
    _drive(ours)
    _drive(theirs)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.to_openmetrics() == theirs.to_openmetrics()
    assert ours.values("executor.") == theirs.values("executor.")
    assert ours.value("slo.tenant_gens") == 8 and ours.value("absent") == 0
    with pytest.raises(ValueError, match="cannot decrease"):
        ours.count("executor.dispatches", -1)
    with pytest.raises(ValueError, match="already registered"):
        ours.gauge("executor.dispatches")
    with pytest.raises(ValueError, match="buckets"):
        ours.histogram("fit_ms", DEFAULT_MS_BUCKETS)
    with pytest.raises(ValueError, match="strict-JSON"):
        ours.set("x", float("nan"))


def _strip(record):
    if isinstance(record, dict):
        return {k: _strip(v) for k, v in record.items() if k not in WALL}
    if isinstance(record, list):
        return [_strip(v) for v in record]
    return record


def _record_both(tmp_path, recorder_cls, tag):
    fr = recorder_cls(directory=str(tmp_path / tag), process_id=0, process_count=1)
    for g in (2, 4):
        fr.count("slo.tenant_gens", 8)
        fr.set("worker.sigma", 0.5)
        fr.barrier(f"pod:g{g}")
        fr.sample(generation=g)
    fr.event("integrity.heal", generation=4, dissent="first")
    fr.record_search({"enabled": True, "generations": 4, "epoch": 0, "restarts": 0, "width": 8,
                      "ledger": {"sample": {"attempts": 8, "successes": 3, "improvement": 1.5}},
                      "trajectory": {"best_fitness": [1.0, 0.5], "delta": [0.0, 0.5]}})
    fr.record_integrity({"enabled": True, "attestations": 2, "ring": [{"generation": 20}],
                         "verify": {"redispatches": 5, "verified_chunks": 3, "mismatches": 1,
                                    "healed": 1, "aborted": 0}, "verdict": "healed"})
    fr.sample(generation=6)
    return fr


def test_stream_records_equal_jax_and_validate(tmp_path):
    ours = _record_both(tmp_path, FlightRecorder, "port")
    theirs = _record_both(tmp_path, jflightrec.FlightRecorder, "jax")
    got, want = read_stream(tmp_path / "port"), jflightrec.read_stream(tmp_path / "jax")
    assert _strip(got) == _strip(want)
    assert _strip(ours.report()) == _strip(theirs.report())
    assert ours.to_openmetrics() == theirs.to_openmetrics()
    # each stream's chain verifies, and the validator takes it
    assert MetricsStream.verify(str(tmp_path / "port")) == len(got)
    assert check_report.validate_metrics_stream(got) == []


def test_torn_tail_repaired_and_tampered_middle_raises(tmp_path):
    fr = FlightRecorder(directory=str(tmp_path / "torn"))
    for g in range(3):
        fr.count("slo.tenant_gens", 4)
        fr.sample(generation=g)
    raw = fr.stream.path.read_bytes()
    fr.stream.path.write_bytes(raw[:-15])  # a crash mid-append
    assert len(read_stream(tmp_path / "torn")) == 3  # a reader skips, repairs nothing
    assert fr.stream.path.read_bytes() == raw[:-15]
    with pytest.warns(UserWarning, match="torn tail"):
        again = MetricsStream(str(tmp_path / "torn"))
    assert again.torn_tail_dropped == 1 and len(again.records(kind="sample")) == 2
    fr2 = FlightRecorder(directory=str(tmp_path / "torn"))
    fr2.event("svc.resumed")
    assert len(fr2.stream.records(kind="meta")) == 1  # adopted: no second meta

    fr = FlightRecorder(directory=str(tmp_path / "tamper"))
    for g in range(3):
        fr.count("slo.tenant_gens", 4)
        fr.sample(generation=g)
    lines = fr.stream.path.read_text().splitlines()
    middle = json.loads(lines[2])
    middle["counters"]["slo.tenant_gens"] = 999
    lines[2] = json.dumps(middle, sort_keys=True, separators=(",", ":"))
    fr.stream.path.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalIntegrityError):
        MetricsStream(str(tmp_path / "tamper"))
    # the JAX package reads the port's chain the same way
    with pytest.raises(jjournal.JournalIntegrityError):
        jflightrec.MetricsStream(str(tmp_path / "tamper"))


def test_chained_log_rotation_retention_and_journal_kinds(tmp_path):
    """Segments rotate with one chain across them, retention keeps the
    newest pinned record's segment, and both packages adopt the port's
    files alike; ``RunJournal`` refuses unknown kinds and retention."""

    class Log(ChainedLog):
        PIN_KINDS = ("barrier",)

    log = Log(str(tmp_path / "log"), max_segment_bytes=400, retain_segments=2)
    for i in range(12):
        log.append("barrier" if i == 5 else "step", i=i, arr=np.arange(3), t=torch.tensor(1.5))
    assert log.rotations > 0 and log.segments_dropped > 0
    kept = [r["i"] for r in Log(str(tmp_path / "log")).records()]
    assert kept == [r["i"] for r in log.records()] and 5 in kept and kept[-1] == 11

    class JaxLog(jjournal.ChainedLog):
        PIN_KINDS = ("barrier",)

    assert [r["i"] for r in JaxLog(str(tmp_path / "log")).records()] == kept
    assert EVENT_KINDS == jjournal.EVENT_KINDS
    journal = RunJournal(str(tmp_path / "journal"))
    journal.append("attest", generation=10, digest="0" * 48)
    with pytest.raises(ValueError, match="unknown"):
        journal.append("typo")
    with pytest.raises(ValueError, match="retention"):
        RunJournal(str(tmp_path / "j2"), retain_segments=1)
    assert journal.report()["events"] == {"attest": 1}
    assert jjournal.RunJournal(str(tmp_path / "journal")).records(kind="attest")[0]["generation"] == 10
    assert jsonable({"a": np.float32(np.inf), "b": torch.tensor([1, 2])}) == {"a": None, "b": [1, 2]}


def test_merge_pod_streams_equals_jax(tmp_path):
    dirs = []
    for p in range(2):
        d = tmp_path / f"p{p}"
        fr = FlightRecorder(directory=str(d), process_id=p, process_count=2)
        for g in (2, 4):
            fr.count("slo.tenant_gens", 8)
            fr.barrier(f"pod:g{g}")
            fr.sample(generation=g)
        fr.event("worker.done", rank=p)
        dirs.append(d)
    trace_path, merged_path = tmp_path / "trace.json", tmp_path / "merged.jsonl"
    out = merge_pod_streams(dirs, trace_path=str(trace_path),
                            merged_stream_path=str(merged_path))
    want = jflightrec.merge_pod_streams(dirs)
    assert out["processes"] == want["processes"] == 2
    assert out["offsets_s"] == want["offsets_s"] and out["offsets_s"][0] == 0.0
    assert _strip(out["trace"]["traceEvents"]) == _strip(want["trace"]["traceEvents"])
    assert {e["pid"] for e in out["trace"]["traceEvents"]} == {0, PID_STRIDE}
    check = check_report
    assert check.validate_file(str(merged_path)) == []
    assert check.validate_file(str(trace_path)) == []
    none = merge_pod_streams([tmp_path / "p0"])
    assert none["offsets_s"] == [0.0]


def _cso(device="cpu"):
    return StdWorkflow(CSO(-32 * np.ones(16), 32 * np.ones(16), 32, device=device), Ackley(),
                       device=device)


def test_executor_metrics_none_is_an_exact_noop(tmp_path):
    """Workload 12's loop at a small size: ``run_fused`` in chunks with a
    ``FlightRecorder`` and one ``sample`` a chunk, against ``metrics=None``:
    the final states are equal bit for bit, the stream validates, and the
    report's ``metrics`` and ``slo`` sections validate."""
    wf = _cso()
    state = wf.init(42)
    rec = FlightRecorder(directory=str(tmp_path / "stream"))
    instrumented, bare = GenerationExecutor(metrics=rec), GenerationExecutor()
    a = b = state
    for k in range(3):
        a = instrumented.run_fused(wf, a, 4)
        rec.count("slo.tenant_gens", 4)
        rec.sample(generation=(k + 1) * 4)
        b = bare.run_fused(wf, b, 4)
    for (pa, x), (pb, y) in zip(named_leaves(a), named_leaves(b)):
        assert pa == pb
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    counters = rec.registry.snapshot()["counters"]
    assert counters["executor.dispatches"] == 3 and counters["slo.tenant_gens"] == 12
    assert rec.registry.snapshot()["histograms"]["executor.dispatch_ms"]["count"] == 3
    records = read_stream(tmp_path / "stream")
    assert [r["kind"] for r in records].count("sample") == 3
    assert check_report.validate_metrics_stream(records) == []
    report = run_report(wf, a, executor=instrumented, metrics=rec)
    assert report["slo"]["tenant_gens"] == 12 and report["metrics"]["enabled"] is True
    _check_valid(report=report)
    wf._flight_recorder = rec  # advertised by the workflow, as the JAX package reads it
    assert "metrics" in run_report(wf, a)
