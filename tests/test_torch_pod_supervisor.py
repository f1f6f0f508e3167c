"""The port's pod fault domain (``core/pod_supervisor.py``) on the CPU,
against ``evox_tpu/core/pod_supervisor.py`` where the two can be held side
by side.

- ``classify_error`` folds the pod errors as the JAX package's does, and
  ``BarrierTimeoutError`` names the missing processes.
- A supervised deadline is classified ``hung_collective`` (one process: the
  census finds everyone alive) and the next call still runs; any other
  error propagates unchanged; a monkeypatched census gives
  ``coordinator_loss`` and ``worker_dead``; the deadline clamp.
- Through the executor and ``RunSupervisor.run(pod_supervisor=)``: a
  pod-supervised run equals the plain run bit for bit; a drain requested
  mid-run finishes its chunk, fsyncs a final barrier checkpoint and
  journals ``pod_drain``, and ``resume_from_barrier`` to the end equals the
  uninterrupted run; a real SIGTERM is routed into the drain.
- Two processes over gloo with a ``FileStore`` under ``tmp_path``: the
  drain decision crosses the store, then rank 1 stops beating and rank 0's
  census and classification give ``worker_dead``.
- The report section and the trace's markers pass
  ``tools/check_report.py``; the ``pod_*`` journal chain verifies.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core import distributed as td
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.instrument import run_report, write_chrome_trace
from evox_tpu_torch.core.pod_supervisor import (
    COORDINATOR_LOSS,
    HUNG_COLLECTIVE,
    WORKER_DEAD,
    CollectiveDeadlineError,
    PodFailureError,
    PodSupervisor,
)
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer
from evox_tpu_torch.workflows.journal import RunJournal
from evox_tpu_torch.workflows.std import StdWorkflow
from evox_tpu_torch.workflows.supervisor import RunSupervisor

ROOT = Path(__file__).resolve().parent.parent


def _check_report():
    spec = importlib.util.spec_from_file_location("check_report",
                                                  ROOT / "tools" / "check_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pso_wf():
    return StdWorkflow(PSO(-5.0 * torch.ones(4), 5.0 * torch.ones(4), pop_size=8, device="cpu"),
                       Sphere(), device="cpu")


def _leaves_equal(a, b):
    la = [x for x in torch.utils._pytree.tree_leaves(a) if isinstance(x, torch.Tensor)]
    lb = [x for x in torch.utils._pytree.tree_leaves(b) if isinstance(x, torch.Tensor)]
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ------------------------------------------------------------ classification


def test_classify_error_folds_pod_errors_as_jax_does():
    """Barrier and collective deadlines are ``deadline``, a classified pod
    fault ``fatal``, in both packages."""
    from evox_tpu.core import distributed as jd
    from evox_tpu.core import pod_supervisor as jps
    from evox_tpu.workflows.supervisor import classify_error as jax_classify
    from evox_tpu_torch.workflows.supervisor import DEADLINE, FATAL, classify_error

    pairs = [
        (td.BarrierTimeoutError("b", 5.0, [0], [1]), jd.BarrierTimeoutError("b", 5.0, [0], [1])),
        (CollectiveDeadlineError("hung"), jps.CollectiveDeadlineError("hung")),
        (PodFailureError("x", WORKER_DEAD, {}), jps.PodFailureError("x", jps.WORKER_DEAD, {})),
        (PodFailureError("x", HUNG_COLLECTIVE, {}),
         jps.PodFailureError("x", jps.HUNG_COLLECTIVE, {})),
    ]
    got = [classify_error(mine) for mine, _ in pairs]
    assert got == [jax_classify(theirs) for _, theirs in pairs]
    assert got == [DEADLINE, DEADLINE, FATAL, FATAL]
    import evox_tpu_torch.core.pod_supervisor as tps

    assert (tps.POD_FAILURE_CLASSES, tps.POD_EVENT_KINDS) == (jps.POD_FAILURE_CLASSES,
                                                            jps.POD_EVENT_KINDS)


def test_barrier_timeout_error_names_processes():
    e = td.BarrierTimeoutError("gen4", 5.0, arrived=[0, 2], missing=[1])
    assert e.missing == [1] and e.arrived == [0, 2]
    assert "[1]" in str(e) and "gen4" in str(e)


def test_supervised_deadline_is_hung_collective_and_the_next_call_runs():
    """One process: the census is everyone alive, so a deadline hit is
    ``hung_collective``, with the latency and event tail in the
    post-mortem; the abandoned thread holds nothing the next call needs."""
    sup = PodSupervisor(deadline_s=0.2, heartbeat_interval_s=0.05).start()
    try:
        with pytest.raises(PodFailureError) as ei:
            sup.supervised(lambda: time.sleep(5.0), entry="chunk")
        assert ei.value.classification == HUNG_COLLECTIVE
        pm = ei.value.post_mortem
        assert pm["entry"] == "chunk" and 0.2 <= pm["detect_s"] < 5.0
        assert pm["census"] == {"alive": [0], "dead": []}
        assert sup.report()["outcome"] == "failed" and sup.counters["failures"] == 1
        wf = _pso_wf()
        state = sup.supervised(lambda: wf.run(wf.init(1), 3), entry="next")
        _leaves_equal(state, wf.run(wf.init(1), 3))
    finally:
        sup.stop()


def test_supervised_propagates_non_pod_errors():
    sup = PodSupervisor(deadline_s=5.0).start()
    try:
        with pytest.raises(ValueError, match="not a pod fault"):
            sup.supervised(lambda: (_ for _ in ()).throw(ValueError("not a pod fault")))
        assert sup.report()["outcome"] == "clean"
    finally:
        sup.stop()


@pytest.mark.parametrize("census,want", [
    ("raise", COORDINATOR_LOSS), ({0: True, 1: False}, WORKER_DEAD),
    ({0: True, 1: True}, HUNG_COLLECTIVE)])
def test_classify_failure_from_the_census(monkeypatch, census, want):
    sup = PodSupervisor(deadline_s=1.0)
    if census == "raise":
        def read(*a, **k):
            raise ConnectionError("the store is unavailable")
    else:
        def read(*a, **k):
            return census
    monkeypatch.setattr(sup, "census", read)
    assert sup.classify_failure(CollectiveDeadlineError("x")) == want
    assert sup.classify_failure(ValueError("numerics")) is None


def test_deadline_clamped_against_the_abort_bound(monkeypatch, recwarn):
    """In a process group a deadline that cannot classify a fault within
    the abort bound is clamped (budget 10 - 0.5 - (2 * interval + 0.2)),
    the derived checkpoint deadline with it; a deadline inside the budget,
    or any in one process, passes unchanged."""
    monkeypatch.setattr(td, "process_count", lambda: 4)
    with pytest.warns(UserWarning, match="clamping"):
        sup = PodSupervisor(deadline_s=30.0, heartbeat_interval_s=1.0)
    assert sup.deadline_s == pytest.approx(7.3)
    assert sup.checkpoint_deadline_s == pytest.approx(6.0 * 7.3)
    with pytest.warns(UserWarning, match="clamping"):
        sup2 = PodSupervisor(deadline_s=30.0, heartbeat_interval_s=1.0,
                             checkpoint_deadline_s=120.0)
    assert sup2.checkpoint_deadline_s == 120.0
    assert PodSupervisor(deadline_s=5.0, heartbeat_interval_s=1.0).deadline_s == 5.0
    monkeypatch.setattr(td, "process_count", lambda: 1)
    assert PodSupervisor(deadline_s=30.0, heartbeat_interval_s=1.0).deadline_s == 30.0
    assert not [w for w in recwarn if "clamp" in str(w.message)]


# ------------------------------------------------------- through the executor


@pytest.mark.parametrize("route", ["executor", "run_supervisor"])
def test_pod_supervised_run_equals_the_plain_run(tmp_path, route):
    """A pod supervisor that never fires changes nothing: the executor's
    run and ``RunSupervisor.run(pod_supervisor=)`` equal a plain run bit
    for bit, and the workflow advertises the supervisor."""
    wf = _pso_wf()
    state0 = wf.init(3)
    plain = wf.run(state0, 6)
    sup = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1).start()
    try:
        ck = WorkflowCheckpointer(str(tmp_path / "ck"), every=2)
        if route == "executor":
            got = GenerationExecutor(pod_supervisor=sup).run_fused(wf, state0, 6, checkpointer=ck,
                                                                   chunk=2)
        else:
            got = RunSupervisor(ck, deadline_s=60.0).run(wf, state0, 6, pod_supervisor=sup)
    finally:
        sup.stop()
    _leaves_equal(plain, got)
    assert wf._pod_supervisor is sup
    rep = sup.report()
    assert rep["outcome"] == "clean" and rep["counters"]["supervised_calls"] == 3


def test_drain_finishes_the_chunk_and_the_resume_equals_the_uninterrupted_run(tmp_path):
    """A drain requested while a chunk is in flight: the chunk finishes, a
    final barrier checkpoint is written and journaled
    ``pod_drain``, and ``resume_from_barrier`` run to the end equals the
    uninterrupted run bit for bit."""
    wf = _pso_wf()
    state0 = wf.init(5)
    straight = wf.run(state0, 9)
    jdir = tmp_path / "journal"
    sup = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1, journal=str(jdir)).start()
    ck = WorkflowCheckpointer(str(tmp_path / "ck"), every=3)
    orig = wf.run
    fired = []

    def run(st, n):
        out = orig(st, n)
        if not fired:
            fired.append(int(out.generation))
            sup.request_drain("test-preemption")
        return out

    wf.run = run
    try:
        drained = GenerationExecutor(pod_supervisor=sup).run_fused(wf, state0, 9, checkpointer=ck,
                                                                   chunk=3)
    finally:
        wf.run = orig
    assert int(drained.generation) == 3 == fired[0]
    rep = sup.report()
    assert rep["outcome"] == "drained"
    assert [e["event"] for e in rep["events"]][-2:] == ["drain_requested", "drain"]
    assert int(ck.latest(expect_like=state0).generation) == 3
    resumed = sup.resume_from_barrier(wf, str(tmp_path / "ck"), expect_like=state0)
    assert int(resumed.generation) == 3 and sup.report()["outcome"] == "resumed"
    _leaves_equal(wf.run(resumed, 6), straight)
    sup.stop()
    kinds = [r["kind"] for r in RunJournal(str(jdir)).records()]
    assert kinds == ["pod_join", "pod_drain", "pod_resume"]
    assert RunJournal.verify(str(jdir)) == 3


def test_real_sigterm_routes_into_the_drain(tmp_path):
    wf = _pso_wf()
    state0 = wf.init(7)
    sup = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1).start()
    sup.install_sigterm_drain()
    orig, pid = wf.run, os.getpid()

    def run(st, n):
        out = orig(st, n)
        if int(out.generation) == 2:
            os.kill(pid, signal.SIGTERM)  # the preemption notice
            time.sleep(0.2)  # the main thread takes the signal
        return out

    wf.run = run
    try:
        drained = GenerationExecutor(pod_supervisor=sup).run_fused(
            wf, state0, 10, checkpointer=WorkflowCheckpointer(str(tmp_path / "ck"), every=2),
            chunk=2)
        assert int(drained.generation) == 2
        rep = sup.report()
        assert rep["outcome"] == "drained"
        ev = next(e for e in rep["events"] if e["event"] == "drain_requested")
        assert ev["reason"] == "SIGTERM"
    finally:
        wf.run = orig
        sup.stop()  # gives SIGTERM its handler back
    assert signal.getsignal(signal.SIGTERM) is not None


def test_report_and_markers_validate(tmp_path):
    """A failed pod's report (classification, census, monotonic clock)
    passes the validator inside ``run_report``, and its markers land on the
    trace as ``supervisor:pod:*`` instants that the trace validator
    accepts; the failure is journaled."""
    jdir = str(tmp_path / "journal")
    sup = PodSupervisor(deadline_s=0.2, heartbeat_interval_s=0.05, journal=jdir).start()
    try:
        with pytest.raises(PodFailureError):
            sup.supervised(lambda: time.sleep(2.0))
    finally:
        sup.stop()
    wf = _pso_wf()
    wf._pod_supervisor = sup
    st = wf.init(0)
    rep = run_report(wf, st)
    cr = _check_report()
    assert cr.validate_run_report(json.loads(json.dumps(rep))) == []
    assert rep["pod_supervisor"]["outcome"] == "failed"
    trace = write_chrome_trace(str(tmp_path / "trace.json"), workflow=wf, state=st)
    assert cr.validate_chrome_trace(trace) == []
    names = [e["name"] for e in trace["traceEvents"] if e.get("pid") == 5 and e["ph"] == "i"]
    assert names == [m["name"] for m in sup.markers()]
    assert names[0] == "supervisor:pod:join" and "supervisor:pod:failure" in names
    assert [r["kind"] for r in RunJournal(jdir).records()] == ["pod_join", "pod_failure"]


# ------------------------------------------------------ two processes, gloo

_WORKER = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from evox_tpu_torch.core import distributed as d
    from evox_tpu_torch.core.pod_supervisor import CollectiveDeadlineError, PodSupervisor

    rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    d.init_distributed("file://" + store_path, num_processes=2, process_id=rank,
                       backend="gloo", timeout_s=60)
    sup = PodSupervisor(deadline_s=2.0, heartbeat_interval_s=0.1).start()
    sup.barrier("up", timeout_s=30)
    res = {{"world": [sup.process_id, sup.process_count]}}
    if rank == 1:
        sup.request_drain("peer preempted")
    res["decision"] = sup.chunk_boundary(1, timeout_s=30)
    store = d.dist_store()
    if rank == 1:
        sup.stop()  # the heartbeat freezes: what a census reads as death
        store.set("test/r1_stopped", "1")
        store.wait(["test/done"])
    else:
        store.wait(["test/r1_stopped"])
        res["census"] = {{str(k): v for k, v in sup.census().items()}}
        res["classified"] = sup.classify_failure(CollectiveDeadlineError("x"))
        try:
            sup.barrier("never", timeout_s=0.5)
        except Exception as e:
            res["barrier"] = [type(e).__name__, e.classification,
                              e.post_mortem["census"]]
        res["heartbeats"] = sup.counters["heartbeats"]
        store.set("test/done", "1")
    json.dump(res, open(out, "w"))
""")


def test_two_processes_rank_one_stops_beating_and_is_worker_dead(tmp_path):
    """Two processes over gloo (a ``FileStore``, no network): rank 1's drain
    request reaches rank 0 through process 0's decision, then rank 1 stops
    its heartbeat; rank 0's census finds it dead, a deadline classifies as
    ``worker_dead``, and a barrier rank 1 never reaches raises a
    ``PodFailureError`` naming it."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(root=str(ROOT)))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(tmp_path / "store"),
                               str(tmp_path / f"out{r}.json")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    res = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in (0, 1)]
    assert [r["world"] for r in res] == [[0, 2], [1, 2]]
    assert res[0]["decision"] == res[1]["decision"] == "drain"
    assert res[0]["census"] == {"0": True, "1": False}
    assert res[0]["classified"] == WORKER_DEAD
    assert res[0]["barrier"] == ["PodFailureError", WORKER_DEAD, {"alive": [0], "dead": [1]}]
    assert res[0]["heartbeats"] >= 2
