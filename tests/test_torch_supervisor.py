"""``RunSupervisor`` in the port (``evox_tpu_torch/workflows/supervisor.py``)
on the CPU: the laws of ``tests/test_supervisor.py``.

- The classifier folds PyTorch's failures (``torch.cuda.OutOfMemoryError``,
  "CUDA error: ..." strings, ``torch.distributed``'s backend, network and
  store errors, gloo's and NCCL's timeouts) into the JAX package's five
  classes, and agrees with the JAX classifier on Python's own exceptions.
- The deadline fires within twice its bound (a fake hang, no long sleep).
- Retry and restore replay the clean run bit for bit; an OOM on a
  pipelined host run halves the evaluation chunk and still ends bit for
  bit; an exhausted ladder raises ``RunAbortedError`` with its post-mortem;
  restores are bounded a run; a fatal error aborts at once.
- The ``supervisor`` section and the trace's markers pass
  ``tools/check_report.py`` and carry the JAX package's keys.
- A run checkpointed on an 8-shard mesh resumes on 4 and on 1 shard(s),
  bit for bit with the straight run.
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.workflows.supervisor import RunSupervisor as JaxRunSupervisor
from evox_tpu.workflows.supervisor import classify_error as jax_classify_error
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.attest import IntegrityError
from evox_tpu_torch.core.distributed import BarrierTimeoutError, create_mesh
from evox_tpu_torch.core.instrument import run_report, write_chrome_trace
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer
from evox_tpu_torch.workflows.pipelined import run_host_pipelined
from evox_tpu_torch.workflows.supervisor import (DEADLINE, FATAL, INTEGRITY, OOM, TRANSIENT,
                                                 DispatchDeadlineError, RunAbortedError,
                                                 RunSupervisor, classify_error)

_spec = importlib.util.spec_from_file_location(
    "check_report", Path(__file__).resolve().parent.parent / "tools" / "check_report.py")
check_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_report)

POP, DIM = 32, 6


def _wf(mesh=None, problem=None):
    return StdWorkflow(PSO(-5 * torch.ones(DIM), 5 * torch.ones(DIM), pop_size=POP, device="cpu"),
                       problem or Sphere(), device="cpu", mesh=mesh)


class _Faults:
    """``wf.run`` with a fault on chosen calls (1-based)."""

    def __init__(self, wf, faults):
        self.run, self.faults, self.calls = wf.run, dict(faults), 0

    def __call__(self, state, n, *args, **kwargs):
        self.calls += 1
        fault = self.faults.get(self.calls)
        if fault is not None:
            raise fault
        return self.run(state, n, *args, **kwargs)


def _equal(a, b):
    for name in ("population", "velocity", "pbest_position", "pbest_fitness", "gbest_fitness"):
        assert torch.equal(getattr(a.algo, name), getattr(b.algo, name)), name
    assert int(a.generation) == int(b.generation)


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), OOM),
    (RuntimeError("CUDA error: out of memory"), OOM),
    (MemoryError(), OOM),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), FATAL),
    (RuntimeError("CUDA error: unspecified launch failure"), FATAL),
    (torch.distributed.DistBackendError("NCCL communicator was aborted on rank 1"), TRANSIENT),
    (torch.distributed.DistNetworkError("Connection reset by peer"), TRANSIENT),
    (torch.distributed.DistStoreError("wait timeout after 30000ms"), TRANSIENT),
    (RuntimeError("[gloo/transport/tcp/pair.cc:598] Connection closed by peer"), TRANSIENT),
    (RuntimeError("Timed out waiting 1800000ms for recv operation to complete"), TRANSIENT),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=7, "
                  "OpType=ALLREDUCE) ran for 600000 milliseconds before timing out."), DEADLINE),
    (DispatchDeadlineError("x"), DEADLINE),
    (BarrierTimeoutError("b", 1.0, [0], [1]), DEADLINE),
    (IntegrityError("digest mismatch"), INTEGRITY),
    (RunAbortedError("the run aborted", {}), FATAL),
    (ValueError("a bug"), FATAL),
], ids=lambda v: v if isinstance(v, str) else type(v).__name__)
def test_classifier_folds_torch_failures(exc, kind):
    assert classify_error(exc) == kind


def test_classifier_agrees_with_jax_on_python_exceptions():
    for exc in (ConnectionResetError("reset"), TimeoutError(), MemoryError(), ValueError("x"),
                OSError("disk"), KeyError("k"), RuntimeError("socket closed"),
                RuntimeError("payload too large: HTTP 413")):
        assert classify_error(exc) == jax_classify_error(exc), exc


def test_deadline_fires_within_twice_its_bound():
    sup = RunSupervisor(deadline_s=0.3, max_retries=0)
    release = []

    def hang():  # a fake hang: waits for a release that never comes
        for _ in range(200):
            if release:
                return 1
            time.sleep(0.01)
        return 1

    t0 = time.perf_counter()
    with pytest.raises(RunAbortedError) as info:
        sup.call(hang, entry="hang")
    assert time.perf_counter() - t0 < 0.6
    release.append(True)
    assert isinstance(info.value.__cause__, DispatchDeadlineError)
    assert sup.counters["deadline_hits"] == 1 and sup.report()["outcome"] == "aborted"


def test_an_abandoned_dispatch_counts_no_time():
    """A chunk the deadline abandons ends after its retry: the executor
    counts the retry's dispatch time and not the abandoned call's, so the
    dispatch total stays inside the run's wall (``tools/check_report.py``'s
    coherence law), whenever the abandoned thread ends."""
    from evox_tpu_torch.core.executor import GenerationExecutor

    ex = GenerationExecutor()
    sup = RunSupervisor(deadline_s=0.2, max_retries=1)
    calls, release = [], []

    def chunk():
        calls.append(1)
        if len(calls) == 1:  # the first call hangs until released
            while not release:
                time.sleep(0.01)
        return len(calls)

    t0 = time.perf_counter()
    assert sup.call(lambda: ex._timed_dispatch("run", chunk), entry="run") == 2
    wall = time.perf_counter() - t0
    release.append(True)
    time.sleep(0.1)  # the abandoned thread returns now
    assert sup.counters["deadline_hits"] == 1
    assert ex.overlap["device_dispatch_s"] < wall
    assert [s["name"] for s in ex._trace_spans] == ["run"]


def test_retry_and_restore_replay_the_clean_run(tmp_path):
    clean = _wf().run(_wf().init(3), 30)
    wf = _wf()
    wf.run = _Faults(wf, {2: RuntimeError("Connection reset by peer"),
                          4: torch.cuda.OutOfMemoryError("CUDA out of memory.")})
    sup = RunSupervisor(WorkflowCheckpointer(str(tmp_path), every=10), backoff_s=0.0)
    state = sup.run(wf, wf.init(3), 30)
    _equal(state, clean)
    c = sup.report()["counters"]
    assert (c["retries"], c["restores"], c["aborts"]) == (1, 1, 0)
    assert sup.report()["outcome"] == "recovered"


class _HostSphere:
    """A host problem that runs out of memory above ``limit`` rows."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self, limit=None):
        self.limit = limit

    def init(self, seed=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        pop = np.asarray(pop)
        if self.limit is not None and pop.shape[0] > self.limit:
            raise torch.cuda.OutOfMemoryError(f"CUDA out of memory at {pop.shape[0]} rows")
        return np.sum(pop ** 2, axis=1).astype(np.float32), state


def test_oom_halves_the_eval_chunk_bit_for_bit():
    clean = run_host_pipelined(_wf(problem=_HostSphere()), _wf(problem=_HostSphere()).init(1), 6)
    wf = _wf(problem=_HostSphere(limit=8))
    sup = RunSupervisor(min_eval_chunk=4)
    state = sup.run_host_pipelined(wf, wf.init(1), 6, chunk=3)
    _equal(state, clean)
    assert sup.counters["degradations"] == 2  # 32 -> 16 -> 8 rows
    with pytest.raises(RunAbortedError):
        RunSupervisor(min_eval_chunk=16).run_host_pipelined(_wf(problem=_HostSphere(limit=8)),
                                                             wf.init(1), 2)


def test_exhausted_ladder_post_mortem_and_restore_budget(tmp_path):
    wf = _wf()
    wf.run = _Faults(wf, {i: RuntimeError("Connection refused") for i in range(2, 50)})
    sup = RunSupervisor(WorkflowCheckpointer(str(tmp_path), every=5), max_retries=2,
                        max_restores=1, backoff_s=0.0)
    with pytest.raises(RunAbortedError) as info:
        sup.run(wf, wf.init(0), 20)
    pm = info.value.post_mortem
    assert set(pm) >= {"entry", "error", "classification", "ladder", "counters", "events_tail"}
    assert pm["classification"] == TRANSIENT and pm["ladder"]["rung"] == "exhausted"
    # one restore a run, however many chunks fail
    assert sup.counters["restores"] == 1 and sup.counters["aborts"] == 1
    assert sup.counters["retries"] == 4  # two before the restore, two after


def test_fatal_error_aborts_at_once():
    wf = _wf()
    wf.run = _Faults(wf, {1: ValueError("a bug in the step")})
    sup = RunSupervisor(backoff_s=0.0)
    with pytest.raises(RunAbortedError) as info:
        sup.run(wf, wf.init(0), 5)
    assert info.value.post_mortem["ladder"] == {"rung": "fatal"}
    assert sup.counters["dispatches"] == 1 and sup.counters["retries"] == 0


def test_report_section_and_trace_markers(tmp_path):
    wf = _wf()
    wf.run = _Faults(wf, {2: RuntimeError("Connection reset by peer")})
    sup = RunSupervisor(WorkflowCheckpointer(str(tmp_path), every=4), backoff_s=0.0)
    state = sup.run(wf, wf.init(0), 8)
    report = run_report(wf, state)
    assert check_report.validate_run_report(json.loads(json.dumps(report))) == []
    assert set(report["supervisor"]) == set(JaxRunSupervisor().report())
    assert set(report["supervisor"]["counters"]) == set(JaxRunSupervisor().counters)
    trace = write_chrome_trace(str(tmp_path / "trace.json"), workflow=wf, state=state)
    assert check_report.validate_chrome_trace(trace) == []
    assert [e["name"] for e in trace["traceEvents"] if e.get("cat") == "supervisor"] == [
        "supervisor:retry"]


def test_resume_across_8_4_1_shard_meshes(tmp_path):
    """A run checkpointed on an 8-shard mesh resumes on 4 and on 1 and
    reproduces the straight run, bit for bit."""
    mesh8 = create_mesh(devices=["cpu"] * 8)
    straight = _wf(mesh8).run(_wf(mesh8).init(11), 20)
    mid = _wf(mesh8).run(_wf(mesh8).init(11), 10,
                         checkpointer=WorkflowCheckpointer(str(tmp_path), every=5))
    assert int(mid.generation) == 10
    for n in (4, 1):
        wf = _wf(create_mesh(devices=["cpu"] * n))
        _equal(wf.resume(WorkflowCheckpointer(str(tmp_path), every=5), 20), straight)
