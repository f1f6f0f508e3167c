"""The port's multi-pod control plane (``workflows/control_plane.py``) and
the queue's steal (``RunQueue.release_continuation``) on the CPU, against
``evox_tpu/workflows/control_plane.py`` where the two can be held side by
side, at ``bench.py``'s serving sizes (width 2, pop 16, d 16, chunk 4).

- ``_parse_bucket_key``, ``_derive_outstanding``, the spec codecs and the
  ledger's kinds equal the JAX package's; a record the port writes decodes
  under JAX's ``_elastic_spec_from_record`` to the same spec.
- ``release_continuation`` gives the JAX queue's descriptor and journal
  ``steal`` record, and the port's ``RunQueue.recover`` honours it.
- The ledger's decisions (kind, tag, pod, source, target, in order) equal
  the JAX plane's on one seeded trace with one pod declared dead: placement
  reads budgets and load, never fitness.
- On the port alone: placement and the report's validation, a pod's death
  mid-sweep against the no-death run (completed results and telemetry
  fingerprints), a parked continuation stolen with its checkpoint, the pod
  autoscaler, and the kill laws: a steal killed between "durable in the
  target" and the ledger's ``steal`` (in-process, and a real SIGKILL of a
  gateway child), then ``ControlPlane.recover``, equals the uncrashed plane
  with each spec admitted once. The real kills are ``control_chaos``; the
  kill-anywhere matrix is also ``slow``.

The gateway child's entry is this file run as a script (``__main__``
below); it imports neither JAX nor the JAX package.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.instrument import run_report
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows import control_plane as cp
from evox_tpu_torch.workflows.control_plane import (
    ControlLedger,
    ControlPlane,
    PodAutoscaler,
    _derive_outstanding,
    _elastic_spec_from_record,
    _elastic_spec_record,
    _parse_bucket_key,
)
from evox_tpu_torch.workflows.elastic import ACTIVE_ROWS, ElasticSpec, ElasticWorkflow
from evox_tpu_torch.workflows.journal import jsonable

REPO = Path(__file__).resolve().parent.parent
WIDTH, POP, DIM, CHUNK = 2, 16, 16, 4  # bench.py's SRV_WIDTH, pop, SRV_DIM, SRV_CHUNK


def make_factory(shape):
    """The bucket factory: PSO (lb -5, ub 5) on Sphere with a
    ``TelemetryMonitor(capacity=8)``, ``bench.py``'s serving factory."""
    algo = PSO(-5.0 * torch.ones(shape.dim), 5.0 * torch.ones(shape.dim), pop_size=shape.pop,
               device="cpu")
    return ElasticWorkflow(algo, Sphere(), n_tenants=shape.width,
                           hyperparams={ACTIVE_ROWS: np.full((shape.width,), shape.pop, np.int32)},
                           monitors=(TelemetryMonitor(capacity=8, device="cpu"),), device="cpu")


def churn_specs(n):
    """``bench.py``'s control-plane trace: seeds 3000 up, budgets of 2, 3
    and 4 chunks, one bucket, no deadline (a stolen tenant's deadline would
    be counted on another pod's fleet clock)."""
    return [ElasticSpec(seed=3000 + i, n_steps=(2 + i % 3) * CHUNK, pop=POP, dim=DIM,
                        tag=f"cp{i:04d}") for i in range(n)]


def build_plane(root, n_pods=2, chunk=CHUNK, **kw):
    return ControlPlane(make_factory, str(root), n_pods=n_pods, width=WIDTH, chunk=chunk, **kw)


def recover_plane(root, chunk=CHUNK, **kw):
    return ControlPlane.recover(make_factory, str(root), width=WIDTH, chunk=chunk, **kw)


def result_digest(results):
    """Completed entries only (tag, generations, telemetry fingerprints),
    by tag: placement (pod, bucket) is left out, the law is that results do
    not depend on it."""
    return sorted((r["tag"], r["generations"], tuple(r.get("fingerprints") or ()))
                  for r in results if r["status"] == "completed")


def _check_report():
    spec = importlib.util.spec_from_file_location("check_report",
                                                  REPO / "tools" / "check_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_duplicates(plane):
    rep = plane.report()
    assert rep["exactly_once"]["duplicate_admissions"] == {}
    return rep


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("name", ["pop64_dim12_w4", "pop16_dim16_w2", "cache", "pop8_dim4",
                                  "pop8_dim4_w2_x", "xpop8_dim4_w2"])
def test_parse_bucket_key_equals_jax(name):
    from evox_tpu.workflows import control_plane as jcp

    got, want = _parse_bucket_key(name), jcp._parse_bucket_key(name)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.as_tuple() == (want.pop, want.dim, want.width) and got.key == want.key == name


def test_ledger_kinds_and_derive_outstanding_equal_jax(tmp_path):
    """The ledger's file, schema and kinds are the JAX package's, retention
    is refused, and the host-only post-mortem partitions one journal as
    JAX's does (terminal, moved and stolen seqs closed, padding dropped)."""
    from evox_tpu.workflows import control_plane as jcp

    assert (ControlLedger.FILENAME, ControlLedger.SCHEMA, ControlLedger.KINDS) == (
        jcp.ControlLedger.FILENAME, jcp.ControlLedger.SCHEMA, jcp.ControlLedger.KINDS)
    led = ControlLedger(str(tmp_path))
    led.append("pod_open", pod="pod00")
    with pytest.raises(ValueError, match="unknown ControlLedger event kind"):
        led.append("not_a_kind", x=1)
    with pytest.raises(ValueError, match="retention"):
        ControlLedger(str(tmp_path / "r"), retain_segments=2)
    assert [r["kind"] for r in ControlLedger(str(tmp_path)).records()] == ["pod_open"]
    recs = [
        {"kind": "submit", "spec_seq": 0, "tag": "a"},
        {"kind": "submit", "spec_seq": 1, "tag": "b"},
        {"kind": "submit", "spec_seq": 2, "tag": "_pad_0001"},
        {"kind": "submit", "spec_seq": 3, "tag": "c"},
        {"kind": "submit", "spec_seq": 5, "tag": "d"},
        {"kind": "retire", "spec_seq": 0,
         "entry": {"tag": "a", "status": "completed", "generations": 5}},
        {"kind": "preempt", "spec_seq": 1, "entry": {"tag": "b"}},
        {"kind": "submit", "spec_seq": 4, "tag": "b", "resume_from": "/ck/b", "done": 3},
        {"kind": "retire", "spec_seq": 2, "entry": {"tag": "_pad_0001", "status": "completed"}},
        {"kind": "steal", "spec_seq": 3, "tag": "c"},
        {"kind": "evict", "spec_seq": 5,
         "entry": {"tag": "d", "status": "evicted", "generations": 2}},
        {"kind": "chunk_complete", "generation": 3},
    ]
    assert _derive_outstanding(recs) == jcp._derive_outstanding(recs)
    outstanding, completed = _derive_outstanding(recs)
    assert [r["spec_seq"] for r in outstanding] == [4]
    assert [e["tag"] for e in completed] == ["a", "d"]
    assert PodAutoscaler(scale_up_depth=6, max_pods=3).report() == jcp.PodAutoscaler(
        scale_up_depth=6, max_pods=3).report()


@pytest.mark.parametrize("seed", [7, np.asarray([0, 42], np.uint32)], ids=["int", "key_words"])
def test_spec_codecs_equal_jax(seed):
    """The ledger's ``submit`` payload is the JAX package's, and each
    package decodes the other's record to the same spec."""
    from evox_tpu.workflows import control_plane as jcp
    from evox_tpu.workflows import elastic as jel

    kw = dict(n_steps=12, pop=16, dim=16, hyperparams={"w": np.float32(0.5)}, tag="t1",
              deadline=40)
    port_rec = jsonable(_elastic_spec_record(ElasticSpec(seed=seed, **kw)))
    jax_rec = jsonable(jcp._elastic_spec_record(jel.ElasticSpec(seed=seed, **kw)))
    assert port_rec == jax_rec
    for rec in (port_rec, jax_rec):
        mine, theirs = _elastic_spec_from_record(rec), jcp._elastic_spec_from_record(rec)
        for field in ("n_steps", "pop", "dim", "tag", "deadline"):
            assert getattr(mine, field) == getattr(theirs, field), field
        np.testing.assert_array_equal(np.asarray(mine.seed), np.asarray(theirs.seed))
        assert np.asarray(mine.hyperparams["w"]) == np.asarray(theirs.hyperparams["w"])


def _port_queue(journal_dir):
    from evox_tpu_torch.workflows.tenancy import RunQueue, TenantSpec

    wf = make_factory(cp.BucketShape(POP, DIM, WIDTH))
    q = RunQueue(wf, chunk=CHUNK, journal=str(journal_dir))
    for i in range(6):
        q.submit(TenantSpec(seed=i, n_steps=5 + i, hyperparams={ACTIVE_ROWS: np.int32(POP)},
                            tag=f"job{i:02d}"))
    return q


def _jax_queue(journal_dir):
    import jax.numpy as jnp

    from evox_tpu import RunQueue, TenantSpec
    from evox_tpu.algorithms.so.pso import PSO as JaxPSO
    from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
    from evox_tpu.problems.numerical import Sphere as JaxSphere
    from evox_tpu.workflows import elastic as jel

    wf = jel.ElasticWorkflow(
        JaxPSO(lb=-5.0 * jnp.ones(DIM), ub=5.0 * jnp.ones(DIM), pop_size=POP), JaxSphere(),
        n_tenants=WIDTH, hyperparams={jel.ACTIVE_ROWS: jnp.full((WIDTH,), POP, jnp.int32)},
        monitors=(JaxTelemetryMonitor(capacity=8),))
    q = RunQueue(wf, chunk=CHUNK, journal=str(journal_dir))
    for i in range(6):
        q.submit(TenantSpec(seed=i, n_steps=5 + i, hyperparams={jel.ACTIVE_ROWS: np.int32(POP)},
                            tag=f"job{i:02d}"))
    return q


def _steal_fields(rec):
    return {k: rec.get(k) for k in ("kind", "spec_seq", "tag", "checkpoint")}


def test_release_continuation_matches_jax_and_recover_honours_it(tmp_path):
    """Releasing queued work journals the JAX queue's ``steal`` record and
    returns its descriptor; an unknown seq raises ``KeyError``, an
    in-memory continuation on a journaled queue ``ValueError``; the
    recovered queue does not requeue the stolen seq. No fleet runs: the
    release acts on the queue before ``start()``."""
    from evox_tpu_torch.workflows.tenancy import RunQueue, TenantSpec

    q, jq = _port_queue(tmp_path / "p"), _jax_queue(tmp_path / "j")
    seq = q.pending[2]._journal_seq
    assert seq == jq.pending[2]._journal_seq
    desc, jdesc = q.release_continuation(seq), jq.release_continuation(seq)
    assert desc == jdesc == {"seq": seq, "tag": "job02", "checkpoint": None, "done": None}
    assert q.counters["stolen"] == jq.counters["stolen"] == 1
    assert ([_steal_fields(r) for r in q.journal.records("steal")]
            == [_steal_fields(r) for r in jq.journal.records("steal")])
    for queue in (q, jq):
        with pytest.raises(KeyError):
            queue.release_continuation(10_000)
    # an in-memory continuation cannot be released from a journaled queue
    q.continuations.append({"spec": TenantSpec(seed=9, n_steps=5, tag="mem"), "seq": 99,
                            "checkpoint": None, "state": object(), "done": 1})
    with pytest.raises(ValueError, match="in-memory continuation"):
        q.release_continuation(99)
    recovered = RunQueue.recover(make_factory(cp.BucketShape(POP, DIM, WIDTH)),
                                 str(tmp_path / "p"))
    assert sorted(s.tag for s in recovered.pending) == [f"job{i:02d}" for i in (0, 1, 3, 4, 5)]
    assert recovered.counters["submitted"] == 6


def _decisions(records):
    keep = ("pod_open", "submit", "place", "pod_dead", "steal", "pod_close", "autoscale",
            "recover")
    return [(r["kind"], r.get("tag"), r.get("pod"), r.get("from_pod"), r.get("to_pod"),
             r.get("bucket"), r.get("source_seq")) for r in records if r["kind"] in keep]


def test_ledger_decisions_equal_jax_with_a_dead_pod(tmp_path):
    """One seeded trace of 12 tenants over 3 pods, 2 rounds, ``pod00``
    declared dead, then served to the end, through both gateways: the
    ledgers' decisions agree record for record (placement by load, the
    steals' targets and source seqs), the submit payloads too."""
    import jax.numpy as jnp

    from evox_tpu.algorithms.so.pso import PSO as JaxPSO
    from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
    from evox_tpu.problems.numerical import Sphere as JaxSphere
    from evox_tpu.workflows import control_plane as jcp
    from evox_tpu.workflows import elastic as jel

    def jax_factory(shape):
        algo = JaxPSO(lb=-5.0 * jnp.ones(shape.dim), ub=5.0 * jnp.ones(shape.dim),
                      pop_size=shape.pop)
        return jel.ElasticWorkflow(
            algo, JaxSphere(), n_tenants=shape.width,
            hyperparams={jel.ACTIVE_ROWS: jnp.full((shape.width,), shape.pop, jnp.int32)},
            monitors=(JaxTelemetryMonitor(capacity=8),))

    def drive(plane, specs):
        for s in specs:
            plane.submit(s)
        plane.serve(max_rounds=2)
        plane.mark_dead("pod00", reason="test")
        return plane.serve()

    n = 12
    port = build_plane(tmp_path / "port", n_pods=3)
    port_res = drive(port, churn_specs(n))
    jplane = jcp.ControlPlane(jax_factory, str(tmp_path / "jax"), n_pods=3, width=WIDTH,
                              chunk=CHUNK)
    jax_res = drive(jplane, [jel.ElasticSpec(seed=s.seed, n_steps=s.n_steps, pop=s.pop,
                                             dim=s.dim, tag=s.tag) for s in churn_specs(n)])
    assert _decisions(port.ledger.records()) == _decisions(jplane.ledger.records())
    strip = ("schema", "seq", "t", "prev", "sha")
    assert ([{k: v for k, v in r.items() if k not in strip} for r in port.ledger.records("submit")]
            == [{k: v for k, v in r.items() if k not in strip}
                for r in jplane.ledger.records("submit")])
    assert port.counters == jplane.counters
    assert ([(t, g) for t, g, _ in result_digest(port_res)]
            == sorted((r["tag"], r["generations"]) for r in jax_res if r["status"] == "completed"))
    _no_duplicates(port)
    jplane.close()
    port.close()


# ------------------------------------------------------------ the port's laws

N_SMALL = 6


def _ref_digest(root, n=N_SMALL):
    plane = build_plane(root)
    for s in churn_specs(n):
        plane.submit(s)
    res = plane.serve()
    plane.close()
    return result_digest(res)


def test_placement_spreads_report_validates_and_a_used_directory_is_refused(tmp_path):
    plane = build_plane(tmp_path / "p")
    placed = [plane.submit(s) for s in churn_specs(4)]
    assert sorted(placed) == ["pod00", "pod00", "pod01", "pod01"]
    with pytest.raises(ValueError, match="duplicate tenant tag"):
        plane.submit(ElasticSpec(seed=9, n_steps=5, pop=POP, dim=DIM, tag="cp0000"))
    with pytest.raises(ValueError, match="reserved padding"):
        plane.submit(ElasticSpec(seed=9, n_steps=5, pop=POP, dim=DIM, tag="_pad_9999"))
    assert len(result_digest(plane.serve())) == 4
    rep = _no_duplicates(plane)
    assert rep["pods"]["live"] == ["pod00", "pod01"]
    assert rep["tenants"]["submitted"] == rep["tenants"]["placed"] == 4
    assert rep["events"]["submit"] == 4 and rep["events"]["place"] == 4
    full = run_report(control_plane=plane)
    assert full["control_plane"]["tenants"]["results"] == 4
    assert _check_report().validate_run_report(full) == []
    with pytest.raises(RuntimeError, match="already holds"):
        build_plane(tmp_path / "p")
    plane.close()


def test_pod_death_mid_sweep_equals_the_no_death_run(tmp_path):
    """A pod declared dead after two rounds: its journals stolen, the sweep
    finished on the survivor; completed results and telemetry fingerprints
    equal the no-death run's, every tenant ran its whole budget, and a
    recovery over the finished directory has nothing to redo."""
    ref = _ref_digest(tmp_path / "ref")
    plane = build_plane(tmp_path / "die", metrics=str(tmp_path / "metrics"))
    for s in churn_specs(N_SMALL):
        plane.submit(s)
    plane.serve(max_rounds=2)
    plane.mark_dead("pod00", reason="test")
    res = plane.serve()
    assert result_digest(res) == ref
    done = {t: g for t, g, _ in result_digest(res)}
    assert done == {s.tag: s.n_steps for s in churn_specs(N_SMALL)}
    assert plane.counters["stolen"] > 0
    rep = _no_duplicates(plane)
    assert rep["pods"]["dead"] == ["pod00"] and rep["events"]["steal"] == plane.counters["stolen"]
    assert _check_report().validate_run_report(run_report(control_plane=plane)) == []
    again = recover_plane(tmp_path / "die")
    assert result_digest(again.serve()) == ref
    _no_duplicates(again)
    plane.close()
    again.close()


class _SimKill(BaseException):
    """Stands in for a SIGKILL in process: unwinds the gateway at a
    write-ahead half step without running any of the plane's handlers."""


@pytest.mark.control_chaos
def test_mid_steal_gateway_kill_dedup_law(tmp_path):
    """The gateway dies between "durable in the target" and the ledger's
    ``steal`` (the work is in two pods' journals, no ledger record ties
    them): recovery's dedup witness keeps one copy."""
    ref = _ref_digest(tmp_path / "ref")
    plane = build_plane(tmp_path / "mid")
    for s in churn_specs(N_SMALL):
        plane.submit(s)
    plane.serve(max_rounds=2)
    fired = []

    def hook(point):
        if point.startswith("steal_target_durable:"):
            fired.append(point)
            raise _SimKill(point)

    cp._CRASH_HOOK = hook
    try:
        with pytest.raises(_SimKill):
            plane.mark_dead("pod00", reason="test")
    finally:
        cp._CRASH_HOOK = None
    assert len(fired) == 1
    del plane  # only the directories remain
    plane2 = recover_plane(tmp_path / "mid")
    assert result_digest(plane2.serve()) == ref
    _no_duplicates(plane2)
    assert plane2.counters["steal_dedup"] >= 1
    plane2.close()


def test_parked_continuation_steals_with_its_checkpoint(tmp_path):
    """A deadlined tenant preempts a long one, parking it as a continuation
    with a checkpoint; the pod dies with it queued. The steal carries the
    checkpoint (its manifest attestation pinned in the ledger) and the
    finished trajectories equal the no-death run's."""

    def run(root, die):
        plane = build_plane(root, chunk=3)
        for i in range(4):
            plane.submit(ElasticSpec(seed=i, n_steps=15, pop=8, dim=4, tag=f"long{i}"))
        plane.serve_round()
        plane.submit(ElasticSpec(seed=9, n_steps=4, pop=8, dim=4, tag="urgent", deadline=10))
        parked = None
        for _ in range(40):
            plane.serve_round()
            b = plane.pods["pod00"].server._buckets.get("pop8_dim4_w2")
            if b is not None and b.queue.continuations:
                parked = b.queue.continuations[0]
                break
        assert parked is not None and parked["checkpoint"] is not None
        if die:
            plane.mark_dead("pod00", reason="test")
            steals = [r for r in plane.ledger.records("steal") if r.get("checkpoint")]
            assert steals and steals[0]["attest"]["digest"]
            assert any(e["with_checkpoint"] for e in plane.steal_events)
        return result_digest(plane.serve())

    ref = run(tmp_path / "ref", die=False)
    got = run(tmp_path / "die", die=True)
    assert got == ref
    assert [(t, g) for t, g, _ in got] == [("long0", 15), ("long1", 15), ("long2", 15),
                                           ("long3", 15), ("urgent", 4)]


def test_pod_autoscale_grow_and_drain(tmp_path):
    """A deep backlog opens a pod (ledger first) and moves half the backlog
    onto it; an idle pod drains and closes; every tenant completes once."""
    plane = build_plane(tmp_path / "a", n_pods=1, pod_autoscaler=PodAutoscaler(
        scale_up_depth=2, scale_down_idle_rounds=2, min_pods=1, max_pods=2))
    for s in churn_specs(10):
        plane.submit(s)
    plane.serve_round()
    assert len(plane.live_pods()) == 2
    assert any(e["action"] == "grow" for e in plane.autoscale_events)
    assert plane.counters["stolen"] >= 1
    assert len(result_digest(plane.serve())) == 10
    rep = _no_duplicates(plane)
    assert rep["autoscale"]["policy"]["max_pods"] == 2
    assert _check_report().validate_run_report(run_report(control_plane=plane)) == []
    plane.close()


# ------------------------------------------------------- the real kills


def run_gateway(root, n, kill_after_rounds=None, kill_point=None, dead_pod=None,
                dead_after_rounds=None, timeout=300):
    """Run this file as the gateway child (no JAX in it); returns its exit
    code (-SIGKILL when the scripted kill fired)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    arg = json.dumps({"root": str(root), "n": n, "kill_after_rounds": kill_after_rounds,
                      "kill_point": kill_point, "dead_pod": dead_pod,
                      "dead_after_rounds": dead_after_rounds})
    proc = subprocess.run([sys.executable, __file__, arg], env=env, timeout=timeout,
                          capture_output=True, text=True)
    if proc.returncode not in (0, -signal.SIGKILL):
        raise AssertionError(f"gateway child exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.returncode


def gateway_main(root, n, kill_after_rounds=None, kill_point=None, dead_pod=None,
                 dead_after_rounds=None):
    """The child: the gateway over the churn trace, killed on schedule.
    Exits 7 when a scheduled kill never fired."""
    if kill_point is not None:
        prefix, nth = kill_point
        seen = []

        def hook(point):
            if point.startswith(prefix):
                seen.append(point)
                if len(seen) >= nth:
                    os.kill(os.getpid(), signal.SIGKILL)

        cp._CRASH_HOOK = hook
    plane = build_plane(root)
    for s in churn_specs(n):
        plane.submit(s)
    rounds = 0
    while plane.has_work():
        plane.serve_round()
        rounds += 1
        if dead_pod is not None and rounds == dead_after_rounds:
            plane.mark_dead(dead_pod, reason="chaos")
        if kill_after_rounds is not None and rounds >= kill_after_rounds:
            os.kill(os.getpid(), signal.SIGKILL)
    sys.exit(7 if kill_after_rounds is not None or kill_point is not None else 0)


def _recovered_equals_uncrashed(tmp_path, n):
    plane = recover_plane(tmp_path / "g")
    res = plane.serve()
    acked = {r["tag"] for r in plane.ledger.records("submit")}
    ref = [d for d in _ref_digest(tmp_path / "ref", n) if d[0] in acked]
    assert result_digest(res) == ref
    rep = _no_duplicates(plane)
    assert rep["events"]["recover"] == 1
    plane.close()
    return rep


@pytest.mark.control_chaos
def test_gateway_sigkill_at_steal_target_durable(tmp_path):
    """The tier-1 kill smoke: a real SIGKILL of the gateway child at its
    first ``steal_target_durable:`` point after ``pod00`` is declared dead,
    then ``recover`` in this process: every acknowledged tenant completes
    as in the uncrashed plane, each admitted once."""
    n = 10
    rc = run_gateway(tmp_path / "g", n, kill_point=("steal_target_durable:", 1),
                     dead_pod="pod00", dead_after_rounds=2)
    assert rc == -signal.SIGKILL
    rep = _recovered_equals_uncrashed(tmp_path, n)
    assert rep["tenants"]["submitted"] == n and rep["tenants"]["steal_dedup"] >= 1


@pytest.mark.slow
@pytest.mark.control_chaos
@pytest.mark.parametrize("kill_after_rounds,dead_pod,dead_after_rounds,kill_point", [
    (1, None, None, None),
    (3, None, None, None),
    (None, None, None, ("pre_place:", 3)),
    (None, None, None, ("pre_pod_submit:", 5)),
    (6, "pod00", 3, None),
    (None, "pod00", 2, ("steal_target_durable:", 2)),
])
def test_kill_anywhere_matrix(tmp_path, kill_after_rounds, dead_pod, dead_after_rounds,
                              kill_point):
    """The gateway killed at chunk boundaries, at both admission half steps
    and in a dead pod's steal: recovery equals the uncrashed plane on every
    acknowledged tenant, each admitted once."""
    rc = run_gateway(tmp_path / "g", 24, kill_after_rounds=kill_after_rounds,
                     kill_point=kill_point, dead_pod=dead_pod,
                     dead_after_rounds=dead_after_rounds)
    assert rc == -signal.SIGKILL
    _recovered_equals_uncrashed(tmp_path, 24)


if __name__ == "__main__":
    gateway_main(**json.loads(sys.argv[1]))
