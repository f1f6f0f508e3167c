"""Elastic serving in the port (``workflows/elastic.py``,
``core/exec_cache.py``) against the JAX package's, on the CPU.

- ``pad_inert_rows`` bit for bit against JAX's on stress rows.
- ``BucketTable`` over a grid of pops, dims and widths, errors included.
- A padded tenant equals its ``solo_workflow`` run, and its full-width
  neighbour's telemetry ring equals a solo run's, bit for bit.
- ``fleet_fingerprint``'s collision laws.
- The serving cache: hit, miss, frozen miss, stale topology, torn entry,
  and a fresh process's pre-warm from the manifest.
- ``ElasticServer`` on a seeded trace: the JAX server's bucket keys,
  admissions and completions; one autoscale growth.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu.workflows import elastic as jel
from evox_tpu_torch import GuardedAlgorithm
from evox_tpu_torch.algorithms.so.es import CMAES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.exec_cache import ExecCacheError, ExecCacheMissError, ExecutableCache
from evox_tpu_torch.core.instrument import RetraceError
from evox_tpu_torch.core.members import take_state
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.elastic import (
    ACTIVE_ROWS,
    BucketError,
    BucketShape,
    BucketTable,
    ElasticServer,
    ElasticSpec,
    ElasticWorkflow,
    PopAutoscaler,
    fleet_fingerprint,
    pad_inert_rows,
    warm_fleet_cache,
)

DIM, POP, WIDTH = 4, 8, 2
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _pso_bucket_wf(shape, device="cpu"):
    algo = PSO(-5.0 * torch.ones(shape.dim), 5.0 * torch.ones(shape.dim), pop_size=shape.pop,
               device=device)
    return ElasticWorkflow(algo, Sphere(), n_tenants=shape.width,
                           hyperparams={ACTIVE_ROWS: np.full((shape.width,), shape.pop, np.int32)},
                           monitors=(TelemetryMonitor(capacity=8, device=device),), device=device)


def _jax_pso_bucket_wf(shape):
    algo = JaxPSO(lb=-5.0 * jnp.ones(shape.dim), ub=5.0 * jnp.ones(shape.dim), pop_size=shape.pop)
    return jel.ElasticWorkflow(algo, JaxSphere(), n_tenants=shape.width,
                               hyperparams={jel.ACTIVE_ROWS: jnp.full((shape.width,), shape.pop,
                                                                      jnp.int32)},
                               monitors=(JaxTelemetryMonitor(capacity=8),))


# ------------------------------------------------------------- padding


def _stress_rows(m):
    rng = np.random.default_rng(m)
    rows = [rng.standard_normal((9,) if m == 1 else (9, m)).astype(np.float32) for _ in range(4)]
    rows[1][[0, 2]] = np.nan
    rows[1][3] = np.inf
    rows[2][[1, 4]] = -np.inf
    rows[3][:5] = np.nan  # an all-non-finite live set for active <= 5
    rows[3][6:] = np.inf
    return rows


@pytest.mark.parametrize("m", [1, 3])
def test_pad_inert_rows_equals_jax_bit_for_bit(m):
    for f in _stress_rows(m):
        for active in (0, 1, 3, 5, 8, 9):
            want = np.asarray(jel.pad_inert_rows(jnp.asarray(f), active))
            got = pad_inert_rows(torch.from_numpy(f), active).numpy()
            np.testing.assert_array_equal(got, want)
            got_t = pad_inert_rows(torch.from_numpy(f), torch.tensor(active, dtype=torch.int32))
            np.testing.assert_array_equal(got_t.numpy(), want)
    f = torch.from_numpy(_stress_rows(m)[0])
    assert torch.equal(pad_inert_rows(f, 9), f)  # all rows live: the identity


# ------------------------------------------------------------- lattice


def test_bucket_table_equals_jax_over_a_grid():
    tables = [({}, {}), (dict(pop_rungs=[100, 24, 50], width_rungs=[3, 1]),) * 2,
              (dict(min_pop=4, max_pop=100, max_width=6),) * 2]
    for kw_p, kw_j in tables:
        pt, jt = BucketTable(**kw_p), jel.BucketTable(**kw_j)
        assert pt.report() == jt.report()
        for pop in (-1, 0, 1, 3, 8, 9, 24, 25, 99, 100, 101, 1 << 16, (1 << 16) + 1):
            assert pt.next_pop_rung(max(pop, 0)) == jt.next_pop_rung(max(pop, 0))
            for dim in (0, 1, 7):
                for width in (0, 1, 2, 3, 5, 300):
                    try:
                        want = jt.bucket_for(pop, dim, width).as_tuple()
                    except jel.BucketError as e:
                        with pytest.raises(BucketError) as got:
                            pt.bucket_for(pop, dim, width)
                        assert str(got.value) == str(e)
                        continue
                    got = pt.bucket_for(pop, dim, width)
                    assert got.as_tuple() == want and got.key == jel.BucketShape(*want).key
    with pytest.raises(BucketError, match="positive"):
        BucketTable(pop_rungs=[0, 4])


# ---------------------------------------------------- padded tenant law


def test_padded_tenant_equals_its_solo_workflow_and_neighbour_ring_is_untouched():
    """Tenant 0 runs padded (5 of 8 rows live), tenant 1 full. Both equal
    their solo runs with the same mask bit for bit, and tenant 1's ring is
    the solo run's."""
    wf = _pso_bucket_wf(BucketShape(POP, DIM, WIDTH))
    seeds = [3, 4]
    state = wf.run(wf.init(seeds, hyperparams={ACTIVE_ROWS: [5, POP]}), 10)
    mon = wf.monitors[0]
    for i, active in enumerate((5, POP)):
        solo_wf = wf.solo_workflow(hyperparams={ACTIVE_ROWS: active})
        assert solo_wf.fit_transforms[0].keywords == {"active": active}
        solo = solo_wf.run(solo_wf.init(seeds[i]), 10)
        tenant = take_state(state.tenants, i)
        for a, b in zip(torch.utils._pytree.tree_leaves(tenant.algo),
                        torch.utils._pytree.tree_leaves(solo.algo)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), i
        assert mon.fingerprint(tenant.monitors[0]) == mon.fingerprint(solo.monitors[0])
    # the inert rows never reach the padded tenant's best
    best = take_state(state.tenants, 0).monitors[0]
    assert torch.isfinite(best.best_key).all()


# ----------------------------------------------------------- fingerprints


def test_fleet_fingerprint_collision_laws():
    """Two different lambdas, two partials of different bound arrays, two
    large constants one element apart and two PSO bounds all key apart;
    the same configuration built twice keys the same (no process-local
    address in the key)."""
    shape = BucketShape(POP, DIM, WIDTH)

    def fleet(fit=(), lb=-5.0):
        algo = PSO(lb * torch.ones(DIM), 5.0 * torch.ones(DIM), pop_size=POP, device="cpu")
        return ElasticWorkflow(algo, Sphere(), n_tenants=WIDTH, fit_transforms=fit,
                               hyperparams={ACTIVE_ROWS: [POP] * WIDTH}, device="cpu")

    big = np.zeros(5000, np.float32)
    big2 = big.copy()
    big2[4321] = 1.0
    from functools import partial

    fps = [fleet_fingerprint(fleet()),
           fleet_fingerprint(fleet(fit=(lambda f: f * 2,))),
           fleet_fingerprint(fleet(fit=(lambda f: f + 1,))),
           fleet_fingerprint(fleet(fit=(partial(np.add, big),))),
           fleet_fingerprint(fleet(fit=(partial(np.add, big2),))),
           fleet_fingerprint(fleet(lb=-4.0))]
    assert len(set(fps)) == len(fps)
    assert fleet_fingerprint(fleet()) == fps[0]
    assert fleet_fingerprint(_pso_bucket_wf(shape)) == fleet_fingerprint(_pso_bucket_wf(shape))
    from evox_tpu_torch.workflows.elastic import _transform_identity

    assert "0x" not in _transform_identity(partial(np.add, big))


# ----------------------------------------------------------------- cache


def test_cache_hit_miss_frozen_miss_and_report(tmp_path):
    wf = _pso_bucket_wf(BucketShape(POP, DIM, WIDTH))
    cache = ExecutableCache(directory=str(tmp_path))
    out = warm_fleet_cache(wf, cache, bucket=BucketShape(POP, DIM, WIDTH))
    assert out["entries"] == ["fleet_step_first", "fleet_step", "fleet_run_loop",
                              "fleet_solo_peel"]
    assert cache.counters["misses"] == 4 and cache.counters["saves"] == 4
    warm_fleet_cache(wf, cache, bucket=BucketShape(POP, DIM, WIDTH))
    assert cache.counters["hits"] == 4 and cache.counters["misses"] == 4
    cache.freeze()
    tenant = wf.init_tenant(9, {ACTIVE_ROWS: np.int32(5)})  # as ElasticServer.submit binds it
    wf._solo_peel(tenant)  # warm shapes: no miss
    state = wf.run(wf.init([3, 4]), 2)  # the first-step entry, then the run loop's
    wf.run(state, 3)
    assert cache.counters["hits"] == 4 + 3 and cache.counters["misses"] == 4
    other = _pso_bucket_wf(BucketShape(POP * 2, DIM, WIDTH))
    with pytest.raises(ExecCacheMissError):  # a chunk at shapes no warm-up saw
        wf.run(other.init([3, 4]), 1)
    with pytest.raises(ExecCacheMissError) as e:
        warm_fleet_cache(other, cache, planned=False)
    assert isinstance(e.value, RetraceError)
    rep = cache.report()
    assert rep["strict"] and len(rep["entries"]) == 4
    assert {e["source"] for e in rep["entries"]} == {"compiled"}


def test_warm_admissions_raise_nothing_under_a_frozen_cache_and_a_strict_recorder():
    """Five specs of ragged pops through a warm two-slot bucket: three
    admissions mid-sweep are state surgery at the warmed shapes, so a
    frozen cache and ``DispatchRecorder(strict_retrace=True)`` raise
    nothing; the report's ``serving`` section passes the validator."""
    from evox_tpu_torch import RunQueue, TenantSpec, instrument, run_report
    from test_torch_tenancy import _check_report

    shape = BucketShape(POP, DIM, WIDTH)
    wf = _pso_bucket_wf(shape)
    cache = ExecutableCache()
    warm_fleet_cache(wf, cache, bucket=shape)
    cache.freeze()
    rec = instrument(wf, strict_retrace=True)
    q = RunQueue(wf, chunk=3)
    for i in range(5):
        q.submit(TenantSpec(seed=i, n_steps=4, tag=f"t{i}",
                            hyperparams={ACTIVE_ROWS: np.int32(5 + i % 4)}))
    results = q.run()
    assert [r["status"] for r in results] == ["completed"] * 5
    assert rec.summary()["retrace_flags"] == []
    # every chunk's run was looked up, all hits (PSO declares no init
    # hooks, so an admission dispatches no peel)
    assert cache.counters["hits"] == q.counters["chunks"] and q.counters["admitted"] == 5
    rep = run_report(wf, q.state, recorder=rec)
    assert rep["serving"]["cache"]["counters"]["misses"] == 4 and rep["serving"]["cache"]["strict"]
    assert _check_report().validate_run_report(json.loads(json.dumps(rep))) == []


def test_cache_stale_topology_refuses_and_torn_entry_is_warmed_again(tmp_path):
    wf = _pso_bucket_wf(BucketShape(POP, DIM, WIDTH))
    warm_fleet_cache(wf, ExecutableCache(directory=str(tmp_path)))
    manifests = sorted(tmp_path.glob("*.manifest.json"))
    assert len(manifests) == 4
    # a torn payload: skipped with a warning and warmed (and written) again
    torn = manifests[0].name.replace(".manifest.json", ".exec")
    (tmp_path / torn).write_bytes(b"{")
    cache = ExecutableCache(directory=str(tmp_path))
    with pytest.warns(UserWarning, match="corrupt"):
        warm_fleet_cache(wf, cache)
    assert cache.counters["disk_hits"] == 3 and cache.counters["misses"] == 1
    # another topology: refused loudly
    m = json.loads(manifests[1].read_text())
    m["topology"]["torch"] = "0.0.0"
    manifests[1].write_text(json.dumps(m))
    with pytest.raises(ExecCacheError, match="topology"):
        warm_fleet_cache(wf, ExecutableCache(directory=str(tmp_path)))


_FRESH = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows.elastic import (ACTIVE_ROWS, ElasticServer, ElasticSpec,
                                                  ElasticWorkflow)

    def _pso_bucket_wf(shape, device="cpu"):  # the test module's factory, without jax
        algo = PSO(-5.0 * torch.ones(shape.dim), 5.0 * torch.ones(shape.dim),
                   pop_size=shape.pop, device=device)
        return ElasticWorkflow(
            algo, Sphere(), n_tenants=shape.width,
            hyperparams={{ACTIVE_ROWS: np.full((shape.width,), shape.pop, np.int32)}},
            monitors=(TelemetryMonitor(capacity=8, device=device),), device=device)

    srv = ElasticServer(_pso_bucket_wf, cache_dir={cache!r}, width=2, chunk=3)
    pre = dict(srv.cache.counters)
    for i, pop in enumerate((5, 8, 13)):
        srv.submit(ElasticSpec(seed=i, n_steps=5, pop=pop, dim=4, tag="req%d" % i))
    res = srv.serve()
    print(json.dumps({{"prewarmed": srv.prewarmed, "pre": pre, "post": srv.cache.counters,
                      "res": sorted((r["tag"], r["bucket"], r["fingerprints"]) for r in res),
                      "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}}))
""")


def test_fresh_process_prewarms_from_the_manifest(tmp_path):
    """A first process serves and writes the manifest; a fresh process
    finds it, pre-warms both listed buckets before any request (8 disk
    hits, no miss) and serves the same trajectories."""
    cache = str(tmp_path / "cache")
    srv = ElasticServer(_pso_bucket_wf, cache_dir=cache, width=WIDTH, chunk=3)
    assert srv.prewarmed == []
    for i, pop in enumerate((5, 8, 13)):
        srv.submit(ElasticSpec(seed=i, n_steps=5, pop=pop, dim=DIM, tag=f"req{i}"))
    res = srv.serve()
    assert srv.cache.counters["misses"] == 8
    script = tmp_path / "fresh.py"
    script.write_text(_FRESH.format(root=ROOT, cache=cache))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(got["prewarmed"]) == sorted({f"pop{POP}_dim{DIM}_w{WIDTH}",
                                               f"pop16_dim{DIM}_w{WIDTH}"})
    assert got["pre"]["disk_hits"] == 8 and got["pre"]["misses"] == 0
    assert got["post"]["misses"] == 0 and not got["jax"]
    want = sorted((r["tag"], r["bucket"], r["fingerprints"]) for r in res)
    assert [tuple(x) for x in got["res"]] == [(t, b, list(f)) for t, b, f in want]


# ---------------------------------------------------------------- server


def test_server_trace_equals_jax_bucket_keys_admissions_and_completions():
    """A seeded trace of ragged requests: the same bucket per request, the
    same admissions and completions per bucket, the same fillers."""
    rng = np.random.default_rng(21)
    trace = [(int(rng.integers(2, 30)), int(rng.choice([3, 4])), int(rng.integers(2, 7)))
             for _ in range(7)]
    port = ElasticServer(_pso_bucket_wf, width=WIDTH, chunk=3)
    ref = jel.ElasticServer(_jax_pso_bucket_wf, width=WIDTH, chunk=3)
    keys = []
    for i, (pop, dim, steps) in enumerate(trace):
        a = port.submit(ElasticSpec(seed=i, n_steps=steps, pop=pop, dim=dim, tag=f"r{i}"))
        b = ref.submit(jel.ElasticSpec(seed=i, n_steps=steps, pop=pop, dim=dim, tag=f"r{i}"))
        assert a.key == b.key
        keys.append(a.key)
    got, want = port.serve(), ref.serve()
    view = lambda rs: [(r["bucket"], r["tag"], r["status"], r["generations"], r["slot"])
                       for r in rs]
    assert view(got) == view(want)
    for key in set(keys):
        pq, jq = port._buckets[key].queue, ref._buckets[key].queue
        assert {k: v for k, v in pq.counters.items() if k in jq.counters} == \
            {k: v for k, v in jq.counters.items() if k in pq.counters}
        assert port._buckets[key].fillers == ref._buckets[key].fillers
    rep = port.report()
    assert set(rep["buckets"]) == set(keys) and rep["table"] == ref.report()["table"]


class _Flatline(Sphere):
    """Constant fitness: the guard's stagnation counter climbs every
    generation, the escalation signal the autoscaler grows on."""

    def evaluate(self, state, pop):
        fit, state = super().evaluate(state, pop)
        return torch.zeros_like(fit), state


def test_autoscaler_grows_one_rung_journaled_in_both_buckets(tmp_path):
    def factory(shape):
        algo = GuardedAlgorithm(CMAES(np.ones(shape.dim, np.float32), init_stdev=1.0,
                                      pop_size=shape.pop, device="cpu"), stagnation_limit=3)
        return ElasticWorkflow(algo, _Flatline(), n_tenants=shape.width,
                               hyperparams={ACTIVE_ROWS: [shape.pop] * shape.width},
                               monitors=(TelemetryMonitor(capacity=8, device="cpu"),),
                               device="cpu")

    srv = ElasticServer(factory, width=1, chunk=4, autoscaler=PopAutoscaler(max_grows=1),
                        journal_dir=str(tmp_path / "j"), checkpoint_dir=str(tmp_path / "c"))
    srv.submit(ElasticSpec(seed=0, n_steps=16, pop=POP, dim=DIM, tag="grow"))
    results = srv.serve()
    assert len(srv.autoscale_events) == 1
    ev = srv.autoscale_events[0]
    assert (ev["from"], ev["to"]) == (f"pop{POP}_dim{DIM}_w1", f"pop16_dim{DIM}_w1")
    by_status = {r["status"]: r for r in results}
    assert by_status["grown"]["bucket"] == ev["from"]
    assert by_status["completed"]["bucket"] == ev["to"]
    assert by_status["completed"]["generations"] == 16
    src = [r["kind"] for r in srv._buckets[ev["from"]].queue.journal.records()]
    dst = srv._buckets[ev["to"]].queue.journal.records()
    assert "autoscale" in src
    assert any(r["kind"] == "submit" and r.get("resume_from") for r in dst)
    assert srv.report()["autoscale"]["policy"] == {"stagnation_limit": None, "max_grows": 1}
    with pytest.raises(ValueError, match="GuardedAlgorithm"):
        ElasticServer(_pso_bucket_wf, width=WIDTH, autoscaler=PopAutoscaler()).submit(
            ElasticSpec(seed=0, n_steps=1, pop=POP, dim=DIM))
