"""Fleet health in the port (``workflows/fleet_health.py`` and the
RunQueue's ``health_policy=``) against the JAX package's, on the CPU.

- ``fleet_health_signals`` on a guarded, telemetry-monitored fleet whose
  counters and one NaN tenant are set the same way in both packages: the
  same keys, dtypes and values.
- ``FleetHealthPolicy.decide`` over one seeded signal sequence: the same
  actions, reasons and escalations.
- A RunQueue sweep with one NaN-poisoned tenant under each action: the
  same health log and journal record kinds as the JAX queue's (the log
  depends on the poison and the budgets only, not on the draws).
- The isolation law, bit for bit in the port: the healthy tenants' states
  and telemetry fingerprints equal the no-poison sweep's.
- ``RunQueue.recover`` rebuilds the journaled policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import GuardedAlgorithm as JaxGuardedAlgorithm
from evox_tpu import RunQueue as JaxRunQueue
from evox_tpu import TenantSpec as JaxTenantSpec
from evox_tpu import VectorizedWorkflow as JaxVectorizedWorkflow
from evox_tpu.algorithms.so.es import CMAES as JaxCMAES
from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu.workflows.fleet_health import FleetHealthPolicy as JaxPolicy
from evox_tpu.workflows.fleet_health import fleet_health_signals as jax_signals
from evox_tpu_torch import GuardedAlgorithm, RunQueue, TenantSpec, VectorizedWorkflow, run_report
from evox_tpu_torch.algorithms.so.es import CMAES
from evox_tpu_torch.core.members import MemberValues, take_state
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.fleet_health import FleetHealthPolicy, fleet_health_signals
from tests._chaos import poison_algo_field

N, DIM, POP, BUDGET, CHUNK = 4, 4, 8, 9, 3


def _port_fleet(guarded=False, monitors=()):
    algo = CMAES(np.ones(DIM, np.float32), init_stdev=1.0, pop_size=POP, device="cpu")
    if guarded:
        algo = GuardedAlgorithm(algo)
    return VectorizedWorkflow(algo, Sphere(), n_tenants=N, monitors=monitors, device="cpu")


def _jax_fleet(guarded=False, monitors=()):
    algo = JaxCMAES(center_init=jnp.ones(DIM), init_stdev=1.0, pop_size=POP)
    if guarded:
        algo = JaxGuardedAlgorithm(algo)
    return JaxVectorizedWorkflow(algo, JaxSphere(), n_tenants=N, monitors=monitors)


def _poison_port(wf, state, slot):
    solo = wf.extract_tenant(state, slot)
    algo = solo.algo
    inner = algo.inner if hasattr(algo, "inner") else algo
    inner = inner.replace(mean=torch.full_like(inner.mean, float("nan")))
    algo = algo.replace(inner=inner) if hasattr(algo, "inner") else inner
    return wf.insert_tenant(state, slot, solo.replace(algo=algo))


# ------------------------------------------------------------------ signals


def test_signals_equal_jax_on_a_guarded_fleet_with_a_nan_tenant():
    """Counters set per tenant in both packages (the guard's as host
    integers in the port, as int32 arrays in JAX), tenant 1's mean NaN:
    every signal equal, with JAX's dtypes."""
    gen = [3, 3, 5, 4]
    trig, restarts, stag = [0, 1, 0, 8], [0, 2, 1, 0], [0, 4, 2, 7]
    tel = {"stagnation": [1, 0, 6, 2], "nan_fitness": [0, 3, 0, 0],
           "nan_candidates": [0, 0, 2, 0]}

    jwf = _jax_fleet(guarded=True, monitors=(JaxTelemetryMonitor(capacity=4),))
    js = jwf.init(jnp.stack([jax.random.PRNGKey(i) for i in range(N)]))
    jalgo = js.tenants.algo.replace(
        last_trigger=jnp.asarray(trig, jnp.int32), restarts=jnp.asarray(restarts, jnp.int32),
        stagnation=jnp.asarray(stag, jnp.int32))
    jmon = js.tenants.monitors[0].replace(**{k: jnp.asarray(v, jnp.int32) for k, v in tel.items()})
    js = js.replace(tenants=js.tenants.replace(
        generation=jnp.asarray(gen, jnp.int32), algo=jalgo, monitors=(jmon,)))
    js = jwf.insert_tenant(js, 1, poison_algo_field(jwf.extract_tenant(js, 1), "mean",
                                                    float("nan")))

    pwf = _port_fleet(guarded=True, monitors=(TelemetryMonitor(capacity=4, device="cpu"),))
    ps = pwf.init(list(range(N)))
    palgo = ps.tenants.algo.replace(last_trigger=MemberValues(trig),
                                    restarts=MemberValues(restarts), stagnation=MemberValues(stag))
    pmon = ps.tenants.monitors[0].replace(
        **{k: torch.tensor(v, dtype=torch.int32) for k, v in tel.items()})
    ps = ps.replace(tenants=ps.tenants.replace(
        generation=torch.tensor(gen, dtype=torch.int64), algo=palgo, monitors=(pmon,)))
    ps = _poison_port(pwf, ps, 1)

    want, got = jax_signals(js), fleet_health_signals(ps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["nonfinite"].tolist() == [False, True, False, False]


def test_signals_of_a_plain_fleet_and_the_refusal_without_float_leaves():
    """A fleet with neither guard nor telemetry has only ``generation`` and
    ``nonfinite``; a state without a floating tenant leaf is refused, as in
    JAX."""
    from evox_tpu_torch.workflows.fleet_health import _per_tenant_nan

    wf = _port_fleet()
    sig = fleet_health_signals(wf.run(wf.init(list(range(N))), 2))
    assert sorted(sig) == ["generation", "nonfinite"]
    assert sig["generation"].tolist() == [2] * N and not sig["nonfinite"].any()
    with pytest.raises(ValueError, match="no floating"):
        _per_tenant_nan({"count": torch.zeros(N, dtype=torch.int32)})


# ------------------------------------------------------------------- policy


def test_decide_equals_jax_over_a_seeded_signal_sequence():
    """The same rows and slot-restart counts through both policies: the same
    verdicts, escalations at the cap included, and the same metric counts."""
    rng = np.random.default_rng(3)

    class Counter:
        def __init__(self):
            self.counts = {}

        def count(self, name, n=1):
            self.counts[name] = self.counts.get(name, 0) + n

    configs = [dict(on_nonfinite="restart", stagnation_limit=5, max_restarts_per_slot=2),
               dict(on_nonfinite="freeze", on_trigger="evict"),
               dict(on_nonfinite=None, on_trigger="restart", stagnation_limit=3,
                    on_stagnation="evict", max_restarts_per_slot=0)]
    for cfg in configs:
        jp, pp = JaxPolicy(**cfg), FleetHealthPolicy(**cfg)
        jp.metrics, pp.metrics = Counter(), Counter()
        assert jp.may_freeze() == pp.may_freeze() and jp.report() == pp.report()
        for _ in range(200):
            row = {"nonfinite": bool(rng.random() < 0.2),
                   "guard_trigger": int(rng.choice([0, 0, 1, 2, 8])),
                   "stagnation": int(rng.integers(0, 9))}
            if rng.random() < 0.3:
                row["guard_stagnation"] = row.pop("stagnation")
            restarts = int(rng.integers(0, 4))
            assert pp.decide(row, restarts) == jp.decide(row, restarts), (cfg, row, restarts)
        assert pp.metrics.counts == jp.metrics.counts
    for bad in (dict(on_nonfinite="defenestrate"), dict(max_restarts_per_slot=-1)):
        with pytest.raises(ValueError):
            FleetHealthPolicy(**bad)


# -------------------------------------------------------------- run queue


def _port_sweep(tmp_path, action, poison_slot=None, journal=True):
    wf = _port_fleet(monitors=(TelemetryMonitor(capacity=8, device="cpu"),))
    q = RunQueue(wf, chunk=CHUNK, journal=str(tmp_path) if journal else None,
                 health_policy=FleetHealthPolicy(on_nonfinite=action))
    for i in range(N):
        q.submit(TenantSpec(seed=i, n_steps=BUDGET, tag=f"t{i}"))
    q.start()
    q.step_chunk()
    if poison_slot is not None:
        q.state = _poison_port(wf, q.state, poison_slot)
    while q.step_chunk():
        pass
    return q


def _jax_sweep(tmp_path, action, poison_slot):
    wf = _jax_fleet(monitors=(JaxTelemetryMonitor(capacity=8),))
    q = JaxRunQueue(wf, chunk=CHUNK, journal=str(tmp_path),
                    health_policy=JaxPolicy(on_nonfinite=action))
    for i in range(N):
        q.submit(JaxTenantSpec(seed=i, n_steps=BUDGET, tag=f"t{i}"))
    q.start()
    q.step_chunk()
    solo = poison_algo_field(wf.extract_tenant(q.state, poison_slot), "mean", float("nan"))
    q.state = wf.insert_tenant(q.state, poison_slot, solo)
    while q.step_chunk():
        pass
    return q


def _kinds(q):
    return [r["kind"] for r in q.journal.records()]


@pytest.mark.parametrize("action", ["freeze", "evict", "restart"])
def test_run_queue_action_log_and_journal_kinds_equal_jax(tmp_path, action):
    """One tenant poisoned after the first chunk: the port's health log,
    result statuses and journal kinds equal the JAX queue's, and the
    report's ``fleet_health`` section passes the validator."""
    from test_torch_tenancy import _check_report

    port = _port_sweep(tmp_path / "port", action, poison_slot=1)
    ref = _jax_sweep(tmp_path / "jax", action, poison_slot=1)
    assert port.health_events == ref.health_events
    assert port.health_events[0]["slot"] == 1
    assert port.health_events[0]["reason"] == "nonfinite_state"
    assert _kinds(port) == _kinds(ref)
    status = lambda q: sorted((r["tag"], r["status"], r["generations"]) for r in q.results)
    assert status(port) == status(ref)
    assert {k: v for k, v in port.counters.items() if k in ref.counters} == \
        {k: v for k, v in ref.counters.items() if k in port.counters}
    rep = run_report(port.workflow, port.state)
    assert rep["tenancy"]["fleet_health"]["events"] == port.health_events
    assert _check_report().validate_run_report(rep) == []


@pytest.fixture(scope="module")
def iso_baseline(tmp_path_factory):
    """The no-poison sweep under the same policy (so it carries the mask)."""
    return _port_sweep(tmp_path_factory.mktemp("iso_base"), "freeze")


@pytest.mark.parametrize("action", ["freeze", "evict", "restart"])
def test_isolation_law_bit_for_bit(tmp_path, iso_baseline, action):
    """The healthy tenants' final states and telemetry fingerprints equal
    the no-poison sweep's bit for bit, whatever happens to slot 1."""
    q = _port_sweep(tmp_path, action, poison_slot=1)
    prints = lambda q: {r["tag"]: r.get("fingerprints") for r in q.results}
    got, base = prints(q), prints(iso_baseline)
    for slot in (0, 2, 3):
        assert got[f"t{slot}"] == base[f"t{slot}"]
        for a, b in zip(torch.utils._pytree.tree_leaves(take_state(q.state.tenants, slot)),
                        torch.utils._pytree.tree_leaves(take_state(iso_baseline.state.tenants,
                                                                   slot))):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    status = {r["tag"]: r["status"] for r in q.results}
    if action == "freeze":
        assert status["t1"] == "frozen" and q.state.frozen_rows == (1,)
        assert q.state.frozen.tolist() == [False, True, False, False]
    elif action == "evict":
        assert status["t1"] == "evicted" and q.state.frozen_rows == (1,)  # parked and masked
    else:
        assert status["t1"] == "completed" and q.counters["restarted"] == 1


def test_freeze_select_keeps_frozen_rows_and_passes_the_rest_bit_for_bit():
    """A step with slot 2 frozen: slot 2 keeps its pre-step state (its host
    seed and iteration too), every other slot equals the unmasked step."""
    wf = _port_fleet()
    state = wf.run(wf.init(list(range(N))), 2)
    plain = wf.step(state)
    masked = wf.set_frozen(wf.with_freeze_mask(state), 2, True)
    assert masked.frozen_rows == (2,)
    stepped = wf.step(masked)
    for slot in range(N):
        want = take_state((state if slot == 2 else plain).tenants, slot)
        got = take_state(stepped.tenants, slot)
        assert got.algo.seed == want.algo.seed and got.algo.iteration == want.algo.iteration
        for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), slot
    assert wf.set_frozen(masked, 2, False).frozen_rows == ()


def test_recover_rebuilds_the_journaled_policy(tmp_path):
    """``recover`` without ``health_policy=`` rebuilds the journaled one,
    which still isolates a tenant that goes non-finite in the replay."""
    wf = _port_fleet()
    q = RunQueue(wf, chunk=CHUNK, journal=str(tmp_path),
                 health_policy=FleetHealthPolicy(on_nonfinite="evict"))
    for i in range(N):
        q.submit(TenantSpec(seed=i, n_steps=BUDGET, tag=f"t{i}"))
    q.start()
    q.step_chunk()
    q.executor.drain_lane("fleet_snapshot")
    del q
    q2 = RunQueue.recover(_port_fleet(), str(tmp_path))
    assert isinstance(q2.health_policy, FleetHealthPolicy)
    assert q2.health_policy.on_nonfinite == "evict"
    q2.state = _poison_port(q2.workflow, q2.state, 3)
    q2.run()
    assert any(e["action"] == "evict" and e["reason"] == "nonfinite_state" and e["slot"] == 3
               for e in q2.health_events)
