"""Multi-tenant serving in the port (``workflows/tenancy.py``):
``VectorizedWorkflow`` fleets on stacked tenant states, eviction and
resume, and the ``RunQueue``, on the CPU; the cases of
``tests/test_tenancy.py``, the (TENANT, POP) mesh, the rules and the
RunQueue's supervisor, and the fleet's tenants against the JAX package's
fleet.

Laws: tenant ``i`` of a fleet reproduces a solo ``StdWorkflow`` run of the
same (algorithm, seed, hyperparameters), asserted within
``tests/test_tenancy.py``'s ``rtol 1e-5, atol 1e-6`` (on the CPU it holds
bit for bit here); an evicted tenant's checkpoint resumed solo reproduces
the remaining trajectory; a journaled sweep recovered after its driver
died ends with the uncrashed sweep's results.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import VectorizedWorkflow as JaxVectorizedWorkflow
from evox_tpu.algorithms.so.es import CMAES as JaxCMAES
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu_torch import (
    GuardedAlgorithm,
    RunQueue,
    StdWorkflow,
    TenantSpec,
    VectorizedWorkflow,
    instrument,
    interop,
    run_report,
)
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so.es import CMAES, OpenES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.dtype_policy import BF16_STORAGE
from evox_tpu_torch.core.members import member_rows, n_members, take_state, unstack_states
from evox_tpu_torch.core.monitor import Monitor
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.monitors import CheckpointMonitor, TelemetryMonitor
from evox_tpu_torch.problems.numerical import ZDT1, Sphere
from evox_tpu_torch.utils.common import split_seed
from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

N, DIM, POP = 4, 8, 16
HP = {"init_stdev": [0.5, 1.0, 1.5, 2.0]}
SEEDS = [11, 12, 13, 14]


def _cmaes(**kw):
    args = dict(center_init=np.ones(DIM, np.float32), init_stdev=1.0, pop_size=POP, device="cpu")
    args.update(kw)
    return CMAES(**args)


def _fleet(algo=None, n=N, **kw):
    return VectorizedWorkflow(algo or _cmaes(), Sphere(), n_tenants=n, device="cpu", **kw)


def _close(a, b, rtol=1e-5, atol=1e-6):
    for (path, x), (p2, y) in zip(named_leaves(a), named_leaves(b)):
        assert path == p2
        if isinstance(x, torch.Tensor):
            np.testing.assert_allclose(x.double().numpy(), y.double().numpy(), rtol=rtol,
                                       atol=atol, err_msg=path)
        else:
            assert x == y, (path, x, y)


def _check_report():
    spec = importlib.util.spec_from_file_location(
        "check_report", os.path.join(os.path.dirname(__file__), "..", "tools", "check_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- equivalence


def test_fleet_matches_solo_cmaes():
    """CMA-ES, init_stdev per tenant, a TelemetryMonitor ring per tenant:
    every tenant's state and ring equal its solo run's."""
    tm = TelemetryMonitor(capacity=4, device="cpu")
    wf = _fleet(hyperparams=HP, monitors=(tm,))
    state = wf.run(wf.init(SEEDS), 6)
    assert state.tenants.algo.mean.shape == (N, DIM) and wf.member_route == "vmap"
    for i in range(N):
        solo_wf = wf.solo_workflow(i)
        solo = solo_wf.run(solo_wf.init(SEEDS[i]), 6)
        tenant = wf.extract_tenant(state, i)
        _close(tenant.algo, solo.algo)
        _close(tenant.monitors[0], solo.monitors[0])


def test_fleet_matches_solo_openes_hyperparams():
    """OpenES's noise_stdev varies per tenant and flows through ask and
    tell as a tensor."""
    algo = OpenES(np.ones(DIM, np.float32), POP, learning_rate=0.1, noise_stdev=0.05,
                  device="cpu")
    wf = VectorizedWorkflow(algo, Sphere(), n_tenants=2, hyperparams={"noise_stdev": [0.01, 0.1]},
                            device="cpu")
    state = wf.run(wf.init(SEEDS[:2]), 5)
    for i in range(2):
        solo_wf = wf.solo_workflow(i)
        _close(wf.extract_tenant(state, i).algo, solo_wf.run(solo_wf.init(SEEDS[i]), 5).algo)
    assert not torch.allclose(state.tenants.algo.center[0], state.tenants.algo.center[1])


def test_fleet_tenants_match_the_jax_fleet():
    """A PSO fleet of 3 against the JAX package's ``VectorizedWorkflow``:
    the JAX fleet's stacked tenant states cross through ``interop``, each
    tenant's draws are rebuilt from its JAX key and routed to it by draw
    seed; every tenant leaf exactly after three generations."""
    lb, ub = -4 * np.ones(3, np.float32), 4 * np.ones(3, np.float32)
    jwf = JaxVectorizedWorkflow(JaxPSO(lb=lb, ub=ub, pop_size=6), JaxSphere(), n_tenants=3)
    twf = VectorizedWorkflow(PSO(lb, ub, 6, device="cpu"), Sphere(), n_tenants=3, device="cpu")
    jstate = jwf.init(jnp.stack([jax.random.PRNGKey(i) for i in range(3)]))
    tstate = twf.init([0, 1, 2])
    talgo = interop.stacked_members(twf.algorithm, jax.tree.map(np.asarray, jstate.tenants.algo), 3)
    tstate = tstate.replace(tenants=tstate.tenants.replace(algo=talgo), first_step=False)
    jstate = jstate.replace(first_step=False)
    for _ in range(3):
        table = {}
        for i, t in enumerate(unstack_states(tstate.tenants.algo)):
            _, k1, k2 = jax.random.split(jstate.tenants.algo.key[i], 3)
            table[split_seed(t.seed)[1]] = tuple(
                torch.from_numpy(np.array(jax.random.uniform(k, (6, 3)))) for k in (k1, k2))
        twf.algorithm._draw = lambda seed: table[seed]
        jstate, tstate = jwf.step(jstate), twf.step(tstate)
    for name in ("population", "velocity", "pbest_position", "pbest_fitness", "gbest_position",
                 "gbest_fitness"):
        np.testing.assert_array_equal(getattr(tstate.tenants.algo, name).numpy(),
                                      np.asarray(getattr(jstate.tenants.algo, name)), err_msg=name)


def test_cmaes_fleet_tenants_match_the_jax_fleet():
    """A CMA-ES fleet of 3, ``init_stdev`` and ``cm`` bound per tenant,
    against the JAX package's ``VectorizedWorkflow``: the port's own init
    gives each tenant the JAX tenant's leaves (the keys aside), so the
    hyperparameters bind to the same tenants. Then, from the JAX fleet's
    states crossed through ``interop`` with the first step still ahead,
    four generations: each tenant's z handed to it by draw seed and its
    (B, D) through ``_decompose`` by member row, as
    ``tests/test_torch_cmaes.py`` hands a solo run JAX's; every tenant leaf
    within ``tests/test_tenancy.py``'s rtol 1e-5, atol 1e-6 after each."""
    hp = {"init_stdev": [0.5, 1.0, 2.0], "cm": [1.0, 0.8, 0.6]}
    center = np.linspace(-1.0, 2.0, DIM).astype(np.float32)
    jwf = JaxVectorizedWorkflow(JaxCMAES(center, 1.0, pop_size=POP), JaxSphere(), n_tenants=3,
                                hyperparams=hp)
    twf = VectorizedWorkflow(CMAES(center, 1.0, pop_size=POP, device="cpu"), Sphere(),
                             n_tenants=3, hyperparams=hp, device="cpu")
    jstate = jwf.init(jnp.stack([jax.random.PRNGKey(i) for i in range(3)]))
    tstate = twf.init([0, 1, 2])

    def assert_tenants(talgo, jalgo):
        for f in dataclasses.fields(talgo):
            name, x = f.name, getattr(talgo, f.name)
            if name == "seed":
                continue  # the port holds seeds, JAX keys
            want = np.asarray(getattr(jalgo, name))
            if isinstance(x, torch.Tensor):
                np.testing.assert_allclose(x.double().numpy(), want, rtol=1e-5, atol=1e-6,
                                           err_msg=name)
            else:  # a host counter, equal across the tenants
                assert (want == x).all(), (name, x, want)

    assert_tenants(tstate.tenants.algo, jstate.tenants.algo)
    np.testing.assert_array_equal(tstate.tenants.algo.sigma.numpy(), hp["init_stdev"])
    talgo = interop.stacked_members(twf.algorithm, jax.tree.map(np.asarray, jstate.tenants.algo), 3)
    tstate = tstate.replace(tenants=tstate.tenants.replace(algo=talgo))
    assert tstate.first_step and jstate.first_step
    for _ in range(4):
        seeds = [split_seed(t.seed)[1] for t in unstack_states(tstate.tenants.algo)]
        jstate = jwf.step(jstate)
        jalgo = jstate.tenants.algo
        table = {s: torch.from_numpy(np.array(jalgo.z[i])) for i, s in enumerate(seeds)}
        B, D = (torch.from_numpy(np.array(x)) for x in (jalgo.B, jalgo.D))
        twf.algorithm._draw = lambda seed: table[seed]
        twf.algorithm._decompose = lambda C, B=B, D=D: (member_rows(B), member_rows(D))
        tstate = twf.step(tstate)
        assert_tenants(tstate.tenants.algo, jalgo)
    assert not tstate.first_step and int(jstate.generation) == tstate.generation == 4


def test_fleet_sphere_convergence():
    """Convergence gate: every tenant of a CMA-ES fleet drives Sphere below
    1e-2."""
    wf = _fleet(hyperparams=HP)
    state = wf.run(wf.init(SEEDS), 60)
    best = (state.tenants.algo.mean ** 2).sum(-1)
    assert (best < 1e-2).all(), best


def test_fleet_init_hooks_mo():
    """NSGA-II (init_ask/init_tell) on ZDT1 in a fleet of 2: the first step
    takes the init hooks for every tenant, equal to solo runs."""
    algo = NSGA2(np.zeros(DIM), np.ones(DIM), n_objs=2, pop_size=POP, device="cpu")
    wf = VectorizedWorkflow(algo, ZDT1(n_dim=DIM, device="cpu"), n_tenants=2, num_objectives=2,
                            device="cpu")
    state = wf.run(wf.init(SEEDS[:2]), 4)
    solo = StdWorkflow(algo, ZDT1(n_dim=DIM, device="cpu"), device="cpu")
    for i in range(2):
        _close(wf.extract_tenant(state, i).algo, solo.run(solo.init(SEEDS[i]), 4).algo)


# ------------------------------------------------------------ construction


def test_mesh_rules_and_supervisor_are_refused_naming_their_items():
    """The (TENANT, POP) mesh, the rules and the RunQueue's supervisor are
    ported: the mesh's checks as the JAX package's, each leaf's layout
    shifted under the tenant axis (``P("pop")`` to ``P("tenant",
    "pop")``, the rules first), the fleet on a mesh equal to the fleet
    without one, a supervised RunQueue's results equal to an
    unsupervised one's; ``health_policy`` takes a ``FleetHealthPolicy``,
    whose possible freeze gives the fleet its mask from the start."""
    from evox_tpu_torch.algorithms.so.es import SepCMAES
    from evox_tpu_torch.core.distributed import (POP_AXIS, TENANT_AXIS, P, create_mesh)
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    with pytest.raises(ValueError, match="'tenant' axis"):
        _fleet(mesh=create_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="n_tenants"):
        _fleet(n=3, mesh=create_mesh((TENANT_AXIS, POP_AXIS), ["cpu"] * 4, (2, 2)))
    mesh = create_mesh((TENANT_AXIS, POP_AXIS), ["cpu"] * 4, (2, 2))
    algo = SepCMAES(torch.zeros(DIM), 1.0, pop_size=POP, device="cpu")
    wf = VectorizedWorkflow(algo, Sphere(), n_tenants=N, device="cpu", mesh=mesh,
                            rules=[(r"\.mean$", P(None))])
    plain = VectorizedWorkflow(algo, Sphere(), n_tenants=N, device="cpu")
    state = wf.run(wf.init(SEEDS), 3)
    _close(state.tenants.algo, plain.run(plain.init(SEEDS), 3).tenants.algo, rtol=0, atol=0)
    specs = wf.state_shardings(state).tenants.algo
    assert specs.z.spec == P(TENANT_AXIS, POP_AXIS)
    assert specs.sigma.spec == P(TENANT_AXIS)
    assert specs.mean.spec == P(TENANT_AXIS, None)  # the rule before the annotation
    assert wf.tenancy_report(state)["tenant_axis"] == TENANT_AXIS
    solo = wf.solo_workflow(0, mesh=create_mesh(devices=["cpu"] * 2))
    assert solo.mesh.shape == {"pop": 2}
    results = []
    for supervisor in (RunSupervisor(), None):
        q = RunQueue(_fleet(), chunk=2, supervisor=supervisor)
        for i in range(N):
            q.submit(TenantSpec(seed=i, n_steps=4, tag=f"t{i}"))
        q.run()
        results.append(q.state)
    _close(results[0].tenants.algo, results[1].tenants.algo, rtol=0, atol=0)
    from evox_tpu_torch.workflows.fleet_health import FleetHealthPolicy

    q = RunQueue(_fleet(), chunk=2, health_policy=FleetHealthPolicy(on_nonfinite="freeze"))
    assert q.health_policy.on_nonfinite == "freeze"
    for i in range(N):
        q.submit(TenantSpec(seed=i, n_steps=4, tag=f"h{i}"))
    state = q.start()
    assert state.frozen is not None and not bool(state.frozen.any()) and state.frozen_rows == ()
    q.run()
    assert q.health_events == [] and q.health_report()["policy"]["on_nonfinite"] == "freeze"


def test_hyperparam_validation_and_refusals(tmp_path):
    with pytest.raises(ValueError, match="no attribute"):
        _fleet(hyperparams={"not_a_knob": [0.0] * N})
    with pytest.raises(ValueError, match="leading"):
        _fleet(hyperparams={"init_stdev": [1.0] * 3})

    class HostProblem(Sphere):
        jittable = False

    with pytest.raises(ValueError, match="device"):
        VectorizedWorkflow(_cmaes(), HostProblem(), n_tenants=2, device="cpu")
    with pytest.raises(ValueError, match="host"):
        _fleet(monitors=(CheckpointMonitor(str(tmp_path)),))


# ------------------------------------------------------ eviction and resume


def test_eviction_checkpoint_solo_resume(tmp_path):
    wf = _fleet(hyperparams=HP, monitors=(TelemetryMonitor(capacity=8, device="cpu"),))
    state = wf.run(wf.init(SEEDS), 6)
    solo_state = wf.extract_tenant(state, 1)
    assert solo_state.generation == 6 and isinstance(solo_state.algo.seed, int)
    WorkflowCheckpointer(str(tmp_path / "evicted"), every=6).save(solo_state)
    solo_wf = wf.solo_workflow(1)
    resumed = solo_wf.run(solo_wf.init(SEEDS[1]), 10, resume_from=str(tmp_path / "evicted"))
    assert resumed.generation == 10
    _close(resumed.algo, solo_wf.run(solo_state, 4).algo, rtol=0, atol=0)
    _close(resumed.algo, solo_wf.run(solo_wf.init(SEEDS[1]), 10).algo)


def test_insert_tenant_roundtrip_and_shape_guard():
    wf = _fleet(hyperparams=HP)
    state = wf.run(wf.init(SEEDS), 3)
    solo = wf.extract_tenant(state, 2)
    state2 = wf.insert_tenant(state, 2, solo)
    _close(take_state(state2.tenants.algo, 2), solo.algo, rtol=0, atol=0)
    _close(take_state(state2.tenants.algo, 3), take_state(state.tenants.algo, 3), rtol=0, atol=0)
    other = StdWorkflow(_cmaes(pop_size=POP + 2), Sphere(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wf.insert_tenant(state, 0, other.init(0))


def test_fleet_checkpointed_run_equivalence(tmp_path):
    wf = _fleet(hyperparams=HP)
    straight = wf.run(wf.init(SEEDS), 8)
    ckpt = WorkflowCheckpointer(str(tmp_path / "fleet"), every=4)
    chunked = wf.run(wf.init(SEEDS), 8, checkpointer=ckpt)
    _close(chunked.tenants.algo, straight.tenants.algo, rtol=0, atol=0)
    resumed = wf.run(wf.init(SEEDS), 8, resume_from=ckpt)
    assert resumed.generation == 8


def test_frozen_tenant_keeps_its_state():
    wf = _fleet()
    state = wf.with_freeze_mask(wf.run(wf.init(SEEDS), 2))
    state = wf.set_frozen(state, 1, True)
    nxt = wf.step(state)
    _close(take_state(nxt.tenants.algo, 1), take_state(state.tenants.algo, 1), rtol=0, atol=0)
    assert int(nxt.tenants.generation[1]) == 2 and int(nxt.tenants.generation[0]) == 3


# ---------------------------------------------------------------- RunQueue


def test_runqueue_lifecycle(tmp_path):
    """5 specs through a 2-wide fleet: budgets honoured exactly, retired
    slots admit pending specs, checkpoints and telemetry in the results."""
    wf = _fleet(n=2, hyperparams={"init_stdev": [1.0, 1.0]},
                monitors=(TelemetryMonitor(capacity=8, device="cpu"),))
    q = RunQueue(wf, chunk=5, checkpoint_dir=str(tmp_path))
    budgets = [7, 8, 9, 10, 6]
    for i, b in enumerate(budgets):
        q.submit(TenantSpec(seed=i, n_steps=b, hyperparams={"init_stdev": 0.5 + 0.25 * i},
                            tag=f"job{i}"))
    results = q.run()
    assert sorted(r["tag"] for r in results) == [f"job{i}" for i in range(5)]
    assert {r["tag"]: r["generations"] for r in results} == {
        f"job{i}": b for i, b in enumerate(budgets)}
    assert all(r["status"] == "completed" for r in results)
    assert q.counters["submitted"] == q.counters["admitted"] == q.counters["retired"] == 5
    for r in results:
        assert os.path.isdir(r["checkpoint"])
        assert r["monitors"][0]["generations"] == r["generations"]


def test_runqueue_evict_resume(tmp_path):
    wf = _fleet(n=2)
    q = RunQueue(wf, chunk=5, checkpoint_dir=str(tmp_path))
    for i in range(2):
        q.submit(TenantSpec(seed=i, n_steps=12, tag=f"e{i}"))
    q.start()
    q.step_chunk()
    entry = q.evict(0)
    assert entry["status"] == "evicted" and entry["generations"] == 5
    solo_wf = wf.solo_workflow(hyperparams={})
    st = solo_wf.run(solo_wf.init(0), 12, resume_from=entry["checkpoint"])
    assert st.generation == 12
    _close(st.algo, solo_wf.run(solo_wf.init(0), 12).algo)


def test_runqueue_rejects_bad_specs_and_double_starts():
    wf = _fleet(n=2, hyperparams={"init_stdev": [1.0, 1.0]})
    q = RunQueue(wf, chunk=3)
    with pytest.raises(ValueError, match="n_steps"):
        q.submit(TenantSpec(seed=0, n_steps=0, hyperparams={"init_stdev": 1.0}))
    with pytest.raises(ValueError, match="hyperparam names"):
        q.submit(TenantSpec(seed=0, n_steps=5, hyperparams={}))
    with pytest.raises(ValueError, match="pop_size"):
        q.submit(TenantSpec(seed=0, n_steps=5, hyperparams={"init_stdev": 1.0}, pop=POP + 1))
    q.submit(TenantSpec(seed=np.int64(7), n_steps=6, hyperparams={"init_stdev": 1.0}))
    with pytest.raises(ValueError, match="at least n_tenants"):
        q.start()
    q.submit(TenantSpec(seed=8, n_steps=6, hyperparams={"init_stdev": 1.0}))
    q.start()
    with pytest.raises(RuntimeError, match="already started"):
        q.start()
    with pytest.raises(RuntimeError, match="already driven"):
        RunQueue(wf)
    assert [r["status"] for r in q.run()] == ["completed"] * 2
    assert q.finished and RunQueue(wf, chunk=3).workflow is wf


def test_runqueue_evict_edge_cases_and_distinct_checkpoints(tmp_path):
    wf = _fleet(n=2)
    q = RunQueue(wf, chunk=3, checkpoint_dir=str(tmp_path))
    for i in range(2):
        q.submit(TenantSpec(seed=i, n_steps=9, tag="sweep"))
    with pytest.raises(RuntimeError, match="before start"):
        q.evict(0)
    q.start()
    q.step_chunk()
    with pytest.raises(ValueError, match="out of range"):
        q.evict(5)
    entry = q.evict(0)  # nothing pending: the slot parks
    assert entry["generations"] == 3 and not q.slots[0].active
    with pytest.raises(ValueError, match="no active tenant"):
        q.evict(0)
    q.submit(TenantSpec(seed=9, n_steps=4, tag="sweep"))  # a late submit refills it
    results = q.run()
    assert q.counters["evicted"] == 1 and q.counters["retired"] == 2
    assert sorted(r["generations"] for r in results) == [3, 4, 9]
    assert len({r["checkpoint"] for r in results}) == 3  # one directory each


def test_runqueue_admission_peels_init_hooks():
    algo = NSGA2(np.zeros(DIM), np.ones(DIM), n_objs=2, pop_size=POP, device="cpu")
    wf = VectorizedWorkflow(algo, ZDT1(n_dim=DIM, device="cpu"), n_tenants=2, num_objectives=2,
                            device="cpu")
    q = RunQueue(wf, chunk=4)
    for i in range(3):
        q.submit(TenantSpec(seed=i, n_steps=6, tag=f"mo{i}"))
    assert sorted(r["generations"] for r in q.run()) == [6, 6, 6]


def test_runqueue_recovers_a_crashed_sweep_from_its_journal(tmp_path):
    """A journaled sweep whose driver dies after two chunks: ``recover``
    restores the newest barrier and the replay ends with the uncrashed
    sweep's results (each spec admitted once)."""
    def specs():
        return [TenantSpec(seed=i, n_steps=6 + i, tag=f"r{i}") for i in range(4)]

    ref_q = RunQueue(_fleet(n=2), chunk=3)
    for s in specs():
        ref_q.submit(s)
    ref = {r["tag"]: r["generations"] for r in ref_q.run()}
    journal = str(tmp_path / "journal")
    q = RunQueue(_fleet(n=2), chunk=3, journal=journal)
    for s in specs():
        q.submit(s)
    q.start()
    q.step_chunk()
    q.step_chunk()
    q.executor.drain_lane("fleet_snapshot")
    del q  # the driver dies here
    back = RunQueue.recover(_fleet(n=2), journal)
    got = {r["tag"]: r["generations"] for r in back.run()}
    assert got == ref and back.counters["submitted"] == 4
    assert back.journal.report()["recovered"]


def test_runqueue_deadline_preempts_a_running_tenant(tmp_path):
    wf = _fleet(n=2)
    q = RunQueue(wf, chunk=2, checkpoint_dir=str(tmp_path))
    for i in range(2):
        q.submit(TenantSpec(seed=i, n_steps=12, tag=f"long{i}"))
    q.start()
    q.step_chunk()
    q.submit(TenantSpec(seed=7, n_steps=3, tag="urgent", deadline=6))
    results = q.run()
    done = {r["tag"]: r for r in results if r["status"] == "completed"}
    assert q.counters["preempted"] == 1 and done["urgent"]["generations"] == 3
    assert done["long0"]["generations"] == 12 and done["long1"]["generations"] == 12


# ------------------------------------------------------------- observability


def test_run_report_tenancy_section_valid():
    check_report = _check_report()
    wf = _fleet(n=2, hyperparams={"init_stdev": [1.0, 1.0]},
                monitors=(TelemetryMonitor(capacity=8, device="cpu"),))
    q = RunQueue(wf, chunk=5)
    for i in range(2):
        q.submit(TenantSpec(seed=i, n_steps=6, hyperparams={"init_stdev": 1.0}))
    q.run()
    report = run_report(wf, q.state)
    assert report["schema"] == "evox_tpu.run_report/v14"
    ten = report["tenancy"]
    assert ten["n_tenants"] == 2 and ten["leading_axes"] == [2] and len(ten["per_tenant"]) == 2
    assert ten["queue"]["counters"]["retired"] == 2 and ten["member_route"] == "vmap"
    assert check_report.validate_run_report(report) == []
    bad = dict(report, tenancy=dict(ten, n_tenants=3))
    assert check_report.validate_run_report(bad) != []


def test_fleet_roofline_analyses_the_fleet_step():
    """The fleet's ``analysis_targets`` give the roofline its steady step
    and run; the differenced slope of runs of 2 and 6 reaches it."""
    wf = _fleet(hyperparams=HP)
    rec = instrument(wf, analyze=True)
    state = wf.run(wf.init(SEEDS), 2)
    state = wf.run(state, 2)
    state = wf.run(state, 6)
    entry = run_report(wf, state, recorder=rec)["roofline"]["entries"]["run"]
    assert entry["timing_method"] == "differenced"
    assert entry["static"]["flops"] > 0


class _GenerationProbe(Monitor):
    def hooks(self):
        return ("post_step",)

    def init(self, seed=None):
        return torch.zeros((), dtype=torch.int64)

    def post_step(self, mstate, wf_state):
        return torch.as_tensor(wf_state.generation, dtype=torch.int64)


def test_queue_admitted_tenant_hooks_see_own_generation():
    wf = _fleet(n=1, monitors=(_GenerationProbe(),))
    q = RunQueue(wf, chunk=4)
    q.submit(TenantSpec(seed=0, n_steps=8))
    q.submit(TenantSpec(seed=1, n_steps=5))
    q.run()
    assert q.state.generation == 13
    assert int(q.state.tenants.monitors[0][0]) == 5 and int(q.state.tenants.generation[0]) == 5


def test_fleet_post_step_workflow_state_contract():
    wf = _fleet(n=2, monitors=(_GenerationProbe(),))
    state = wf.run(wf.init(SEEDS[:2]), 7)
    assert state.tenants.monitors[0].tolist() == [7, 7]


# ------------------------------------------------- machinery reuse coverage


def test_fleet_guarded_algorithm():
    guarded = GuardedAlgorithm(_cmaes())
    wf = VectorizedWorkflow(guarded, Sphere(), n_tenants=2, device="cpu",
                            hyperparams={"algorithm.init_stdev": [0.5, 2.0]})
    state = wf.run(wf.init(SEEDS[:2]), 5)
    # its tell reads the host: the guarded tenants run one by one
    assert wf.member_route == "loop" and n_members(state.tenants.algo) == 2
    solo_wf = wf.solo_workflow(0)
    _close(wf.extract_tenant(state, 0).algo, solo_wf.run(solo_wf.init(SEEDS[0]), 5).algo)


def test_fleet_bf16_storage_policy_and_donated_carries():
    wf = _fleet(hyperparams=HP, dtype_policy=BF16_STORAGE)
    state = wf.run(wf.init(SEEDS), 40)
    assert state.tenants.algo.z.dtype == torch.bfloat16
    assert state.tenants.algo.C.dtype == torch.float32
    assert ((state.tenants.algo.mean.float() ** 2).sum(-1) < 0.1).all()
    donated = _fleet(hyperparams=HP, donate_carries=True)
    s0 = donated.init(SEEDS)
    out = donated.run(s0, 4)
    _close(out.tenants.algo, _fleet(hyperparams=HP).run(_fleet(hyperparams=HP).init(SEEDS),
                                                        4).tenants.algo, rtol=0, atol=0)
    assert s0.generation == 0


def test_fleet_entry_points_refuse_a_missing_cuda():
    """``device=None`` means ``"cuda"`` and raises without a card."""
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorizedWorkflow(CMAES(np.zeros(DIM, np.float32), 1.0, pop_size=POP, device="cpu"),
                           Sphere(), n_tenants=2)
