"""The mesh layer and the process layer of the port
(``evox_tpu_torch/core/distributed.py``) on the CPU, against
``evox_tpu/core/distributed.py``.

- The shardings: per-field annotations, regex rules and the tenant prefix
  resolve to the JAX package's partition specs, leaf by leaf.
- ``shard_map``: per-shard functions run in mesh order; ``PSUM`` and
  ``all_gather`` are the sums and concatenations of the shards.
- The mesh-sharded non-dominated sort (B3's rows form, one launch a shard
  on the card; its plain version here) against JAX's
  ``_non_dominated_sort_sharded`` on its 8 virtual devices: ranks and the
  cut exactly, also at ``n`` not divisible by ``32 * 8`` and with rows of
  all ``+inf`` or NaN.
- Two processes over gloo with a ``FileStore`` under ``tmp_path`` (no
  network): the store barrier, a host value gathered over a mesh that
  spans the processes, a ``shard_map`` and a ``PSUM`` across them, and
  ``BarrierTimeoutError`` naming the process that stayed away; then
  ``ShardedES`` and the sharded sort on an 8-position mesh of two
  processes, each bit for bit against the same mesh in one process, with
  a snapshot carried from one process to two and back (the JAX package's
  own multi-process tests fail on this tree). The fleets and the islands
  still refuse such a mesh (ROADMAP A11's fourth part).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.es import SepCMAES as JaxSepCMAES
from evox_tpu.core import distributed as jd
from evox_tpu.operators.selection.non_dominate import non_dominated_sort as jax_nds
from evox_tpu_torch.algorithms.so.es import SepCMAES
from evox_tpu_torch.core import distributed as td
from evox_tpu_torch.operators.selection import non_dominated_sort

ROOT = Path(__file__).resolve().parent.parent


def _jax_specs(tree, specs):
    """``{keystr path: spec tuple}`` of a JAX tree of specs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec) or x is None)[0]
    return {jax.tree_util.keystr(p): (tuple(s) if s is not None else None) for p, s in leaves}


def _port_specs(specs):
    """``{path: spec tuple}`` of the port's tree of specs (its host leaves,
    seeds and counters, carry no spec)."""
    return {p: tuple(s) for p, s in td._named_any(specs) if isinstance(s, td.P)}


def test_mesh_shapes_and_devices():
    mesh = td.create_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"pop": 8} and mesh.size == 8 and mesh.controller == torch.device("cpu")
    m2 = td.create_mesh((td.TENANT_AXIS, td.POP_AXIS), ["cpu"] * 4, (2, 2))
    assert m2.shape == {"tenant": 2, "pop": 2} and len(m2.axis_devices("pop")) == 2
    assert m2 == td.create_mesh((td.TENANT_AXIS, td.POP_AXIS), ["cpu"] * 4, (2, 2))
    assert repr(td.P("pop")) == "P('pop',)" and td.NamedSharding(mesh, td.P()).is_fully_replicated
    with pytest.raises(ValueError, match="does not hold"):
        td.create_mesh(devices=["cpu"] * 3, shape=(2,))
    if not torch.cuda.is_available():  # a mesh over the visible cards
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            td.create_mesh()
    assert not td.mesh_spans_processes(mesh) and td.process_count() == 1


def test_annotation_specs_and_state_sharding_match_jax():
    """SepCMAES's state: ``z`` on the population axis, the strategy
    replicated; under the tenant prefix ``P("pop")`` becomes ``P("tenant",
    "pop")`` and ``P()`` becomes ``P("tenant")``, as in the JAX package."""
    jstate = JaxSepCMAES(jnp.zeros(4), 1.0, pop_size=8).init(jax.random.PRNGKey(0))
    tstate = SepCMAES(torch.zeros(4), 1.0, pop_size=8, device="cpu").init(0)
    want = _jax_specs(jstate, jd.annotation_specs(jstate))
    got = _port_specs(td.annotation_specs(tstate))
    assert got and all(want[p] == s for p, s in got.items())
    assert got[".z"] == ("pop",) and got[".mean"] == ()
    jmesh = jd.create_mesh((jd.TENANT_AXIS, jd.POP_AXIS), jax.devices()[:4], (2, 2))
    tmesh = td.create_mesh((td.TENANT_AXIS, td.POP_AXIS), ["cpu"] * 4, (2, 2))
    rules = [(r"\.mean$", jax.sharding.PartitionSpec(None))]
    jsh = jd.state_sharding(jstate, jmesh, rules=rules, axis_prefix=jd.TENANT_AXIS)
    tsh = td.state_sharding(tstate, tmesh, rules=[(r"\.mean$", td.P(None))],
                            axis_prefix=td.TENANT_AXIS)
    want = {p: tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(jsh)[0]
            for p, s in [(jax.tree_util.keystr(p), s)]}
    got = {p: tuple(s.spec) for p, s in td._named_any(tsh) if isinstance(s, td.NamedSharding)}
    assert all(want[p] == s for p, s in got.items())
    # the rule's P(None) is too wide for the unstacked (4,) mean once the
    # tenant axis leads: the prefix alone, as in the JAX package
    assert got[".z"] == ("tenant", "pop") and got[".mean"] == ("tenant",)


def test_match_partition_rules_matches_jax():
    tree = {"algo": {"population": np.zeros((8, 3), np.float32), "best": np.zeros(3, np.float32),
                     "step": np.zeros((), np.float32)},
            "ring": [np.zeros((4, 2), np.float32)]}
    jrules = [(r"population$", jax.sharding.PartitionSpec("pop")),
              (r"\[0\]", jax.sharding.PartitionSpec(None, "pop"))]
    trules = [(r"population$", td.P("pop")), (r"\[0\]", td.P(None, "pop"))]
    want = _jax_specs(tree, jd.match_partition_rules(jrules, jax.tree.map(jnp.asarray, tree)))
    got = dict(td._named_any(td.match_partition_rules(trules,
                                                      jax.tree.map(torch.from_numpy, tree))))
    assert {p: (tuple(s) if s is not None else None) for p, s in got.items()} == want
    with pytest.raises(ValueError, match="no partition rule"):
        td.match_partition_rules(trules[:1], {"x": torch.zeros(2)}, strict=True)


def test_shard_map_psum_and_gather():
    mesh = td.create_mesh(devices=["cpu"] * 4)
    x = torch.arange(12, dtype=torch.float32).reshape(12, 1)
    seen = []

    def per_shard(rows, w):
        seen.append(td.axis_index())
        return {"sum": (rows * w).sum(0), "rows": rows + 1}

    out = td.shard_map(per_shard, mesh, (td.P("pop"), td.P()),
                       {"sum": td.PSUM, "rows": td.P("pop")})(x, torch.tensor(2.0))
    assert seen == [0, 1, 2, 3]
    # a P("pop") output stays resident: its blocks where they were made
    assert isinstance(out["rows"], td.ShardedTensor) and out["rows"].positions == [0, 1, 2, 3]
    assert [tuple(b.shape) for b in out["rows"].blocks] == [(3, 1)] * 4
    assert torch.equal(out["rows"].gather(), x + 1)
    parts = [(b * 2.0).sum(0) for b in td.split_rows(x, 4)]
    assert torch.equal(out["sum"], parts[0] + parts[1] + parts[2] + parts[3])
    assert torch.equal(td.all_gather(td.split_rows(x, 4)), x)
    with pytest.raises(RuntimeError, match="only defined inside"):
        td.axis_index()


def _stress_fitness(n, m, seed):
    rng = np.random.default_rng(seed)
    fit = (np.round(rng.random((n, m)) * 12) / 12).astype(np.float32)
    fit[n // 2] = fit[0]
    fit[3] = np.inf
    fit[7] = np.nan
    fit[11, m - 1] = np.nan
    return fit


@pytest.mark.parametrize("n,m,until", [(300, 3, 150), (777, 2, None), (2001, 3, 1000)])
def test_sharded_sort_matches_jax_sharded_sort(n, m, until):
    """Ranks and cut of the port's sharded sort (8 shards, each slab padded
    to ``32 * 8`` granularity with ``+inf``) equal JAX's
    ``_non_dominated_sort_sharded`` on 8 devices and the unsharded sort."""
    fit = _stress_fitness(n, m, n)
    j_rank, j_cut = jax_nds(jnp.asarray(fit), until=until, return_cut_rank=True,
                            mesh=jd.create_mesh(devices=jax.devices()[:8]))
    mesh = td.create_mesh(devices=["cpu"] * 8)
    t_rank, t_cut = non_dominated_sort(torch.from_numpy(fit), until=until, return_cut_rank=True,
                                       mesh=mesh)
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    assert t_cut == int(j_cut)
    u_rank, u_cut = non_dominated_sort(torch.from_numpy(fit), until=until, return_cut_rank=True)
    assert torch.equal(u_rank, t_rank) and u_cut == t_cut


def test_place_and_restore_layouts_on_a_mesh():
    mesh = td.create_mesh(devices=["cpu"] * 2)
    state = SepCMAES(torch.zeros(4), 1.0, pop_size=8, device="cpu").init(0)
    placed = td.place_state(state, mesh)
    assert torch.equal(placed.z, state.z) and placed.seed == state.seed
    by = td.place_by_sharding(state, td.state_sharding(state, mesh))
    assert torch.equal(by.mean, state.mean)
    assert torch.equal(td.place_pop({"x": torch.ones(4)}, None)["x"], torch.ones(4))
    # the checkpoint manifest's provenance record: the leaves a mesh splits
    from evox_tpu_torch.workflows.checkpoint import leaf_shardings

    assert leaf_shardings(state) == {".z": "P('pop',)"}
    np.testing.assert_array_equal(td.host_value(torch.arange(4)), np.arange(4))


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import torch
    from evox_tpu_torch.core import distributed as d

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    d.init_distributed("file://" + store, num_processes=2, process_id=rank, backend="gloo",
                       timeout_s=30)
    res = {{"world": [d.process_id(), d.process_count()]}}
    d.process_barrier("first", timeout_s=20)
    mesh = d.create_pod_mesh(devices=d.pod_devices(local=["cpu"]))
    res["spans"] = d.mesh_spans_processes(mesh)
    full = torch.arange(8, dtype=torch.float32)
    mine = d.place_pop(full, mesh)
    res["mine"] = torch.cat(mine.blocks).tolist()
    res["gathered"] = d.host_value(mine).tolist()
    out_rows = d.shard_map(lambda x: x + 1, mesh, (d.P("pop"),), d.P("pop"))(full)
    res["computed"] = torch.cat(out_rows.blocks).tolist()
    res["summed"] = d.shard_map(lambda x: x.sum(0), mesh, (d.P("pop"),), d.PSUM)(full).item()
    res["first"] = d.shard_map(lambda x: x[:1] + 100, mesh, (d.P("pop"),), d.P())(full).tolist()
    if rank == 0:
        try:
            d.process_barrier("second", timeout_s=1.0)
            res["timeout"] = None
        except d.BarrierTimeoutError as e:
            res["timeout"] = {{"missing": e.missing, "arrived": e.arrived}}
    json.dump(res, open(out, "w"))
    d.shutdown_distributed() if rank == 1 else None
""")


def _run_pair(tmp_path, source, *args, timeout=180):
    """Two processes of ``source`` over gloo with a ``FileStore`` under
    ``tmp_path`` (no network), each given its rank, the store, its output
    path and ``args``; both must exit 0."""
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(tmp_path / "store"),
                               str(tmp_path / f"out{r}"), *map(str, args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    return [tmp_path / f"out{r}" for r in (0, 1)]


def test_two_processes_over_gloo(tmp_path):
    """A barrier, a gathered host value, a ``shard_map`` that computes each
    process's own blocks, a ``PSUM`` over both and a ``P()`` output (shard
    0's, broadcast from process 0), and a barrier timeout naming the
    process that never came, across two processes; the gathered value and
    the sum equal the single-process ones."""
    outs = _run_pair(tmp_path, _WORKER.format(root=str(ROOT)), timeout=120)
    res = [json.loads(o.read_text()) for o in outs]
    assert [r["world"] for r in res] == [[0, 2], [1, 2]]
    assert res[0]["spans"] and res[1]["spans"]
    assert res[0]["mine"] == [0.0, 1.0, 2.0, 3.0] and res[1]["mine"] == [4.0, 5.0, 6.0, 7.0]
    single = td.host_value(torch.arange(8, dtype=torch.float32)).tolist()
    assert res[0]["gathered"] == single and res[1]["gathered"] == single
    assert res[0]["computed"] == [1.0, 2.0, 3.0, 4.0] and res[1]["computed"] == [5.0, 6.0, 7.0, 8.0]
    assert res[0]["summed"] == res[1]["summed"] == 28.0
    assert res[0]["first"] == res[1]["first"] == [100.0]
    assert res[0]["timeout"] == {"missing": [1], "arrived": [0]}


# ShardedES over two processes: pop and d at which run_report attaches both
# roofline subsections (4 MiB of samples over 8 positions), 3 generations
# checked, a snapshot taken at generation 3 and one resumed from generation 2
PAIR_POP, PAIR_DIM, PAIR_SEED, PAIR_GENS = 16384, 64, 11, 3

_ES_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tools!r})
    import torch
    torch.set_num_threads(1)
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import SepCMAES
    from evox_tpu_torch.core import distributed as d
    from evox_tpu_torch.core.instrument import instrument, run_report
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    rank, store, out, snap_in, snap_out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                          sys.argv[4], sys.argv[5])
    d.init_distributed("file://" + store, num_processes=2, process_id=rank, backend="gloo",
                       timeout_s=60)
    mesh = d.create_pod_mesh(devices=d.pod_devices(local=["cpu"] * 4))
    algo = d.ShardedES(SepCMAES(torch.zeros({dim}), 1.0, pop_size={pop}, device="cpu"),
                       mesh=mesh)
    wf = StdWorkflow(algo, Sphere(), mesh=mesh, device="cpu")
    rec = instrument(wf, analyze=True)
    state, gens = wf.init({seed}), []
    for _ in range({gens}):
        state = wf.step(state)
        a = state.algo
        gens.append({{"z": a.z.blocks, "positions": a.z.positions, "mean": a.mean, "C": a.C,
                      "sigma": a.sigma}})
    report = run_report(wf, state, recorder=rec)
    WorkflowCheckpointer(snap_out, every=1).save(state)
    resumed = wf.resume(WorkflowCheckpointer(snap_in, every=100), {gens} + 1)
    torch.save({{"gens": gens, "report": report, "stats": d.collective_stats(),
                 "resumed": {{"z": resumed.algo.z.blocks, "mean": resumed.algo.mean,
                              "generation": resumed.generation}}}}, out)
""")


def _es_pair_wf(mesh):
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import Sphere

    algo = td.ShardedES(SepCMAES(torch.zeros(PAIR_DIM), 1.0, pop_size=PAIR_POP, device="cpu"),
                        mesh=mesh)
    return StdWorkflow(algo, Sphere(), mesh=mesh, device="cpu")


def test_sharded_es_over_two_processes(tmp_path):
    """``ShardedES(SepCMAES)`` on an 8-position mesh that spans two
    processes (4 each, gloo, a ``FileStore``): every generation each
    process's ``z`` blocks and the replicated ``mean``, ``C`` and
    ``sigma`` equal the same mesh's in one process bit for bit; each
    process's ``run_report`` carries ``roofline.multihost`` (2 processes,
    4 local positions) and a gather-free ``roofline.sharding``, both
    accepted by ``tools/check_report.py``; a snapshot the two processes
    take resumes in one process, and one a single process took at
    generation 2 resumes in two, each equal to the straight run."""
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    sys.path.insert(0, str(ROOT / "tools"))
    import check_report

    one = _es_pair_wf(td.create_mesh(devices=["cpu"] * 8))
    state, want = one.init(PAIR_SEED), []
    for g in range(PAIR_GENS + 1):
        state = one.step(state)
        want.append(state)
        if g == 1:  # the single process's snapshot at generation 2
            WorkflowCheckpointer(tmp_path / "snap1", every=1).save(state)
    outs = _run_pair(tmp_path, _ES_WORKER.format(
        root=str(ROOT), tools=str(ROOT / "tools"), pop=PAIR_POP, dim=PAIR_DIM, seed=PAIR_SEED,
        gens=PAIR_GENS), tmp_path / "snap1", tmp_path / "snap2")
    res = [torch.load(o, weights_only=False) for o in outs]
    for r, positions in zip(res, ([0, 1, 2, 3], [4, 5, 6, 7])):
        for g, got in enumerate(r["gens"]):
            ref = want[g].algo
            assert got["positions"] == positions
            for s, block in zip(positions, got["z"]):
                assert torch.equal(block, ref.z.block_at(s)), (g, s)
            for f in ("mean", "C", "sigma"):
                assert torch.equal(got[f], getattr(ref, f)), (g, f)
        roof = r["report"]["roofline"]
        assert roof["multihost"]["process_count"] == 2
        assert roof["multihost"]["n_local_devices"] == 4
        assert roof["sharding"]["gather_free"] is True
        assert check_report.validate_run_report(r["report"]) == []
        assert r["stats"]["calls"] > 0 and r["stats"]["staged_bytes"] == 0  # CPU: nothing staged
        # 1 -> 2: the single process's snapshot resumed in two processes
        assert r["resumed"]["generation"] == PAIR_GENS + 1
        ref = want[PAIR_GENS].algo
        for s, block in zip(positions, r["resumed"]["z"]):
            assert torch.equal(block, ref.z.block_at(s))
        assert torch.equal(r["resumed"]["mean"], ref.mean)
    # 2 -> 1: the two processes' snapshot at generation 3 resumed in one
    back = one.resume(WorkflowCheckpointer(tmp_path / "snap2", every=100), PAIR_GENS + 1)
    assert torch.equal(back.algo.z.gather(), want[PAIR_GENS].algo.z.gather())
    assert torch.equal(back.algo.mean, want[PAIR_GENS].algo.mean)


_SORT_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.core import distributed as d
    from evox_tpu_torch.operators.selection import non_dominated_sort
    from evox_tpu_torch.problems.numerical import LSMOP1
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    rank, store, out, snap_in = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    d.init_distributed("file://" + store, num_processes=2, process_id=rank, backend="gloo",
                       timeout_s=60)
    mesh = d.create_pod_mesh(devices=d.pod_devices(local=["cpu"] * 4))
    fit = torch.from_numpy(np.load({stress!r}))
    sort = [non_dominated_sort(fit, until=u, return_cut_rank=True, mesh=mesh)
            for u in (None, fit.shape[0] // 2)]
    prob = LSMOP1(d={dim}, m=3, device="cpu")
    wf = StdWorkflow(NSGA2(*prob.bounds(), n_objs=3, pop_size={pop}, mesh=mesh, device="cpu"),
                     prob, device="cpu")
    state, gens = wf.init({seed}), []
    for _ in range({gens}):
        state = wf.step(state)
        gens.append((state.algo.population, state.algo.fitness, state.algo.rank))
    resumed = wf.resume(WorkflowCheckpointer(snap_in, every=100), {gens} + 1)
    torch.save({{"sort": sort, "gens": gens, "stats": d.collective_stats(),
                 "resumed": (resumed.algo.population, resumed.algo.rank)}}, out)
""")

SORT_POP, SORT_DIM, SORT_SEED = 300, 30, 5


def _sort_pair_wf(mesh):
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import LSMOP1

    prob = LSMOP1(d=SORT_DIM, m=3, device="cpu")
    return StdWorkflow(NSGA2(*prob.bounds(), n_objs=3, pop_size=SORT_POP, mesh=mesh,
                             device="cpu"), prob, device="cpu")


def test_sharded_sort_over_two_processes(tmp_path):
    """The mesh-sharded non-dominated sort on 8 positions over two
    processes (4 slabs each, integer ``PSUM``\\ s across them): on stress
    fitness (ties, ``+inf`` and NaN rows, n not a multiple of ``32 * 8``)
    the ranks and the cut equal the unsharded sort's; NSGA-II over LSMOP1
    with it, every generation's population, fitness and ranks equal the
    same mesh's in one process bit for bit, and a single process's
    snapshot at generation 2 resumes in the two processes to the straight
    run's state."""
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    fit = _stress_fitness(1001, 3, 9)
    np.save(tmp_path / "stress.npy", fit)
    one = _sort_pair_wf(td.create_mesh(devices=["cpu"] * 8))
    state, want = one.init(SORT_SEED), []
    for g in range(4):
        state = one.step(state)
        want.append(state.algo)
        if g == 1:
            WorkflowCheckpointer(tmp_path / "snap1", every=1).save(state)
    outs = _run_pair(tmp_path, _SORT_WORKER.format(
        root=str(ROOT), stress=str(tmp_path / "stress.npy"), dim=SORT_DIM, pop=SORT_POP,
        seed=SORT_SEED, gens=3), tmp_path / "snap1")
    fit_t = torch.from_numpy(fit)
    plain = [non_dominated_sort(fit_t, until=u, return_cut_rank=True) for u in (None, 500)]
    for r in (torch.load(o, weights_only=False) for o in outs):
        for (rank, cut), (want_rank, want_cut) in zip(r["sort"], plain):
            assert torch.equal(rank, want_rank) and cut == want_cut
        for g, (pop, f, rank) in enumerate(r["gens"]):
            assert torch.equal(pop, want[g].population), g
            assert torch.equal(f, want[g].fitness), g
            assert torch.equal(rank, want[g].rank), g
        assert torch.equal(r["resumed"][0], want[3].population)
        assert torch.equal(r["resumed"][1], want[3].rank)
        assert r["stats"]["calls"] > 0


def test_a_mesh_that_spans_processes_computes_nothing():
    """What a mesh of two processes' devices computes in one of them: only
    that process's positions (``shard_map``'s output keeps their blocks),
    and ``ShardedES`` and ``StdWorkflow`` over a problem on the device take
    it; the fleets and the islands still refuse it, naming ROADMAP A11's
    fourth part (their members over distinct cards)."""
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import IslandWorkflow, StdWorkflow, VectorizedWorkflow

    pod = td.Mesh(["cpu"] * 4, ("pop",), processes=[0, 0, 1, 1])
    assert td.mesh_spans_processes(pod)
    algo = SepCMAES(torch.zeros(4), 1.0, pop_size=8, device="cpu")
    pso = PSO(torch.full((4,), -1.0), torch.ones(4), pop_size=8, device="cpu")
    refusals = [
        lambda: IslandWorkflow(pso, Sphere(), n_islands=4, mesh=pod, device="cpu"),
        lambda: VectorizedWorkflow(pso, Sphere(), n_tenants=2,
                                   mesh=td.Mesh([["cpu"] * 2] * 2, ("tenant", "pop"),
                                                processes=[[0, 0], [1, 1]]), device="cpu"),
    ]
    for make in refusals:
        with pytest.raises(NotImplementedError, match="spans processes.*A11, part 4"):
            make()
    # this process (0) runs positions 0 and 1 of the four: their blocks only
    out = td.shard_map(lambda x: x * 2, pod, (td.P("pop"),), td.P("pop"))(torch.arange(8.0))
    assert out.positions == [0, 1] and out.rows == [2, 2, 2, 2] and tuple(out.shape) == (8,)
    assert torch.equal(torch.cat(out.blocks), torch.arange(4.0) * 2)
    assert td.ShardedES(algo, mesh=pod).is_pop_sharded
    assert StdWorkflow(td.ShardedES(algo, mesh=pod), Sphere(), mesh=pod, device="cpu").mesh is pod
    # the same mesh on one process computes every position
    local = td.Mesh(["cpu"] * 4, ("pop",))
    out = td.shard_map(lambda x: x * 2, local, (td.P("pop"),), td.P("pop"))(torch.arange(8.0))
    assert torch.equal(out.gather(), torch.arange(8.0) * 2)


def test_init_distributed_needs_its_arguments():
    with pytest.raises(ValueError, match="coordinator_address"):
        td.init_distributed()
    with pytest.raises(ValueError, match="file://"):
        td._make_store("localhost:1", 1, 0, None)
    td.process_barrier()  # one process: nothing to wait for
    err = td.BarrierTimeoutError("b", 1.0, [0], [1])
    assert err.missing == [1] and "never arrived" in str(err)
