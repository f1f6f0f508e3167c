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
  spans the processes, and ``BarrierTimeoutError`` naming the process that
  stayed away; held against the single-process results (the JAX package's
  own multi-process tests fail on this tree). Computing on such a mesh is
  refused until ROADMAP A11's shard-resident state lands.
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
    assert torch.equal(out["rows"], x + 1)
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
    res["mine"] = mine.tolist()
    res["gathered"] = d.host_value(mine, mesh).tolist()
    try:
        d.shard_map(lambda x: x, mesh, (d.P("pop"),), d.P("pop"))
        res["refused"] = False
    except NotImplementedError:
        res["refused"] = True
    if rank == 0:
        try:
            d.process_barrier("second", timeout_s=1.0)
            res["timeout"] = None
        except d.BarrierTimeoutError as e:
            res["timeout"] = {{"missing": e.missing, "arrived": e.arrived}}
    json.dump(res, open(out, "w"))
    d.shutdown_distributed() if rank == 1 else None
""")


def test_two_processes_over_gloo(tmp_path):
    """A barrier, a gathered host value and a barrier timeout naming the
    process that never came, across two processes; the gathered value
    equals the single-process one."""
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
    assert res[0]["spans"] and res[1]["spans"]
    assert res[0]["refused"] and res[1]["refused"]  # no computation spans processes yet
    assert res[0]["mine"] == [0.0, 1.0, 2.0, 3.0] and res[1]["mine"] == [4.0, 5.0, 6.0, 7.0]
    single = td.host_value(torch.arange(8, dtype=torch.float32)).tolist()
    assert res[0]["gathered"] == single and res[1]["gathered"] == single
    assert res[0]["timeout"] == {"missing": [1], "arrived": [0]}


def test_a_mesh_that_spans_processes_computes_nothing():
    """The single-controller mesh runs every shard in the calling process,
    so every computing entry point refuses a mesh of two processes' devices
    (each process would redo every shard); ROADMAP A11 holds the rest."""
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import IslandWorkflow, StdWorkflow, VectorizedWorkflow

    pod = td.Mesh(["cpu"] * 4, ("pop",), processes=[0, 0, 1, 1])
    assert td.mesh_spans_processes(pod)
    algo = SepCMAES(torch.zeros(4), 1.0, pop_size=8, device="cpu")
    pso = PSO(torch.full((4,), -1.0), torch.ones(4), pop_size=8, device="cpu")
    refusals = [
        lambda: td.shard_map(lambda x: x, pod, (td.P("pop"),), td.P("pop")),
        lambda: td.ShardedES(algo, mesh=pod),
        lambda: non_dominated_sort(torch.rand(40, 2), mesh=pod),
        lambda: StdWorkflow(algo, Sphere(), mesh=pod, device="cpu"),
        lambda: IslandWorkflow(pso, Sphere(), n_islands=4, mesh=pod, device="cpu"),
        lambda: VectorizedWorkflow(pso, Sphere(), n_tenants=2,
                                   mesh=td.Mesh([["cpu"] * 2] * 2, ("tenant", "pop"),
                                                processes=[[0, 0], [1, 1]]), device="cpu"),
    ]
    for make in refusals:
        with pytest.raises(NotImplementedError, match="spans processes.*A11"):
            make()
    # the same mesh on one process computes
    local = td.Mesh(["cpu"] * 4, ("pop",))
    out = td.shard_map(lambda x: x * 2, local, (td.P("pop"),), td.P("pop"))(torch.arange(8.0))
    assert torch.equal(out, torch.arange(8.0) * 2)


def test_init_distributed_needs_its_arguments():
    with pytest.raises(ValueError, match="coordinator_address"):
        td.init_distributed()
    with pytest.raises(ValueError, match="file://"):
        td._make_store("localhost:1", 1, 0, None)
    td.process_barrier()  # one process: nothing to wait for
    err = td.BarrierTimeoutError("b", 1.0, [0], [1])
    assert err.missing == [1] and "never arrived" in str(err)
