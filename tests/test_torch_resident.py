"""Shard-resident state (``core/distributed.py``'s ``ShardedTensor``) on
the 8-device CPU mesh, against the JAX package's ``P("pop")`` arrays on
its 8 virtual devices.

- ``ShardedES``'s samples stay on their shards between generations: a
  resident run against the live JAX ``ShardedES`` (JAX's draws handed to
  the port shard by shard; ``tests/test_torch_sharded_es.py``'s
  tolerance, rtol 1e-4, atol 1e-4: the two sums add in different orders)
  and against the port's replicated law (``mesh=None, n_shards=8``: the
  samples bit for bit).
- The gather-free check, the counterpart of
  ``tests/test_large_pop.py::test_compiled_hlo_is_gather_free``: no
  operator of the resident step returns the ``(pop, dim)`` shape, the
  shard's shape is there, and a step with one ``.gather()`` fails it.
- ``run_report``'s ``roofline.sharding`` and ``roofline.multihost`` at
  pop 16384, d 64 and 8 positions: the JAX package's fields, thresholds
  and formulas, accepted by ``tools/check_report.py``.
- A resident state's digest, snapshot and casts, and the carry-over of a
  JAX ``P("pop")`` state into a resident port state.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import ShardedES as JaxShardedES
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu import create_mesh as jax_create_mesh
from evox_tpu.algorithms.so.es import SepCMAES as JaxSepCMAES
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.es import SepCMAES
from evox_tpu_torch.core import distributed as td
from evox_tpu_torch.core.cost import analyze_callable
from evox_tpu_torch.problems.numerical import Sphere

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import check_report  # noqa: E402

N_DEV = 8
RTOL = ATOL = 1e-4


def _mesh():
    return td.create_mesh(devices=["cpu"] * N_DEV)


def _wf(mesh, dim, pop, n_shards=None, center=0.0, **kw):
    algo = td.ShardedES(SepCMAES(torch.full((dim,), center), 1.0, pop_size=pop, device="cpu"),
                        mesh=mesh, n_shards=n_shards)
    return StdWorkflow(algo, Sphere(), mesh=mesh, device="cpu", **kw)


def _jax_wf(dim, pop, mesh):
    algo = JaxShardedES(JaxSepCMAES(center_init=jnp.full(dim, 2.0), init_stdev=1.0,
                                    pop_size=pop), mesh=mesh, n_shards=N_DEV)
    return JaxStdWorkflow(algo, JaxSphere(), mesh=mesh)


def _assert_resident(z, pop, dim):
    assert isinstance(z, td.ShardedTensor) and z.positions == list(range(N_DEV))
    assert tuple(z.shape) == (pop, dim)
    assert [tuple(b.shape) for b in z.blocks] == [(pop // N_DEV, dim)] * N_DEV


def test_resident_sharded_es_matches_jax_and_the_replicated_law():
    """3 generations: the samples resident on their 8 shards after every
    step (never a whole ``(pop, dim)`` leaf in the state), equal to the
    port's replicated law bit for bit, and, with JAX's draws handed over,
    to the live JAX ``ShardedES``'s samples bit for bit and its strategy
    within the tolerance."""
    dim, pop = 16, 512
    sh, rp = _wf(_mesh(), dim, pop, center=2.0), _wf(None, dim, pop, n_shards=N_DEV, center=2.0)
    a, b = sh.init(4), rp.init(4)
    _assert_resident(a.algo.z, pop, dim)  # born on its shards
    for _ in range(3):
        a, b = sh.step(a), rp.step(b)
        _assert_resident(a.algo.z, pop, dim)
        assert torch.equal(a.algo.z.gather(), b.algo.z)
    for f in ("mean", "sigma", "C"):
        np.testing.assert_allclose(getattr(a.algo, f).numpy(), getattr(b.algo, f).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f)

    jwf = _jax_wf(dim, pop, jax_create_mesh(devices=jax.devices()[:N_DEV]))
    wf = _wf(_mesh(), dim, pop, center=2.0)
    blocks = []
    wf.algorithm.algorithm._draw = lambda seed, rows=None: blocks.pop(0)
    js, ts = jwf.init(jax.random.PRNGKey(3)), wf.init(3)
    for _ in range(3):
        js = jwf.step(js)
        z = np.asarray(js.algo.z)
        blocks.extend(torch.from_numpy(x.copy()) for x in np.split(z, N_DEV))
        ts = wf.step(ts)
        _assert_resident(ts.algo.z, pop, dim)
        np.testing.assert_array_equal(ts.algo.z.gather().numpy(), z)
    for f in ("mean", "sigma", "C", "ps", "pc"):
        np.testing.assert_allclose(getattr(ts.algo, f).numpy(), np.asarray(getattr(js.algo, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _with_one_gather(wf):
    """``wf`` whose step gathers the resident population once (after the
    ask), as a problem that cannot score blocks would."""
    ask = wf._pipeline_ask_impl

    def ask_and_gather(state):
        cand, ctx = ask(state)
        cand.gather()
        return cand, ctx

    wf._pipeline_ask_impl = ask_and_gather
    return wf


@pytest.mark.parametrize("gather", [False, True], ids=["resident", "one gather"])
def test_resident_step_is_gather_free(gather):
    """The steady step under ``core/cost.py``'s counter: no operator output
    of the ``(pop, dim)`` shape, the shard's ``(pop / 8, dim)`` present,
    each position's peak below the population's bytes; only the
    ``(pop,)`` fitness is gathered. The control with one ``.gather()`` put
    into the step is shown to fail the same check."""
    dim, pop = 32, 16384
    wf = _wf(_mesh(), dim, pop)
    state = wf.step(wf.init(0))
    if gather:
        _with_one_gather(wf)
    fn, args = wf.analysis_targets(state)["step"]
    analysis = analyze_callable(fn, *args)
    shapes = analysis["output_shapes"]
    gather_free = f"{pop}x{dim}" not in shapes
    assert f"{pop // N_DEV}x{dim}" in shapes
    assert gather_free is (not gather)
    assert analysis["gathers"] == (2 if gather else 1)  # the fitness, and the control's gather
    peaks = analysis["memory"]["per_position_peak_bytes"]
    assert sorted(peaks) == [str(s) for s in range(N_DEV)]
    assert (analysis["memory"]["peak_bytes_estimate"] < pop * dim * 4) is (not gather)


def _sharding_report(wf, state):
    from evox_tpu_torch.core.instrument import instrument, run_report

    rec = instrument(wf, analyze=True)
    state = wf.run(state, 1)
    state = wf.run(state, 2)
    return run_report(wf, state, recorder=rec)


def test_roofline_sharding_matches_jax_formulas():
    """pop 16384, d 64, 8 positions: the port's ``roofline.sharding`` has
    the JAX package's fields and the values of its formulas (the same
    axis, shard count, entry and whole-population bytes as JAX's own
    report on its 8 devices; the peak is each package's own measure) and
    ``gather_free``; ``tools/check_report.py`` accepts the report. Under 4
    MiB of population no subsection is attached."""
    from evox_tpu.core.instrument import instrument as jax_instrument
    from evox_tpu.core.instrument import run_report as jax_run_report

    dim, pop = 64, 16384
    wf = _wf(_mesh(), dim, pop)
    report = _sharding_report(wf, wf.init(0))
    got = report["roofline"]["sharding"]
    jwf = _jax_wf(dim, pop, jax_create_mesh(devices=jax.devices()[:N_DEV]))
    jrec = jax_instrument(jwf, analyze=True)
    js = jwf.run(jwf.init(jax.random.PRNGKey(0)), 1)
    want = jax_run_report(jwf, js, recorder=jrec)["roofline"]["sharding"]
    assert set(got) == set(want)
    for key in ("axis", "n_devices", "pop_size", "entry", "full_pop_bytes", "gather_free"):
        assert got[key] == want[key], key
    assert got["full_pop_bytes"] == pop * dim * 4 and got["gather_free"] is True
    assert got["per_device_peak_bytes"] < got["full_pop_bytes"]
    assert check_report.validate_run_report(report) == []
    small = _wf(_mesh(), 16, 1024)
    assert "sharding" not in _sharding_report(small, small.init(0))["roofline"]


def test_roofline_multihost_matches_jax_formulas(monkeypatch):
    """The ``roofline.multihost`` subsection in a process group of two (the
    group's size read as 2; this process holding all 8 positions): the
    per-process peak is the per-position peak times the local positions,
    and the collective estimate is ``2 pop 4`` plus the bytes of the moment
    tree, which JAX's ``eval_shape`` of its ``pop_moments`` sizes the same
    way; ``tools/check_report.py`` accepts it. Outside a group, none."""
    dim, pop = 64, 16384
    wf = _wf(_mesh(), dim, pop)
    state = wf.init(0)
    assert "multihost" not in _sharding_report(wf, state)["roofline"]
    monkeypatch.setattr(td, "process_count", lambda: 2)
    report = _sharding_report(_wf(_mesh(), dim, pop), state)
    got = report["roofline"]["multihost"]
    jalgo = JaxSepCMAES(center_init=jnp.zeros(dim), init_stdev=1.0, pop_size=pop)
    shard = pop // N_DEV
    moments = jax.eval_shape(jalgo.pop_moments,
                             {"z": jax.ShapeDtypeStruct((shard, dim), jnp.float32)},
                             jax.ShapeDtypeStruct((shard,), jnp.float32))
    want = 2 * pop * 4 + sum(int(np.prod(m.shape)) * 4 for m in jax.tree_util.tree_leaves(moments))
    assert got["collective_bytes_estimate"] == want
    assert got["process_count"] == 2 and got["n_local_devices"] == N_DEV
    assert got["per_process_peak_bytes"] == got["per_device_peak_bytes"] * N_DEV
    assert got["full_pop_bytes"] == pop * dim * 4
    assert got["per_device_peak_bytes"] == report["roofline"]["sharding"]["per_device_peak_bytes"]
    assert check_report.validate_run_report(report) == []


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 512), (torch.float64, 67),
                                        (torch.int8, 13), (torch.float32, 5)],
                         ids=["f32", "f64 uneven", "int8 uneven", "fewer rows than shards"])
def test_state_digest_of_a_resident_leaf_equals_the_gathered_one(dtype, rows):
    """``state_digest`` and ``leaf_digests`` of a state with a resident
    leaf (its blocks each at their words' offset in one leaf's digest)
    equal those of the gathered state bit for bit, and equal the host
    digest; on blocks that differ in size and empty blocks too."""
    from evox_tpu_torch.core.attest import host_state_digest, leaf_digests, state_digest

    g = torch.Generator().manual_seed(rows)
    x = (torch.randn(rows, 3, generator=g, dtype=torch.float64).to(dtype)
         if dtype.is_floating_point else torch.randint(-100, 100, (rows, 3), generator=g,
                                                       dtype=dtype))
    resident = {"a": td.ShardedTensor.from_tensor(x, _mesh(), td.P("pop")), "b": torch.ones(4),
                "seed": 7}
    whole = {"a": x, "b": torch.ones(4), "seed": 7}
    assert torch.equal(state_digest(resident), state_digest(whole))
    got, want = leaf_digests(resident), leaf_digests(whole)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(state_digest(resident).numpy().astype(np.uint32),
                                  host_state_digest(whole))


def test_a_resident_leaf_on_several_devices_digests_a_device_at_a_time():
    """Blocks of one resident leaf on several devices (a mesh of distinct
    cards) are digested a device's entries at a time and the leaf's rows
    merged: the gathered state's words, bit for bit. The CPU's blocks are
    split here into two device groups, as two cards' blocks would be."""
    from evox_tpu_torch.core import attest
    from evox_tpu_torch.core.attest import leaf_digests, state_digest

    x = torch.randn(64, 3, generator=torch.Generator().manual_seed(9))
    resident = td.ShardedTensor.from_tensor(x, _mesh(), td.P("pop"))
    entries = (attest._entries(resident, "['a']", attest._salt("['a']"))
               + attest._entries(torch.ones(4), "['b']", attest._salt("['b']")))
    groups = {torch.device("cpu"): entries[:3] + entries[-1:],
              torch.device("cpu", 1): entries[3:-1]}
    combined, leaves = attest._combine_rows(groups, attest._combine_host([]), [], {}, True, None)
    whole = {"a": x, "b": torch.ones(4)}
    assert torch.equal(combined, state_digest(whole))
    want = leaf_digests(whole)
    assert set(leaves) == set(want) and all(torch.equal(leaves[k], want[k]) for k in want)


def test_a_resident_snapshot_resumes_without_a_mesh(tmp_path):
    """A snapshot of a resident run holds the gathered samples; a workflow
    without a mesh (the replicated law) restores it bit for bit and steps
    on, and its next samples equal the resident run's."""
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    dim, pop = 8, 64
    sh = _wf(_mesh(), dim, pop)
    state = sh.run(sh.init(5), 3)
    ck = WorkflowCheckpointer(tmp_path, every=1)
    ck.save(state)
    flat = _wf(None, dim, pop, n_shards=N_DEV)
    restored = ck.latest(expect_like=flat.init(0))
    assert isinstance(restored.algo.z, torch.Tensor)
    assert torch.equal(restored.algo.z, state.algo.z.gather())
    for f in ("mean", "C", "sigma", "ps", "pc"):
        assert torch.equal(getattr(restored.algo, f), getattr(state.algo, f)), f
    on = flat.resume(ck, 4)
    assert torch.equal(on.algo.z, sh.step(state).algo.z.gather())


def test_a_jax_pop_sharded_state_becomes_resident():
    """``interop.sharded_es_state``: the JAX ``ShardedES`` state after a
    step (numpy, ``z`` whole) becomes a port state whose ``z`` is resident
    on the 8 positions with the same bits; from it both packages ask the
    same population (JAX's draws handed to the port)."""
    from evox_tpu_torch.interop import algorithm_state

    dim, pop = 16, 512
    jwf = _jax_wf(dim, pop, jax_create_mesh(devices=jax.devices()[:N_DEV]))
    js = jwf.step(jwf.init(jax.random.PRNGKey(2)))
    jstate = jax.tree.map(np.asarray, js.algo)
    wf = _wf(_mesh(), dim, pop, center=2.0)
    state = algorithm_state(wf.algorithm, jstate)
    _assert_resident(state.z, pop, dim)
    np.testing.assert_array_equal(state.z.gather().numpy(), jstate.z)
    jpop, jnext = jwf.algorithm.ask(js.algo)
    z = np.asarray(jnext.z)
    blocks = [torch.from_numpy(x.copy()) for x in np.split(z, N_DEV)]
    wf.algorithm.algorithm._draw = lambda seed, rows=None: blocks.pop(0)
    tpop, tnext = wf.algorithm.ask(state)
    np.testing.assert_array_equal(tnext.z.gather().numpy(), z)
    np.testing.assert_allclose(tpop.gather().numpy(), np.asarray(jpop), rtol=1e-6, atol=1e-6)


def test_a_resident_leaf_is_cast_block_by_block_and_refuses_arithmetic():
    """A bf16 storage policy casts a resident leaf block by block and back
    (the same bits as casting the gathered leaf); ``map_tensors`` keeps it
    resident; arithmetic, indexing, torch functions and pickling raise."""
    import pickle

    from evox_tpu_torch.core.dtype_policy import BF16_STORAGE, apply_compute, apply_storage
    from evox_tpu_torch.core.dtype_policy import _cast_leaf
    from evox_tpu_torch.core.struct import map_tensors

    wf = _wf(_mesh(), 8, 64)
    state = wf.step(wf.init(1)).algo
    stored = apply_storage(state, BF16_STORAGE)
    assert isinstance(stored.z, td.ShardedTensor) and stored.z.dtype == torch.bfloat16
    assert torch.equal(stored.z.gather(), _cast_leaf(state.z.gather(), torch.bfloat16))
    back = apply_compute(stored, BF16_STORAGE)
    assert back.z.dtype == torch.float32 and isinstance(back.z, td.ShardedTensor)
    copied = map_tensors(torch.clone, state)
    assert isinstance(copied.z, td.ShardedTensor)
    assert torch.equal(copied.z.gather(), state.z.gather())
    for bad in (lambda z: z + 1, lambda z: 2 * z, lambda z: z[0], lambda z: torch.sum(z),
                lambda z: torch.ones(64, 8) * z, lambda z: np.asarray(z), pickle.dumps):
        with pytest.raises(TypeError, match="resident leaf"):
            bad(state.z)


@pytest.mark.parametrize("reader", ["monitor", "pop transform"])
def test_a_population_reader_takes_one_counted_gather(reader):
    """A monitor with a population hook, or a pop transform, reads the
    whole population: the step gathers the resident population once (and
    counts it), hands the reader the gathered value, and the run's states
    equal those of the same run without the reader, bit for bit."""
    from evox_tpu_torch.core.monitor import Monitor

    seen = []

    class PopSeen(Monitor):
        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            seen.append((cand, fitness))
            return mstate

    dim, pop = 8, 64
    kw = ({"monitors": (PopSeen(),)} if reader == "monitor"
          else {"pop_transforms": (lambda x: seen.append((x, None)) or x,)})
    wf, bare = _wf(_mesh(), dim, pop, **kw), _wf(_mesh(), dim, pop)
    s0 = wf.init(6)
    before = td.gather_counts()["calls"]
    a, b = wf.step(s0), bare.step(bare.init(6))
    # the reader's gather (the reader's run then scores the whole population)
    # and the bare run's fitness gather
    assert td.gather_counts()["calls"] - before == 2
    (cand, _), = seen
    assert isinstance(cand, torch.Tensor) and tuple(cand.shape) == (pop, dim)
    assert torch.equal(cand, s0.algo.mean + s0.algo.sigma * torch.sqrt(s0.algo.C)
                       * a.algo.z.gather())
    for f in ("mean", "sigma", "C"):
        assert torch.equal(getattr(a.algo, f), getattr(b.algo, f)), f
    assert torch.equal(a.algo.z.gather(), b.algo.z.gather())


def test_a_stateful_problem_scores_the_gathered_population_and_advances_its_state():
    """A problem whose state is a Python int (a rollout's episode-reset seed,
    advanced by every ``evaluate`` with ``stochastic_reset``) is not scored
    block by block: the step gathers the resident population once, the
    problem evaluates it whole and its seed advances each generation: the
    fitness and seed bit for bit those of the problem's own ``evaluate`` on
    the gathered population, the samples and seed those of the port's
    replicated law (its strategy within the tolerance above)."""
    from evox_tpu_torch.kernels import rollout as tkr
    from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, flat_mlp_policy

    apply, dim = flat_mlp_policy(3, 4, 1)
    soa, pop = tkr.pendulum_soa(8), 16

    def wf(mesh, n_shards=None):
        algo = td.ShardedES(SepCMAES(torch.zeros(dim), 0.3, pop_size=pop, device="cpu"),
                            mesh=mesh, n_shards=n_shards)
        prob = PolicyRolloutProblem(apply, soa.base, num_episodes=2, stochastic_reset=True,
                                    early_exit=False, device="cpu")
        return StdWorkflow(algo, prob, mesh=mesh, device="cpu", opt_direction="max")

    sh, rp = wf(_mesh()), wf(None, n_shards=N_DEV)
    a, b = sh.init(2), rp.init(2)
    seeds = [a.prob.seed]
    for _ in range(2):
        cand = sh.algorithm.ask(a.algo)[0]
        want, want_state = sh.problem.evaluate(a.prob, cand.gather())
        before = td.gather_counts()["calls"]
        got, got_state = sh._evaluate(a.prob, cand)
        assert td.gather_counts()["calls"] - before == 1
        assert torch.equal(got, want) and got_state.seed == want_state.seed
        a, b = sh.step(a), rp.step(b)
        _assert_resident(a.algo.z, pop, dim)
        assert a.prob.seed == b.prob.seed
        assert torch.equal(a.algo.z.gather(), b.algo.z)
        seeds.append(a.prob.seed)
        for f in ("mean", "sigma", "C"):
            np.testing.assert_allclose(getattr(a.algo, f).numpy(), getattr(b.algo, f).numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
    assert len(set(seeds)) == 3
