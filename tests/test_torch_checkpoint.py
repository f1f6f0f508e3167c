"""Crash-safe checkpointing in the port (``workflows/checkpoint.py``,
``core/state_io.py``, ``monitors/checkpoint_monitor.py``, the host half of
``core/attest.py``): durability, the config guard, and the resume law —
a run resumed from a snapshot reproduces the straight run bit for bit —
on the CPU, with the digests held against the JAX package's."""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.core import attest as jattest
from evox_tpu_torch import GuardedAlgorithm, IPOPRestarts, StdWorkflow
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so.es import CMAES
from evox_tpu_torch.algorithms.so.pso import CSO, PSO
from evox_tpu_torch.core import attest, state_io
from evox_tpu_torch.core.dtype_policy import BF16_STORAGE, _cast_leaf
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.monitors import CheckpointMonitor, EvalMonitor
from evox_tpu_torch.problems.numerical import ZDT1, Ackley, Rastrigin, Sphere
from evox_tpu_torch.workflows import (
    CheckpointConfigError,
    WorkflowCheckpointer,
    run_host_pipelined,
)
from evox_tpu_torch.workflows.checkpoint import (
    chunk_to_boundary,
    restore_layouts,
    snapshot_dir_intact,
    state_config_fingerprint,
)


def _leaves(state):
    return [leaf for _, leaf in named_leaves(state) if isinstance(leaf, torch.Tensor)]


def _assert_same(a, b):
    assert a.generation == b.generation
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.uint8) if y.dtype == torch.bfloat16 else y)


def _cso(pop=16, dim=6, **kw):
    lb, ub = -32 * np.ones(dim, np.float32), 32 * np.ones(dim, np.float32)
    return StdWorkflow(CSO(lb, ub, pop, device="cpu"), Ackley(), device="cpu", **kw)


def test_save_latest_round_trip_and_pruning(tmp_path):
    wf = _cso()
    ck = WorkflowCheckpointer(tmp_path, every=2, keep=2)
    state = wf.run(wf.init(0), 7, checkpointer=ck)
    # snapshots at 2, 4, 6 and the final 7; two kept
    assert [p.name for p in ck.snapshots()] == ["ckpt_00000006.pkl", "ckpt_00000007.pkl"]
    restored = ck.latest(expect_like=state)
    assert restored.generation == 7
    _assert_same(restore_layouts(restored, "cpu"), state)
    manifest = json.loads((tmp_path / "ckpt_00000007.pkl.manifest.json").read_text())
    # the per-leaf sharding record lists the annotated leaves a mesh
    # splits: this state has none
    assert manifest["generation"] == 7 and manifest["save_topology"] == {
        "device": "cpu", "process_count": 1, "leaf_shardings": {}}
    assert manifest["attest"]["digest"] == attest.digest_hex(attest.host_state_digest(state))
    assert manifest["config_sha"] == state_config_fingerprint(state)
    assert json.loads((tmp_path / "checkpointer.json").read_text()) == {"every": 2, "keep": 2}
    assert ck.load(6).generation == 6 and ck.load(5) is None
    assert snapshot_dir_intact(tmp_path) and not snapshot_dir_intact(tmp_path / "empty")
    assert ck.maybe_save(state) is None  # 7 is off the cadence
    assert chunk_to_boundary(state, ck) == 1 and chunk_to_boundary(state, None, 5) == 3
    with pytest.raises(ValueError):
        WorkflowCheckpointer(tmp_path, every=0)


@pytest.mark.parametrize("damage", ["torn_data", "torn_manifest", "digest"])
def test_a_damaged_snapshot_is_skipped_with_a_warning(tmp_path, damage):
    wf = _cso()
    ck = WorkflowCheckpointer(tmp_path, every=3, keep=5)
    wf.run(wf.init(1), 6, checkpointer=ck)
    newest = tmp_path / "ckpt_00000006.pkl"
    manifest = newest.with_suffix(".pkl.manifest.json")
    if damage == "torn_data":
        newest.write_bytes(newest.read_bytes()[:100])
    elif damage == "torn_manifest":
        manifest.write_text(manifest.read_text()[:40])
    else:  # intact bytes, but not the state the manifest attests
        m = json.loads(manifest.read_text())
        m["attest"]["digest"] = "0" * 48
        manifest.write_text(json.dumps(m))
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint ckpt_00000006"):
        got = ck.latest()
    assert got.generation == 3
    assert snapshot_dir_intact(tmp_path)


def test_a_changed_config_raises_unless_allowed(tmp_path):
    ck = WorkflowCheckpointer(tmp_path, every=2)
    _cso(pop=16).run(_cso(pop=16).init(0), 2, checkpointer=ck)
    other = _cso(pop=18)
    with pytest.raises(CheckpointConfigError, match="different run config"):
        ck.latest(expect_like=other.init(0))
    with pytest.raises(CheckpointConfigError):
        other.resume(ck, 4)
    assert ck.latest(expect_like=other.init(0), allow_config_mismatch=True).generation == 2
    # and a storage policy and the monitor set are part of the config
    with pytest.raises(CheckpointConfigError):
        _cso(pop=16, dtype_policy=BF16_STORAGE).resume(ck, 4)
    with pytest.raises(CheckpointConfigError):
        _cso(pop=16, monitors=(EvalMonitor(device="cpu"),)).resume(ck, 4)


def _resume_law(tmp_path, wf_factory, total, crash_at, every, seed=0):
    """The straight run, a run that stops at ``crash_at`` with the
    checkpointer on, and a fresh workflow's ``resume`` to ``total``."""
    wf = wf_factory()
    straight = wf.run(wf.init(seed), total)
    ck = WorkflowCheckpointer(tmp_path, every=every)
    crashed = wf_factory()
    crashed.run(crashed.init(seed), crash_at, checkpointer=ck)
    resumed = wf_factory().resume(WorkflowCheckpointer(tmp_path, every=every), total)
    _assert_same(resumed, straight)
    # a run called again with the same arguments after the crash finishes it too
    again = wf_factory()
    _assert_same(again.run(again.init(seed), total, resume_from=str(tmp_path)), straight)
    return straight


def test_resume_law_cso(tmp_path):
    _resume_law(tmp_path, _cso, 11, 7, 3)


def test_resume_law_cso_bf16(tmp_path):
    straight = _resume_law(tmp_path, lambda: _cso(dtype_policy=BF16_STORAGE), 9, 5, 2)
    assert straight.algo.population.dtype == torch.bfloat16


def test_resume_law_cmaes(tmp_path):
    make = lambda: StdWorkflow(CMAES(np.full(8, 2.0), 1.0, pop_size=10, device="cpu"),  # noqa: E731
                               Rastrigin(), monitors=(EvalMonitor(device="cpu"),), device="cpu")
    _resume_law(tmp_path, make, 10, 6, 4)


def test_resume_law_nsga2(tmp_path):
    make = lambda: StdWorkflow(NSGA2(np.zeros(6), np.ones(6), n_objs=2, pop_size=12,  # noqa: E731
                                     device="cpu"), ZDT1(n_dim=6, device="cpu"), device="cpu")
    _resume_law(tmp_path, make, 9, 5, 3)


class _HostSphere:
    jittable = False

    def init(self, seed=None):
        return None

    def evaluate(self, state, pop):
        return np.sum(pop.astype(np.float64) ** 2, axis=1), state


def test_resume_law_host_pipelined(tmp_path):
    lb, ub = -5 * np.ones(4, np.float32), 5 * np.ones(4, np.float32)
    make = lambda: StdWorkflow(PSO(lb, ub, 12, device="cpu"), _HostSphere(), device="cpu")  # noqa: E731
    wf = make()
    straight = run_host_pipelined(wf, wf.init(0), 8)
    ck = WorkflowCheckpointer(tmp_path, every=3)
    crashed = make()
    run_host_pipelined(crashed, crashed.init(0), 5, checkpointer=ck)
    assert [p.name for p in ck.snapshots()] == ["ckpt_00000003.pkl", "ckpt_00000005.pkl"]
    again = make()
    resumed = run_host_pipelined(again, again.init(0), 8, resume_from=ck, eval_chunk=5)
    _assert_same(resumed, straight)
    _assert_same(make().resume(WorkflowCheckpointer(tmp_path, every=3), 8), straight)


class _Plateau:
    """Constant fitness: CMA-ES stagnates and the guard restarts it."""

    def init(self, seed=None):
        return None

    def evaluate(self, state, pop):
        return torch.zeros(pop.shape[0]), state


def test_resume_law_ipop_across_a_doubling(tmp_path):
    make_algo = lambda pop: GuardedAlgorithm(  # noqa: E731
        CMAES(np.full(4, 3.0), 1.0, pop_size=pop, device="cpu"), stagnation_limit=3)
    policy = IPOPRestarts(make_algo, max_restarts=2, check_every=5)
    make = lambda: StdWorkflow(make_algo(8), _Plateau(), device="cpu")  # noqa: E731
    wf = make()
    straight = wf.run(wf.init(0), 17, restarts=policy)
    assert [e["pop_size"] for e in wf._ipop_events] == [16, 32]
    ck = WorkflowCheckpointer(tmp_path, every=5)
    crashed = make()
    mid = crashed.run(crashed.init(0), 12, restarts=policy, checkpointer=ck)
    assert mid.algo.pop_size == 32 and ck.latest().algo.pop_size == 32
    resumed_wf = make()  # built at λ 8: the resume rebuilds λ 32 first
    resumed = resumed_wf.run(resumed_wf.init(0), 17, restarts=policy, resume_from=ck)
    _assert_same(resumed, straight)
    assert resumed.algo.pop_size == 32
    assert resumed_wf._ipop_events[0]["resumed"] is True


def test_state_io_pickle_round_trip(tmp_path):
    wf = _cso(dtype_policy=BF16_STORAGE)
    state = wf.run(wf.init(2), 3)
    state_io.save(state, tmp_path / "s.pkl")
    state_io.wait_for_saves()
    back = state_io.load(tmp_path / "s.pkl")
    _assert_same(back, state)
    _assert_same(wf.step(restore_layouts(back, "cpu")), wf.step(state))
    with pytest.raises(ValueError, match="JAX library"):
        state_io.save(state, tmp_path / "o", backend="orbax")
    with pytest.raises(ValueError, match="unknown"):
        state_io.load(tmp_path / "s.pkl", backend="npz")


def test_checkpoint_monitor_cadence(tmp_path):
    mon = CheckpointMonitor(str(tmp_path), every=3, keep=2)
    lb, ub = -np.ones(3, np.float32), np.ones(3, np.float32)
    wf = StdWorkflow(PSO(lb, ub, 8, device="cpu"), Sphere(), monitors=(mon,), device="cpu")
    state = wf.run(wf.init(0), 10)
    # the monitor writes WorkflowCheckpointer's format: data, manifest, config
    assert [p.name for p in mon.saved] == ["ckpt_00000006.pkl", "ckpt_00000009.pkl"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpointer.json",
        "ckpt_00000006.pkl", "ckpt_00000006.pkl.manifest.json",
        "ckpt_00000009.pkl", "ckpt_00000009.pkl.manifest.json",
    ]
    latest = mon.latest()
    assert latest.generation == 9
    assert WorkflowCheckpointer(str(tmp_path)).latest().generation == 9
    resumed = wf.run(restore_layouts(latest, "cpu"), 1)
    _assert_same(resumed, state)
    # a torn file that still unpickles is caught by the manifest's SHA-256
    torn = tmp_path / "ckpt_00000009.pkl"
    torn.write_bytes(pickle.dumps(latest.replace(generation=9999)))
    with pytest.warns(UserWarning, match="skipping corrupt"):
        assert CheckpointMonitor(str(tmp_path), every=3).latest().generation == 6


def test_bf16_snapshot_round_trip(tmp_path):
    wf = _cso(dtype_policy=BF16_STORAGE)
    state = wf.run(wf.init(4), 4)
    assert state.algo.velocity.dtype == torch.bfloat16
    ck = WorkflowCheckpointer(tmp_path, every=4)
    ck.save(state)
    back = ck.latest(expect_like=state)
    assert back.algo.velocity.dtype == torch.bfloat16
    _assert_same(back, state)
    # the fingerprint records the storage dtype
    assert state_config_fingerprint(state) != state_config_fingerprint(_cso().run(_cso().init(4), 4))


LEAVES = {
    "f32": np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32),
    "int32": np.arange(-3, 9, dtype=np.int32),
    "bool": np.array([True, False, True]),
    "zeros": np.array([0.0, -0.0, 0.0], np.float32),
    "nan_inf": np.array([np.nan, np.inf, -np.inf, 1.0], np.float32),
    "empty": np.zeros((0, 4), np.float32),
    "scalar_int": 7,
    "scalar_float": 0.25,
}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaf_digest_matches_jax(name):
    leaf = LEAVES[name]
    want = jattest.digest_hex(jattest._leaf_digest_np(leaf, 1234))
    assert attest.digest_hex(attest._leaf_digest_np(leaf, 1234)) == want
    if isinstance(leaf, np.ndarray):  # the same words from a tensor
        assert attest.digest_hex(attest._leaf_digest_np(torch.from_numpy(leaf), 1234)) == want


def test_bf16_digest_matches_jax():
    """A bfloat16 leaf digests as its 16-bit words, and neither package
    counts its NaN or inf (numpy does not class ml_dtypes' bfloat16 as
    floating)."""
    values = np.array([1.5, np.nan, -np.inf, np.inf, -0.0, 3e-40], np.float32)
    jleaf = np.asarray(jnp.asarray(values).astype(jnp.bfloat16))
    tleaf = _cast_leaf(torch.from_numpy(values), torch.bfloat16)  # the policy's cast
    np.testing.assert_array_equal(tleaf.view(torch.int16).numpy().view(np.uint16),
                                  jleaf.view(np.uint16))
    want = jattest.digest_hex(jattest.host_state_digest({"x": jleaf}))
    assert attest.digest_hex(attest.host_state_digest({"x": tleaf})) == want
    assert want.endswith("0" * 16)  # words 4 and 5: no NaN, no inf counted


def test_state_digest_and_leaf_digests_match_jax():
    tree = {"a": LEAVES["f32"], "b": (LEAVES["int32"], LEAVES["bool"]), "c": LEAVES["nan_inf"]}
    want = jattest.digest_hex(jattest.host_state_digest(tree))
    assert attest.digest_hex(attest.host_state_digest(tree)) == want
    as_tensors = {"a": torch.from_numpy(tree["a"]), "b": tuple(map(torch.from_numpy, tree["b"])),
                  "c": torch.from_numpy(tree["c"])}
    assert attest.digest_hex(attest.host_state_digest(as_tensors)) == want
    assert attest.host_leaf_digests(as_tensors) == jattest.host_leaf_digests(tree)
    assert attest.digest_hex(attest.host_state_digest({})) == jattest.digest_hex(
        jattest.host_state_digest({}))
    with pytest.raises(ValueError, match="6 words"):
        attest.digest_hex(np.zeros(5, np.uint32))
