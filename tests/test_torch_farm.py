"""The port's rollout farms on the CPU: ``HostRolloutFarm`` in both
placements against the JAX package's with the same injected seed
generator, ``ProcessRolloutFarm`` (2 spawned workers) against the thread
farm bit for bit, clean and with a worker killed mid-generation, the
``min_workers`` floor, re-admission, the authkey handshake (byte for byte
the JAX package's wire), and the farms through ``StdWorkflow`` and
``run_host_pipelined`` (the JAX package's ``test_host_problems.py``,
``test_process_farm.py`` and ``test_chaos.py`` carried over). Every socket
wait is bounded by the farm's timeouts and every process is joined under a
timeout."""

import json
import socket
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.problems.neuroevolution import process_farm as jax_process_farm
from evox_tpu.problems.neuroevolution.rollout_farm import HostRolloutFarm as JaxHostRolloutFarm
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.core.instrument import write_chrome_trace
from evox_tpu_torch.problems.neuroevolution import process_farm
from evox_tpu_torch.problems.neuroevolution.process_farm import (
    FarmDegradedError,
    ProcessRolloutFarm,
    spawn_local_workers,
)
from evox_tpu_torch.problems.neuroevolution.rollout_farm import HostRolloutFarm
from evox_tpu_torch.workflows.pipelined import run_host_pipelined
from tests._farm_helpers import ScalarCartPole as JaxScalarCartPole
from tests._farm_helpers import flat_policy as jax_flat_policy
from tests._torch_farm_helpers import (
    DIM,
    NaNEnv,
    RenderCartPole,
    ScalarCartPole,
    flat_policy,
    reap,
    spawn_chaos_worker,
)

pytestmark = pytest.mark.farm

SEED = 1234
# A decision is a[1] > a[0]; the two packages' float32 policies agree to
# ~1e-6 of the outputs (their dot products sum in different orders), so a
# decision can differ only at a margin below that. Where every margin of a
# run is above MARGIN, the episodes, and so the returns, are equal exactly.
MARGIN = 1e-4


def _pop(n, scale=0.5, seed=0):
    return (scale * np.random.default_rng(seed).standard_normal((n, DIM))).astype(np.float32)


def _margins(farm):
    """Record the smallest |a[1] - a[0]| / max|a| of every batched policy
    call of a port farm."""
    seen = []
    batched = farm.batched_policy

    def recording(params, obs):
        a = batched(params, obs)
        scale = a.abs().amax(dim=1).clamp_min(1e-30)
        seen.append(float(((a[:, 1] - a[:, 0]).abs() / scale).min()))
        return a

    farm.batched_policy = recording
    return seen


@pytest.mark.parametrize("batch_policy", [True, False], ids=["lockstep", "per_worker"])
def test_thread_farm_matches_the_jax_packages(batch_policy):
    """The same injected seed generator in both packages: the same slices,
    episode seeds and returns, two generations."""
    pop = _pop(16)
    ours = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=4,
                           batch_policy=batch_policy, cap_episode=100, device="cpu")
    ref = JaxHostRolloutFarm(jax_flat_policy, JaxScalarCartPole, num_workers=4,
                             batch_policy=batch_policy, cap_episode=100)
    ours._seed_rng, ref._seed_rng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    margins = _margins(ours)
    for _ in range(2):
        f, _ = ours.evaluate(None, pop)
        g, _ = ref.evaluate(ref.init(), jax.numpy.asarray(pop))
        assert isinstance(f, np.ndarray) and f.dtype == np.float32 and f.shape == (16,)
        assert min(margins) > MARGIN
        np.testing.assert_array_equal(f, np.asarray(g))
        assert (f >= 1.0).all()


def test_thread_farm_placements_agree_and_take_tensors():
    pop = _pop(12)
    fits = []
    for batch_policy in (True, False):
        farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=3,
                               batch_policy=batch_policy, cap_episode=60, device="cpu")
        farm._seed_rng = np.random.default_rng(SEED)
        margins = _margins(farm)
        fits.append(farm.evaluate(None, torch.from_numpy(pop))[0])
        assert min(margins) > MARGIN
    np.testing.assert_array_equal(fits[0], fits[1])


def test_rollout_farm_mo_keys():
    farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=2, mo_keys=("aux",),
                           cap_episode=50, device="cpu")
    assert farm.fit_shape(16) == (16, 1)
    fit, _ = farm.evaluate(farm.init(), _pop(16, seed=3))
    assert fit.shape == (16, 1) and (fit >= 1.0).all()  # "aux" is 1.0 a live step


def test_rollout_farm_adaptive_cap():
    farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=2, adaptive_cap=True,
                           cap_episode=100, device="cpu")
    farm.evaluate(None, _pop(8, seed=4))
    assert 1 <= farm.cap <= 200


def test_rollout_farm_fewer_individuals_than_workers():
    farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=8, cap_episode=20,
                           device="cpu")
    fit, _ = farm.evaluate(None, _pop(3, seed=5))
    assert fit.shape == (3,)


def test_rollout_farm_seeds_vary_across_generations():
    """A workflow keeps no state for a host problem, so the farm varies its
    episode seeds itself."""
    farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=2, cap_episode=50,
                           device="cpu")
    pop = _pop(4, scale=0.01, seed=6)
    fits = [farm.evaluate(None, pop)[0] for _ in range(4)]
    assert any(not np.array_equal(fits[0], f) for f in fits[1:])


def test_rollout_farm_visualize_frames():
    farm = HostRolloutFarm(flat_policy, RenderCartPole, num_workers=2, device="cpu")
    params = torch.zeros(DIM)
    frames, rewards = farm.visualize(params, seed=3, max_steps=20)
    assert 1 <= len(frames) <= 20 and frames[0].shape == (32, 32, 3)
    assert len(rewards) == len(frames) and rewards.min() >= 0.0
    farm2 = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=2, device="cpu")
    frames2, _ = farm2.visualize(params, seed=3, max_steps=10, render=False)
    assert frames2[0].shape == (4,)  # the observations


def test_host_farm_per_worker_placement_takes_only_the_cpu():
    """The per-worker placement keeps the farm's ``device`` (the JAX
    package's runs the policy on the default accelerator) and runs each
    worker's policy there: ``meta`` stands for a card here, so the policy's
    output arrives on ``meta`` and the read of its actions raises; no
    worker falls back to the CPU."""
    seen = []

    def policy(params, obs):
        seen.append((params.device.type, obs.device.type))
        return flat_policy(params, obs)

    for batch_policy in (False, True):
        farm = HostRolloutFarm(policy, ScalarCartPole, num_workers=2, batch_policy=batch_policy,
                               cap_episode=5, device="meta")
        assert farm.device == torch.device("meta")
        seen.clear()
        with pytest.raises((NotImplementedError, RuntimeError)):
            farm.evaluate(None, _pop(4))
        assert seen and set(seen) == {("meta", "meta")}


def test_host_farm_nan_env_quarantined():
    """A poisoned simulator reaches the workflow as NaN fitness, and
    quarantine keeps the ES update finite."""
    farm = HostRolloutFarm(flat_policy, NaNEnv, num_workers=2, batch_policy=False,
                           cap_episode=20, device="cpu")
    fit, _ = farm.evaluate(None, _pop(6, scale=0.3, seed=1))
    assert not np.isfinite(fit).any()
    algo = OpenES(torch.zeros(DIM), pop_size=6, learning_rate=0.1, noise_stdev=0.3, device="cpu")
    wf = StdWorkflow(algo, farm, opt_direction="max", quarantine_nonfinite=True, device="cpu")
    s = wf.init(2)
    for _ in range(2):
        s = wf.step(s)
    assert bool(torch.isfinite(s.algo.center).all())


# ------------------------------------------------------------ process farm
def _mk_farm(num_workers, **kw):
    kw.setdefault("request_timeout", 30.0)
    kw.setdefault("heartbeat_timeout", 10.0)
    kw.setdefault("retry_backoff", 0.01)
    farm = ProcessRolloutFarm(flat_policy, ScalarCartPole, num_workers=num_workers,
                              cap_episode=40, host="127.0.0.1", **kw)
    farm._seed_rng = np.random.default_rng(SEED)
    return farm


def _thread_twin(seed=SEED):
    farm = HostRolloutFarm(flat_policy, ScalarCartPole, num_workers=2, batch_policy=False,
                           cap_episode=40, device="cpu")
    farm._seed_rng = np.random.default_rng(seed)
    return farm


def _wait_admitted(farm, n, timeout=90.0):
    deadline = time.monotonic() + timeout
    while len(farm._conns) < n and time.monotonic() < deadline:
        farm.admit()
        time.sleep(0.1)
    assert len(farm._conns) >= n, f"only {len(farm._conns)}/{n} workers joined"


@pytest.fixture(scope="module")
def farm():
    farm = _mk_farm(2)
    procs = spawn_local_workers(farm.address, 2)
    try:
        farm.bind(timeout=120.0)
        yield farm
    finally:
        farm.shutdown()
        assert reap(procs) == [0, 0]


def test_process_farm_equals_the_thread_farm(farm):
    """Same slices, same per-slice seed law: the 2-process farm's fitness
    equals ``HostRolloutFarm(batch_policy=False)``'s bit for bit, over two
    generations on the same workers, and the JAX package's thread farm's."""
    pop = _pop(10)
    farm._seed_rng = np.random.default_rng(SEED)
    local, ref = _thread_twin(), JaxHostRolloutFarm(jax_flat_policy, JaxScalarCartPole,
                                                    num_workers=2, batch_policy=False,
                                                    cap_episode=40)
    ref._seed_rng = np.random.default_rng(SEED)
    margins = _margins(local)
    for _ in range(2):
        f, _ = farm.evaluate(None, pop)
        assert f.dtype == np.float32 and f.shape == (10,) and f.max() >= 1.0
        np.testing.assert_array_equal(f, local.evaluate(None, pop)[0])
        assert min(margins) > MARGIN
        np.testing.assert_array_equal(f, np.asarray(ref.evaluate(None, jax.numpy.asarray(pop))[0]))
    report = farm.health_report()
    assert report["workers_alive"] == 2 and report["workers_dropped"] == 0
    assert report["generations"] >= 2


def test_process_farm_through_pipelined_workflow(farm, tmp_path):
    """The farm is a host problem: ``StdWorkflow`` and
    ``run_host_pipelined`` drive it unchanged; its counter tracks land in
    the Chrome trace."""
    algo = OpenES(torch.zeros(DIM), pop_size=10, learning_rate=0.1, noise_stdev=0.5,
                  device="cpu")
    wf = StdWorkflow(algo, farm, opt_direction="max", device="cpu")
    seen = []
    state = run_host_pipelined(wf, wf.init(1), 3,
                               on_generation=lambda g, s, f: seen.append(float(f.max())))
    assert int(state.generation) == 3 and len(seen) == 3 and all(v >= 1.0 for v in seen)
    tracks = farm.counter_tracks()
    assert sorted(tracks) == ["farm/slices_redispatched", "farm/workers_alive",
                              "farm/workers_dropped"]
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), extra_counters=tracks)
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "C"}
    assert set(tracks) <= names


def test_process_farm_unbound_raises():
    farm = ProcessRolloutFarm(flat_policy, ScalarCartPole, num_workers=1, host="127.0.0.1")
    try:
        with pytest.raises(RuntimeError, match="no workers bound"):
            farm.evaluate(None, np.zeros((2, DIM), np.float32))
    finally:
        farm.shutdown()
    with pytest.raises(ValueError, match="min_workers"):
        ProcessRolloutFarm(flat_policy, ScalarCartPole, num_workers=1, min_workers=2)


def test_process_farm_rejects_wrong_authkey():
    """A peer that fails the HMAC handshake is dropped before any pickle is
    read from it; a worker with the right key binds."""
    farm = ProcessRolloutFarm(flat_policy, ScalarCartPole, num_workers=1, cap_episode=30,
                              host="127.0.0.1", authkey=b"right-key")
    procs = spawn_local_workers(farm.address, 1, authkey=b"wrong-key")
    procs += spawn_local_workers(farm.address, 1, authkey=b"right-key")
    try:
        farm.bind(timeout=120.0)
        assert len(farm._conns) == 1
        fit, _ = farm.evaluate(None, np.zeros((4, DIM), np.float32))
        assert fit.shape == (4,)
    finally:
        farm.shutdown()
        codes = reap(procs)
    assert codes[1] == 0 and codes[0] != 0  # the wrong key's worker died of the refusal


@pytest.mark.chaos
def test_worker_killed_mid_generation_then_the_floor_then_readmission():
    """One worker hard-exits mid-generation: the fitness equals the thread
    farm's bit for bit (its slice is rolled again on the survivor), and the
    health report counts the drop and the redispatch. With the live count
    under ``min_workers`` the next generation raises ``FarmDegradedError``;
    a replacement worker is re-admitted and the same farm object serves a
    generation equal to the thread farm's again."""
    pop = _pop(10)
    chaotic = _mk_farm(2)
    procs = [spawn_chaos_worker(chaotic.address, mode="kill")]
    procs += spawn_local_workers(chaotic.address, 1)
    try:
        chaotic.bind(timeout=120.0)
        f, _ = chaotic.evaluate(None, pop)
        np.testing.assert_array_equal(f, _thread_twin().evaluate(None, pop)[0])
        report = chaotic.health_report()
        assert report["workers_alive"] == 1 and report["workers_dropped"] == 1
        assert report["slices_redispatched"] >= 1
        chaotic.min_workers = 2
        with pytest.raises(FarmDegradedError, match="min_workers=2"):
            chaotic.evaluate(None, pop)
        procs += spawn_local_workers(chaotic.address, 1)
        _wait_admitted(chaotic, 2)
        chaotic._seed_rng = np.random.default_rng(7)
        f, _ = chaotic.evaluate(None, pop)
        np.testing.assert_array_equal(f, _thread_twin(7).evaluate(None, pop)[0])
        assert chaotic.health_report()["workers_alive"] == 2
    finally:
        chaotic.shutdown()
        codes = reap(procs)
    assert codes[0] == 1 and codes[1:] == [0, 0]


@pytest.mark.parametrize("port_is_server", [True, False])
def test_wire_and_handshake_are_the_jax_packages(port_is_server):
    """The length-prefixed pickle frames are byte for byte the JAX
    package's, and a port peer completes the mutual HMAC handshake with a
    JAX peer either way round."""
    msg = {"type": "rollout", "slice": 1, "subpop": np.arange(6.0).reshape(2, 3), "seed": 5,
           "cap": None}
    frames = []
    for module in (process_farm, jax_process_farm):
        a, b = socket.socketpair()
        with a, b:
            module._send(a, msg)
            a.shutdown(socket.SHUT_WR)
            frames.append(b.recv(1 << 16))
    assert frames[0] == frames[1]

    a, b = socket.socketpair()
    server, client = (process_farm, jax_process_farm) if port_is_server else \
        (jax_process_farm, process_farm)
    errors = []
    a.settimeout(10.0)
    b.settimeout(10.0)
    t = threading.Thread(target=lambda: errors.append(
        _try(lambda: client._handshake(b, b"shared", server=False))))
    with a, b:
        t.start()
        server._handshake(a, b"shared", server=True)
        t.join(timeout=10.0)
    assert not t.is_alive() and errors == [None]


def _try(fn):
    try:
        fn()
    except Exception as e:  # reported to the test thread
        return e
    return None


def test_farm_helpers_import_neither_jax_nor_the_jax_package():
    """``chip_smoke.py`` imports the helpers where only the port is
    installed (the port's own modules are checked by
    ``tests/test_torch_workflow.py``)."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "_torch_farm_helpers.py").read_text())
    roots = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert roots and not any(r.split(".")[0] in ("jax", "evox_tpu") for r in roots), roots
