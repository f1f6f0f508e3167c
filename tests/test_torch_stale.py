"""Stale tells in the port (``GenerationExecutor(max_staleness=K)``,
``run_host_pipelined(max_staleness=K)``) against the JAX package's stale
loop on the CPU, tell by tell, with JAX's draws handed to the port.

JAX's OpenES draws its noise from the ask's key; the port's from
``_draw_noise(noise_seed)``. Both loops issue their asks in the same order
(an ask while ``asked - told <= K``, a tell on the oldest evaluation), so
the test records JAX's noise key of each ask, in order, and the port's
``_draw_noise`` returns the next of them for each seed it has not seen
(the tell of that generation sees the same seed again, grafted from its
own ask)."""

import time

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.core.executor import GenerationExecutor as JaxExecutor
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.dtype_policy import BF16_STORAGE
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.instrument import run_report
from evox_tpu_torch.core.monitor import Monitor
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows import run_host_pipelined

from tests.test_torch_instrument import _check_valid

# One OpenES tell is a (pop/2, dim) x (pop/2,) product and an elementwise
# update in float32 that the two libraries sum in different orders, and
# the fitness of later generations reads the centers so drifted
# (tests/test_torch_openes.py holds one tell to 1e-5; 16 tells compound it).
CENTER_RTOL, CENTER_ATOL = 2e-5, 2e-6
POP, DIM, GENS = 16, 4, 16


class HostSphere:
    """A host Sphere (numpy in, numpy out) that both packages drive; it may
    sleep, which makes evaluations overlap at K > 0."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self, sleep: float = 0.0):
        self.sleep = sleep

    def init(self, key=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        if self.sleep:
            time.sleep(self.sleep)
        return np.sum(np.asarray(pop, np.float32) ** 2, axis=1).astype(np.float32), state


def _center0():
    return np.random.default_rng(3).normal(size=DIM).astype(np.float32) + 2.0


def _jax_stale_run(K):
    """JAX's stale run: each ask's noise, in ask order, and each tell's
    center, in tell order."""
    jwf = JaxStdWorkflow(JaxOpenES(_center0(), POP, learning_rate=0.1, noise_stdev=0.2),
                         HostSphere())
    noises, centers = [], []
    ask, tell = jwf.pipeline_ask, jwf.pipeline_tell

    def recording_ask(state):
        cand, ctx = ask(state)
        noises.append(np.asarray(jax.random.normal(ctx[0].noise_key, (POP // 2, DIM))))
        return cand, ctx

    def recording_tell(*args):
        out = tell(*args)
        centers.append(np.asarray(out.algo.center))
        return out

    jwf.pipeline_ask, jwf.pipeline_tell = recording_ask, recording_tell
    ex = JaxExecutor(max_staleness=K)
    ex.run_host(jwf, jwf.init(jax.random.PRNGKey(7)), GENS)
    return noises, centers, ex.report()


@pytest.fixture(scope="module", params=[1, 2], ids=["K1", "K2"])
def jax_stale(request):
    return request.param, _jax_stale_run(request.param)


def _port_openes(noises, monitors=()):
    algo = OpenES(_center0(), POP, learning_rate=0.1, noise_stdev=0.2, device="cpu")
    by_seed = {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.from_numpy(np.array(noises[len(by_seed)]))
        return by_seed[seed]

    algo._draw_noise = draw
    return StdWorkflow(algo, HostSphere(), monitors=monitors, device="cpu"), by_seed


def _record_tells(wf):
    centers = []
    tell = wf.pipeline_tell

    def recording_tell(*args):
        out = tell(*args)
        centers.append(out.algo.center.numpy().copy())
        return out

    wf.pipeline_tell = recording_tell
    return centers


@pytest.mark.parametrize("entry", ["executor", "run_host_pipelined"])
def test_stale_run_equals_jax_tell_by_tell(jax_stale, entry):
    K, (noises, jax_centers, jax_report) = jax_stale
    wf, by_seed = _port_openes(noises)
    centers = _record_tells(wf)
    ex = GenerationExecutor(max_staleness=K)
    if entry == "executor":
        state = ex.run_host(wf, wf.init(7), GENS)
    else:  # the executor's configured K is honoured
        state = run_host_pipelined(wf, wf.init(7), GENS, executor=ex)
    assert state.generation == GENS
    assert len(by_seed) == len(noises) == GENS  # one draw an ask, every ask distinct
    assert len(centers) == len(jax_centers) == GENS
    for g, (got, want) in enumerate(zip(centers, jax_centers)):
        np.testing.assert_allclose(got, want, rtol=CENTER_RTOL, atol=CENTER_ATOL,
                                   err_msg=f"tell {g}")
    # the counters are the JAX loop's
    rep = ex.report()
    for key in ("asks", "tells", "stale_tells", "max_lag", "generations"):
        assert rep["counters"][key] == jax_report["counters"][key], key
    assert rep["queue"]["stale_window_max"] == jax_report["queue"]["stale_window_max"] == K + 1
    assert rep["max_staleness"] == jax_report["max_staleness"] == K
    assert rep["counters"]["max_lag"] == K


def test_k0_through_the_stale_path_equals_a_step_loop():
    noises = [np.random.default_rng(i).normal(size=(POP // 2, DIM)).astype(np.float32)
              for i in range(12)]
    wf, _ = _port_openes(noises)
    stepped = wf.init(1)
    for _ in range(6):
        stepped = wf.step(stepped)
    ex = GenerationExecutor()
    piped = ex.run_host(wf, wf.init(1), 6, max_staleness=0)
    assert torch.equal(piped.algo.center, stepped.algo.center)
    assert piped.algo.noise_seed == stepped.algo.noise_seed
    assert ex.counters["stale_tells"] == 0 and ex.queue_stats["stale_window_max"] == 1


@pytest.mark.parametrize("K", [1, 2])
def test_stale_openes_converges_and_reports(K):
    """JAX's gate: OpenES d 8, pop 64, a host Sphere sleeping 2 ms, 150
    generations at K 1 and 2: f(center) < 0.05, more than 100 stale tells,
    1 <= max_lag <= K; the run report's executor section validates."""
    algo = OpenES(5.0 * np.ones(8, np.float32), 64, learning_rate=0.15, noise_stdev=0.3,
                  device="cpu")
    wf = StdWorkflow(algo, HostSphere(sleep=0.002), monitors=(TelemetryMonitor(capacity=16, device="cpu"),),
                     device="cpu")
    ex = GenerationExecutor(max_staleness=K)
    state = ex.run_host(wf, wf.init(0), 150)
    assert state.generation == 150
    assert float(torch.sum(state.algo.center ** 2)) < 0.05
    rep = run_report(wf, state, executor=ex)
    exr = rep["executor"]
    assert exr["max_staleness"] == K and exr["counters"]["tells"] == 150
    assert exr["counters"]["stale_tells"] > 100
    assert 1 <= exr["counters"]["max_lag"] <= K
    assert rep["telemetry"][0]["generations"] == 150  # the rings saw every generation
    _check_valid(report=rep)


def test_stale_window_runs_evaluations_concurrently():
    """K = 1 with a 30 ms host evaluation keeps two evaluations in flight:
    the wall lands clearly under the serialized sum."""
    algo = OpenES(np.ones(4, np.float32), 16, learning_rate=0.1, noise_stdev=0.3, device="cpu")
    wf = StdWorkflow(algo, HostSphere(sleep=0.03), device="cpu")
    ex = GenerationExecutor(max_staleness=1)
    state = ex.run_host(wf, wf.init(2), 3)  # the probe ask's first-step hold
    t0 = time.perf_counter()
    ex.run_host(wf, state, 10)
    assert time.perf_counter() - t0 < 10 * 0.03 * 0.85
    assert ex.counters["stale_tells"] > 0


def test_stale_refusals():
    def openes_wf(**kw):
        algo = OpenES(np.zeros(4, np.float32), 8, learning_rate=0.1, noise_stdev=0.3, device="cpu")
        return StdWorkflow(algo, HostSphere(), device="cpu", **kw)

    for kw, match in (({"dtype_policy": BF16_STORAGE}, "dtype_policy"),
                      ({"donate_carries": True}, "donate_carries")):
        wf = openes_wf(**kw)
        with pytest.raises(ValueError, match=match):
            GenerationExecutor(max_staleness=1).run_host(wf, wf.init(0), 2)

    class AskSide(Monitor):
        def hooks(self):
            return ("pre_ask",)

    wf = openes_wf(monitors=(AskSide(),))
    with pytest.raises(ValueError, match="ask-side"):
        run_host_pipelined(wf, wf.init(0), 2, max_staleness=1)

    wf = StdWorkflow(PSO(-np.ones(3), np.ones(3), 8, device="cpu"), HostSphere(), device="cpu")
    state = wf.init(0)
    seedless = state.replace(algo=_without_seeds(state.algo))
    with pytest.raises(ValueError, match="seed"):
        GenerationExecutor(max_staleness=1).run_host(wf, seedless, 2)
    with pytest.raises(ValueError, match="max_staleness"):
        GenerationExecutor(max_staleness=-1)
    with pytest.raises(ValueError, match="max_staleness"):
        GenerationExecutor().run_host(wf, state, 2, max_staleness=-1)
    # a device problem has no host loop to make stale
    device_wf = StdWorkflow(PSO(-np.ones(3), np.ones(3), 8, device="cpu"), Sphere(), device="cpu")
    with pytest.raises(ValueError, match="external"):
        GenerationExecutor(max_staleness=1).run_host(device_wf, device_wf.init(0), 2)


def _without_seeds(algo):
    """A PSO state whose seed field is renamed out of the seed pattern."""
    import dataclasses

    fields = {f.name: getattr(algo, f.name) for f in dataclasses.fields(algo)}
    fields.pop("seed")
    cls = dataclasses.make_dataclass("NoSeedState", list(fields), frozen=True)
    cls.replace = dataclasses.replace
    return cls(**fields)


def test_pso_stale_run_keeps_every_tell_matched():
    """A K = 2 run with K + 1 candidate batches in flight, each in its own
    pinned block, scores each tell on its own candidates: every tell's
    fitness equals the Sphere of the candidates its ask wrote."""
    seen = []

    class Checking(HostSphere):
        def evaluate(self, state, pop):
            time.sleep(0.002)
            return super().evaluate(state, pop)

    wf = StdWorkflow(PSO(-5 * np.ones(3), 5 * np.ones(3), 8, device="cpu"), Checking(),
                     device="cpu")
    tell = wf.pipeline_tell

    def checking_tell(state, ctx, fitness, pstate):
        cand = ctx[2]
        np.testing.assert_array_equal(np.asarray(fitness),
                                      np.sum(cand.numpy() ** 2, axis=1).astype(np.float32))
        seen.append(cand.clone())
        return tell(state, ctx, fitness, pstate)

    wf.pipeline_tell = checking_tell
    ex = GenerationExecutor(max_staleness=2)
    state = ex.run_host(wf, wf.init(4), 12)
    assert state.generation == 12 and len(seen) == 12
    assert ex.counters["stale_tells"] > 0


def test_stale_stress_more_workers_than_cores():
    """K = 11 (twelve evaluation threads, more than the cores here) with a
    thread switch every microsecond: every tell is still scored on its own
    ask's candidates, and the executor's shared accounting (spans and
    evaluation seconds, updated from the worker threads under its lock)
    loses no evaluation."""
    import sys

    K, gens = 11, 36
    wf = StdWorkflow(PSO(-5 * np.ones(3), 5 * np.ones(3), 8, device="cpu"), HostSphere(0.001),
                     device="cpu")
    tell = wf.pipeline_tell
    matched = []

    def checking_tell(state, ctx, fitness, pstate):
        matched.append(bool(np.array_equal(
            np.asarray(fitness), np.sum(ctx[2].numpy() ** 2, axis=1).astype(np.float32))))
        return tell(state, ctx, fitness, pstate)

    wf.pipeline_tell = checking_tell
    ex = GenerationExecutor(max_staleness=K)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        state = ex.run_host(wf, wf.init(5), gens)
        assert time.perf_counter() - t0 < 30.0
    finally:
        sys.setswitchinterval(interval)
    assert state.generation == gens and len(matched) == gens and all(matched)
    evals = [s for s in ex.trace_spans() if s["track"] == "host_eval"]
    assert len(evals) == gens and ex.overlap["host_eval_s"] >= gens * 0.001
    assert ex.queue_stats["stale_window_max"] == K + 1 and ex.counters["max_lag"] == K
