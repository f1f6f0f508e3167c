"""The port's TelemetryMonitor against the JAX package's on the CPU: the
counters, the rings, the fingerprints, the strict-JSON report, ``step``
against ``run``, and the guardrail and surrogate mirrors."""

import json

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
from evox_tpu_torch import StdWorkflow, SurrogateWorkflow, interop
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.instrument import sanitize_json
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.operators.surrogate import GPSurrogate
from evox_tpu_torch.problems.numerical import Sphere

# The counters are exact event counts: equal. The rings hold a min (exact)
# and finite-masked means and stds over at most 7 rows, which XLA and
# PyTorch may add in other orders: 1e-6 relative.
RTOL = 1e-6

COUNTERS = ("generations", "evals", "nan_candidates", "inf_candidates", "nan_fitness",
            "inf_fitness", "best_generation", "stagnation", "restarts", "last_trigger",
            "sur_true_evals", "sur_fallback_gens")


def _batches(m, seed=0):
    """Six (candidates, fitness) batches of 7 rows with NaN and ±Inf in both,
    a generation that does not improve, and one with no finite fitness."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(6):
        cand = rng.normal(size=(7, 3)).astype(np.float32)
        fit = rng.uniform(1, 5, size=(7,) if m == 1 else (7, m)).astype(np.float32) / (g + 1)
        if g == 1:
            cand[2, 1], cand[4, 0] = np.nan, np.inf
            fit[3] = np.nan
            fit[5] = -np.inf if m == 1 else np.inf
        if g == 3:
            fit = fit + 100.0  # no improvement
        if g == 4:
            fit[:] = np.nan
        out.append((cand, fit))
    return out


def _run_both(m, direction):
    jmon = JaxTelemetryMonitor(capacity=4, num_objectives=m)
    tmon = TelemetryMonitor(capacity=4, num_objectives=m, device="cpu")
    jdir = np.full((m,), direction, np.float32)
    jmon.set_opt_direction(jdir)
    tmon.set_opt_direction(torch.as_tensor(jdir))
    js, ts = jmon.init(), tmon.init()
    post_eval = jax.jit(jmon.post_eval)
    for cand, fit in _batches(m):
        js = post_eval(js, cand, fit)
        ts = tmon.post_eval(ts, torch.as_tensor(cand), torch.as_tensor(fit))
    return jmon, tmon, jax.tree.map(np.asarray, js), ts


@pytest.mark.parametrize("m,direction", [(1, 1.0), (1, -1.0), (2, 1.0)],
                         ids=["min", "max", "two_objectives"])
def test_post_eval_matches_jax(m, direction):
    jmon, tmon, js, ts = _run_both(m, direction)
    for name in COUNTERS:
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    for name in ("best_key", "ring_best", "ring_mean", "ring_diversity"):
        got, want = getattr(ts, name).numpy(), getattr(js, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert tmon.get_trajectory(ts)["generation"] == jmon.get_trajectory(js)["generation"] == [3, 4, 5, 6]
    np.testing.assert_allclose(np.asarray(tmon.get_trajectory(ts)["best"]),
                               np.asarray(jmon.get_trajectory(js)["best"]), rtol=RTOL)
    assert tmon.counter_tracks(ts).keys() == jmon.counter_tracks(js).keys()
    # the integer surface's digest is the JAX package's; the full
    # fingerprint too, on a state carried across from JAX (same bytes)
    assert tmon.fingerprint(ts, stable=True) == jmon.fingerprint(js, stable=True)
    carried = interop.telemetry_state(tmon, js)
    assert tmon.fingerprint(carried) == jmon.fingerprint(js)
    assert len(tmon.fingerprint(ts)) == 64 and len(tmon.fingerprint(ts, stable=True)) == 48


def test_report_is_strict_json_and_matches_jax():
    jmon, tmon, js, ts = _run_both(1, 1.0)
    report = tmon.report(interop.telemetry_state(tmon, js))
    assert report == jmon.report(js)
    json.dumps(tmon.report(ts), allow_nan=False)  # raises on a bare NaN or Infinity
    fresh = tmon.report(tmon.init())
    assert fresh["best_fitness"] is None and fresh["trajectory"]["best"] == []
    assert sanitize_json({"a": [float("nan"), 1.0, (float("-inf"),)]}) == {"a": [None, 1.0, [None]]}


def _pso(pop=16, dim=4):
    return PSO(-5.0 * np.ones(dim, np.float32), 5.0 * np.ones(dim, np.float32), pop, device="cpu")


def test_step_loop_equals_run_and_tracks_the_best():
    mon = TelemetryMonitor(capacity=8, device="cpu")
    wf = StdWorkflow(_pso(), Sphere(), monitors=(mon,), device="cpu")
    state = wf.init(4)
    looped = state
    for _ in range(6):
        looped = wf.step(looped)
    ran = wf.run(state, 6)
    assert mon.fingerprint(looped.monitors[0]) == mon.fingerprint(ran.monitors[0])
    ms = ran.monitors[0]
    assert int(ms.generations) == 6 and int(ms.evals) == 6 * 16
    assert float(mon.get_best_fitness(ms)) == float(ran.algo.gbest_fitness)
    # a plain workflow's surrogate mirror stays zero
    assert int(ms.sur_true_evals) == 0 and int(ms.sur_fallback_gens) == 0


def test_mirrors_of_a_guarded_algorithm_and_a_screening_workflow():
    mon = TelemetryMonitor(capacity=4, device="cpu")

    class Guarded:
        restarts, last_trigger = 3, 5

    class WfState:
        algo = Guarded()
        sur = None

    ms = mon.post_step(mon.init(), WfState())
    assert (int(ms.restarts), int(ms.last_trigger)) == (3, 5)
    wf = SurrogateWorkflow(_pso(), Sphere(), surrogate=GPSurrogate(device="cpu"), screen_frac=0.25,
                           warmup=16, monitors=(mon,), device="cpu")
    state = wf.run(wf.init(2), 5)
    ms = state.monitors[0]
    assert int(ms.sur_true_evals) == int(state.sur.true_evals) == 16 + 4 * 4
    assert int(ms.sur_fallback_gens) == int(state.sur.fallback_gens)
    # the batch counter counts rows, the inert ones included
    assert int(ms.evals) == 5 * 16
    assert mon.report(ms)["sur_true_evals"] == 32


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TelemetryMonitor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TelemetryMonitor()


@pytest.mark.parametrize("m", [1, 3], ids=["one_objective", "three_objectives"])
def test_member_ring_under_member_call_equals_its_solo_run(m):
    """Every sum over the population is a fixed-order ``halving_sum``: a
    member's rings under ``member_call`` (``torch.func.vmap``) equal the
    same monitor stepped alone on that member's rows, bit for bit, at
    path 36's widths (pop 256, d 64) with NaN and Inf among the rows."""
    from evox_tpu_torch.core.members import member_call, stack_states, take_state

    n, pop, dim = 4, 256, 64
    tmon = TelemetryMonitor(capacity=4, num_objectives=m, device="cpu")
    rng = np.random.default_rng(11)
    solo = [tmon.init() for _ in range(n)]
    fleet = stack_states(solo)
    for g in range(5):
        cand = (rng.standard_normal((n, pop, dim)) * 10.0 ** rng.uniform(-3, 3, (n, 1, dim))
                ).astype(np.float32)
        fit = (rng.standard_normal((n, pop) if m == 1 else (n, pop, m)) * 1e3).astype(np.float32)
        if g == 2:
            cand[1, 7, 3], cand[2, 9, 0] = np.nan, np.inf
            fit[1, 5] = np.nan
        cand_t, fit_t = torch.as_tensor(cand), torch.as_tensor(fit)
        fleet = member_call(tmon.post_eval, fleet, cand_t, fit_t)
        solo = [tmon.post_eval(s, cand_t[i], fit_t[i]) for i, s in enumerate(solo)]
    for i, s in enumerate(solo):
        member = take_state(fleet, i)
        for name in ("ring_best", "ring_mean", "ring_diversity", "best_key"):
            assert torch.equal(getattr(member, name), getattr(s, name)), (i, name)
        assert tmon.fingerprint(member) == tmon.fingerprint(s)
