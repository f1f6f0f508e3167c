"""The port's PopMonitor, StepTimerMonitor, ``profiler.trace`` and
``masked_igd`` on the CPU.

PopMonitor's history is held to the run's own states, generation by
generation, bit for bit; StepTimerMonitor gives one time a generation with
the JAX package's summary keys; ``masked_igd`` is held against JAX's to
1e-6 (a pairwise-distance matrix through one product, summed in another
order), empty masks included."""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.metrics.igd import masked_igd as jax_masked_igd
from evox_tpu.monitors import StepTimerMonitor as JaxStepTimerMonitor
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.instrument import instrument, run_report
from evox_tpu_torch.metrics import masked_igd
from evox_tpu_torch.monitors import PopMonitor, StepTimerMonitor, profiler_trace
from evox_tpu_torch.problems.numerical import ZDT1, Sphere

DIM, POP = 4, 32


def _wf(monitors):
    return StdWorkflow(PSO(-10 * torch.ones(DIM), 10 * torch.ones(DIM), pop_size=POP,
                           device="cpu"), Sphere(), monitors=monitors, device="cpu")


def test_pop_monitor_history_is_the_runs_own_states():
    mon = PopMonitor(fitness_name="pbest_fitness")
    wf = _wf((mon,))
    state, seen = wf.init(2), []
    state = wf.run(state, 3)  # through run's loop
    for _ in range(4):
        state = wf.step(state)
        seen.append((state.algo.population.clone(), state.algo.pbest_fitness.clone()))
    pops, fits = mon.get_population_history(), mon.get_fitness_history()
    assert len(pops) == len(fits) == 7
    assert fits[0].shape == (POP,) and pops[0].shape == (POP, DIM)
    for (pop, fit), got_pop, got_fit in zip(seen, pops[3:], fits[3:]):
        np.testing.assert_array_equal(got_pop, pop.numpy())
        np.testing.assert_array_equal(got_fit, fit.numpy())
    assert not np.array_equal(pops[0], pops[-1])  # the swarm moves
    np.testing.assert_array_equal(mon.get_latest_fitness(), fits[-1])
    np.testing.assert_array_equal(mon.get_latest_population(), pops[-1])


def test_pop_monitor_fitness_only_multi_objective():
    mon = PopMonitor(fitness_only=True)
    wf = StdWorkflow(NSGA2(torch.zeros(6), torch.ones(6), n_objs=2, pop_size=16, device="cpu"),
                     ZDT1(n_dim=6, device="cpu"), monitors=(mon,), device="cpu")
    state = wf.run(wf.init(6), 5)
    fits = mon.get_fitness_history()
    assert len(fits) == 5 and mon.get_population_history() == []
    np.testing.assert_array_equal(fits[-1], state.algo.fitness.numpy())
    fig = mon.plot()  # two objectives: a matplotlib scatter of the last generation
    assert fig is not None and len(fig.axes) == 1
    np.testing.assert_array_equal(fig.axes[0].collections[-1].get_offsets(), fits[-1])


def test_analysis_records_nothing():
    """The cost analysis runs a generation again; neither monitor sees it."""
    pop_mon, timer = PopMonitor(fitness_name="pbest_fitness"), StepTimerMonitor(device="cpu")
    wf = _wf((pop_mon, timer))
    rec = instrument(wf, analyze=True)
    state = wf.run(wf.init(0), 4)
    report = run_report(wf, state, recorder=rec)
    assert set(report["roofline"]["entries"]) == {"step", "run"}
    assert len(pop_mon.get_fitness_history()) == 4
    assert timer.get_step_times().shape == (4,)


def test_step_timer_one_time_a_generation_with_jax_keys():
    timer = StepTimerMonitor(device="cpu")
    wf = _wf((timer,))
    state = wf.run(wf.init(13), 4)
    times = timer.get_step_times()
    assert times.shape == (4,) and (times > 0).all()
    wf.step(state)
    assert timer.get_step_times().shape == (5,)
    # the JAX package's monitor on the same workflow shape: the same keys
    from evox_tpu import StdWorkflow as JaxStdWorkflow
    from evox_tpu.algorithms.so.pso import PSO as JaxPSO
    from evox_tpu.problems.numerical import Sphere as JaxSphere

    jtimer = JaxStepTimerMonitor()
    jwf = JaxStdWorkflow(JaxPSO(-10 * jnp.ones(DIM), 10 * jnp.ones(DIM), pop_size=POP),
                         JaxSphere(), monitors=(jtimer,))
    jwf.run(jwf.init(jax.random.PRNGKey(13)), 4)
    assert jtimer.get_step_times().shape == (4,)
    assert set(timer.summary()) == set(jtimer.summary())
    assert StepTimerMonitor(device="cpu").summary() == {"steps": 0}


def test_trace_writes_a_chrome_trace(tmp_path):
    wf = _wf(())
    with profiler_trace(str(tmp_path)) as prof:
        wf.run(wf.init(0), 2)
    assert prof is not None
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(ValueError, match="network"):
        with profiler_trace(str(tmp_path), create_perfetto_link=True):
            pass


def _masked_cases():
    rng = np.random.default_rng(4)
    objs = rng.random((24, 3)).astype(np.float32)
    pf = rng.random((17, 3)).astype(np.float32)
    full_o, full_p = np.ones(24, bool), np.ones(17, bool)
    some_o, some_p = rng.random(24) < 0.5, rng.random(17) < 0.6
    none_o, none_p = np.zeros(24, bool), np.zeros(17, bool)
    return objs, pf, [(full_o, full_p), (some_o, some_p), (none_o, some_p), (some_o, none_p),
                      (none_o, none_p)]


@pytest.mark.parametrize("case", range(5), ids=["full", "masked", "no_objs", "no_pf", "neither"])
def test_masked_igd_matches_jax(case):
    objs, pf, masks = _masked_cases()
    om, pm = masks[case]
    want = float(jax_masked_igd(jnp.asarray(objs), jnp.asarray(om), jnp.asarray(pf),
                                jnp.asarray(pm)))
    got = float(masked_igd(torch.from_numpy(objs), torch.from_numpy(om), torch.from_numpy(pf),
                           torch.from_numpy(pm)))
    assert abs(got - want) <= 1e-6
    if case >= 2:
        assert got == 0.0
