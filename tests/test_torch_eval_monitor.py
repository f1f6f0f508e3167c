"""EvalMonitor and the ring primitives of the port against the JAX package,
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.monitors import EvalMonitor as JaxEvalMonitor
from evox_tpu.utils import ring as jring
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.pso import CSO
from evox_tpu_torch.kernels import topk as kt
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.utils import ring


def _bits(a):
    """float32 arrays as their bit patterns (the sign of zero and NaN
    payloads count), other dtypes as they are."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_ring_primitives_match_jax():
    buf = np.arange(12, dtype=np.float32).reshape(4, 3)
    row = np.array([-1.0, -2.0, -3.0], np.float32)
    for count in (0, 3, 6, 9):
        want = np.asarray(jring.ring_write(jnp.asarray(buf), jnp.asarray(row), count))
        for c in (count, torch.tensor(count, dtype=torch.int32)):
            got = ring.ring_write(torch.from_numpy(buf), torch.from_numpy(row), c)
            np.testing.assert_array_equal(got.numpy(), want)
        for cond in (True, False):
            want = np.asarray(jring.ring_write(jnp.asarray(buf), jnp.asarray(row), count,
                                               jnp.asarray(cond)))
            got = ring.ring_write(torch.from_numpy(buf), torch.from_numpy(row), count,
                                  torch.tensor(cond))
            np.testing.assert_array_equal(got.numpy(), want)
    src = torch.from_numpy(buf)
    ring.ring_write(src, torch.from_numpy(row), 1)
    np.testing.assert_array_equal(src.numpy(), buf)  # functional: the input is unchanged
    # a scalar row into an int32 length ring
    lens = np.zeros(3, np.int32)
    np.testing.assert_array_equal(ring.ring_write(torch.from_numpy(lens), 7, 4).numpy(),
                                  np.asarray(jring.ring_write(jnp.asarray(lens), 7, 4)))
    mask = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    for count in (0, 5, 11):
        jidx, jcount = jring.ring_scatter_indices(count, jnp.asarray(mask), 6)
        idx, new_count = ring.ring_scatter_indices(count, torch.from_numpy(mask), 6)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert int(new_count) == int(jcount)
    for count in (0, 2, 5, 6, 13):
        assert ring.ring_slots(count, 5) == jring.ring_slots(count, 5)
        assert ring.ring_slots(torch.tensor(count), 5) == jring.ring_slots(count, 5)


def _hard_batches(n_batches, n, seed):
    """Fitness batches with ties, ±0.0, ±inf and NaN (both signs), and
    candidates that name their batch and row, so the kept indices show."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        fit = np.round(rng.normal(size=n) * 3).astype(np.float32)  # many ties
        fit[rng.integers(0, n, 3)] = 0.0
        fit[rng.integers(0, n, 2)] = -0.0
        fit[rng.integers(0, n, 2)] = np.inf
        fit[rng.integers(0, n, 2)] = -np.inf
        nan = np.array([np.nan, -np.nan], np.float32)
        fit[rng.integers(0, n, 2)] = nan
        if b == 1:
            fit[:] = 1.0  # all equal
        cand = np.stack([np.full(n, b), np.arange(n)], axis=1).astype(np.float32)
        out.append((cand, fit))
    return out


def _jax_monitor(direction, **kwargs):
    mon = JaxEvalMonitor(**kwargs)
    mon.set_opt_direction(jnp.asarray(direction, jnp.float32))
    return mon


def _port_monitor(direction, **kwargs):
    mon = EvalMonitor(device="cpu", **kwargs)
    mon.set_opt_direction(torch.tensor(direction, dtype=torch.float32))
    return mon


@pytest.mark.parametrize("direction", [1.0, -1.0], ids=["min", "max"])
@pytest.mark.parametrize("topk", [1, 3])
def test_elite_matches_jax(topk, direction):
    jmon, tmon = _jax_monitor([direction], topk=topk), _port_monitor([direction], topk=topk)
    js, ts = jmon.init(), tmon.init(0)
    for n, seed in ((20, 0), (9, 1), (9, 2), (9, 3)):  # a full batch, then halves
        for cand, fit in _hard_batches(2, n, seed):
            js = jmon.post_eval(js, jnp.asarray(cand), jnp.asarray(fit))
            ts = tmon.post_eval(ts, torch.from_numpy(cand), torch.from_numpy(fit))
            np.testing.assert_array_equal(_bits(ts.topk_fitness.numpy()), _bits(js.topk_fitness))
            np.testing.assert_array_equal(ts.topk_solution.numpy(), np.asarray(js.topk_solution))
    assert ts.pf_count is None
    np.testing.assert_array_equal(_bits(tmon.get_best_fitness(ts).numpy()),
                                  _bits(jmon.get_best_fitness(js)))
    np.testing.assert_array_equal(tmon.get_best_solution(ts).numpy(),
                                  np.asarray(jmon.get_best_solution(js)))
    np.testing.assert_array_equal(tmon.get_topk_solutions(ts).numpy(),
                                  np.asarray(jmon.get_topk_solutions(js)))


def test_elite_runs_on_partial_topk(monkeypatch):
    """The elite's selection is partial_topk (the CUDA kernel on the card),
    called once a post_eval on the merged key."""
    calls = []
    real = kt.partial_topk

    def spy(values, k, device=None):
        calls.append((values.shape[0], k))
        return real(values, k, device=device)

    monkeypatch.setattr("evox_tpu_torch.monitors.eval_monitor.partial_topk", spy)
    mon = _port_monitor([1.0], topk=4)
    s = mon.init()
    for n in (10, 5, 5):
        s = mon.post_eval(s, torch.zeros(n, 2), torch.rand(n))
    assert calls == [(10, 4), (9, 4), (9, 4)]


def _mo_batches():
    """Two-objective batches: a front of 3 (smaller than the capacity 6), a
    front of 12 (larger), a batch with inf coordinates, duplicates and a
    row of all +inf, and a dominated batch."""
    t = np.linspace(0.0, 1.0, 12, dtype=np.float32)
    front12 = np.stack([t, 1.0 - t], axis=1)
    small = np.array([[0.2, 0.9], [0.5, 0.5], [0.9, 0.2], [1.0, 1.0], [0.6, 0.6]], np.float32)
    inf_rows = np.array([[0.0, np.inf], [np.inf, 0.0], [np.inf, np.inf], [0.3, 0.3], [0.3, 0.3],
                         [0.1, 0.95], [-np.inf, 5.0]], np.float32)
    dominated = front12 + 2.0
    out = []
    for b, fit in enumerate((small, front12, inf_rows, dominated)):
        cand = np.stack([np.full(len(fit), b), np.arange(len(fit))], axis=1).astype(np.float32)
        out.append((cand, fit))
    return out


@pytest.mark.parametrize("direction", [[1.0, 1.0], [1.0, -1.0]], ids=["min", "min_max"])
def test_pareto_archive_matches_jax(direction):
    cap = 6
    jmon = _jax_monitor(direction, multi_obj=True, pf_capacity=cap)
    tmon = _port_monitor(direction, multi_obj=True, pf_capacity=cap)
    js, ts = jmon.init(), tmon.init()
    d = np.asarray(direction, np.float32)
    for cand, fit in _mo_batches():
        fit = fit * d
        js = jmon.post_eval(js, jnp.asarray(cand), jnp.asarray(fit))
        ts = tmon.post_eval(ts, torch.from_numpy(cand), torch.from_numpy(fit))
        np.testing.assert_array_equal(_bits(ts.topk_fitness.numpy()), _bits(js.topk_fitness))
        np.testing.assert_array_equal(ts.topk_solution.numpy(), np.asarray(js.topk_solution))
        assert int(ts.pf_count) == int(js.pf_count)
        np.testing.assert_array_equal(tmon.get_pf_mask(ts).numpy(), np.asarray(jmon.get_pf_mask(js)))
        np.testing.assert_array_equal(tmon.get_pf_fitness(ts).numpy(),
                                      np.asarray(jmon.get_pf_fitness(js)))
        np.testing.assert_array_equal(tmon.get_pf_solutions(ts).numpy(),
                                      np.asarray(jmon.get_pf_solutions(js)))
    counts = []
    js2, ts2 = jmon.init(), tmon.init()
    for cand, fit in _mo_batches()[:2]:
        ts2 = tmon.post_eval(ts2, torch.from_numpy(cand), torch.from_numpy(fit * d))
        counts.append(int(ts2.pf_count))
    assert counts == [3, cap]  # a front smaller, then one larger than the capacity


def test_histories_and_getters_match_jax():
    """The device ring over CSO's full-then-half batches (more generations
    than slots), with solutions, and the host histories."""
    K = 3
    jmon = _jax_monitor([1.0], topk=2, history_capacity=K, history_solutions=True,
                        full_fit_history=True, full_sol_history=True)
    tmon = _port_monitor([1.0], topk=2, history_capacity=K, history_solutions=True,
                         full_fit_history=True, full_sol_history=True)
    js, ts = jmon.init(), tmon.init()
    rng = np.random.default_rng(3)
    batches = []
    for n in (8, 4, 4, 4, 4):
        fit = rng.normal(size=n).astype(np.float32)
        cand = rng.normal(size=(n, 2)).astype(np.float32)
        batches.append((cand, fit))
        js = jmon.post_eval(js, jnp.asarray(cand), jnp.asarray(fit))
        ts = tmon.post_eval(ts, torch.from_numpy(cand), torch.from_numpy(fit))
    np.testing.assert_array_equal(ts.hist_fit.numpy(), np.asarray(js.hist_fit))
    np.testing.assert_array_equal(ts.hist_sol.numpy(), np.asarray(js.hist_sol))
    np.testing.assert_array_equal(ts.hist_len.numpy(), np.asarray(js.hist_len))
    assert ts.hist_count == int(js.hist_count) == 5
    for got, want in zip(tmon.get_device_fitness_history(ts), jmon.get_device_fitness_history(js),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tmon.get_device_solution_history(ts),
                         jmon.get_device_solution_history(js), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [len(h) for h in tmon.get_device_fitness_history(ts)] == [4, 4, 4]
    for got, want, (cand, fit) in zip(tmon.get_fitness_history(), jmon.get_fitness_history(),
                                      batches, strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), fit)
    for got, (cand, _) in zip(tmon.get_solution_history(), batches, strict=True):
        np.testing.assert_array_equal(got.numpy(), cand)
    np.testing.assert_array_equal(tmon.get_topk_fitness(ts).numpy(),
                                  np.asarray(jmon.get_topk_fitness(js)))
    assert tmon.get_device_fitness_history(tmon.init()) == []
    with pytest.raises(ValueError, match="sized by the first generation"):
        tmon.post_eval(ts, torch.zeros(9, 2), torch.zeros(9))
    with pytest.raises(ValueError, match="history_solutions requires"):
        EvalMonitor(history_solutions=True, device="cpu")


def test_eval_monitor_state_crosses_through_interop():
    jmon = _jax_monitor([1.0], topk=2, history_capacity=2)
    js = jmon.init()
    for n in (6, 3):
        js = jmon.post_eval(js, jnp.arange(2 * n, dtype=jnp.float32).reshape(n, 2),
                            jnp.linspace(1.0, 0.0, n))
    tmon = _port_monitor([1.0], topk=2, history_capacity=2)
    ts = interop.eval_monitor_state(tmon, jax.tree.map(np.asarray, js))
    np.testing.assert_array_equal(ts.topk_fitness.numpy(), np.asarray(js.topk_fitness))
    np.testing.assert_array_equal(ts.topk_solution.numpy(), np.asarray(js.topk_solution))
    np.testing.assert_array_equal(ts.hist_fit.numpy(), np.asarray(js.hist_fit))
    assert ts.hist_count == 2 and ts.pf_count is None
    ts = tmon.post_eval(ts, torch.zeros(3, 2), torch.full((3,), -1.0))  # and it steps on
    assert float(tmon.get_best_fitness(ts)) == -1.0


def test_monitor_rejects_fitness_on_another_device():
    mon = EvalMonitor(device="cpu")
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="fitness lies on meta"):
        mon.post_eval(mon.init(), meta, meta)


def test_monitored_cso_workflow_records_half_batches():
    mon = EvalMonitor(topk=3, history_capacity=4, device="cpu")
    wf = StdWorkflow(CSO(-np.ones(3), np.ones(3), 8, device="cpu"), Sphere(), monitors=[mon],
                     device="cpu")
    state = wf.run(wf.init(1), 6)
    widths = [len(h) for h in mon.get_device_fitness_history(state.monitors[0])]
    assert widths == [4, 4, 4, 4]
    topk = mon.get_topk_fitness(state.monitors[0])
    assert topk.shape == (3,) and bool((topk[:-1] <= topk[1:]).all())
