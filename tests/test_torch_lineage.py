"""``monitors/lineage.py`` in the port against the JAX package's
``LineageMonitor`` on the CPU: both monitors are driven hook by hook with
the same inputs — DE's exact attribution from a live JAX DE run, the
selection-boundary fallback, a guardrail's restarts, and multi-objective
batches with ties and infinite rows — and their rings, ledgers,
trajectories and ancestry compared; then the port's monitor on its own
workflows (attached or not, every other state is the same bit for bit;
the ``search`` section validates)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.de import DE as JaxDE
from evox_tpu.core.attribution import Attribution as JaxAttribution
from evox_tpu.monitors import LineageMonitor as JaxLineageMonitor
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so.de import DE
from evox_tpu_torch.core.attribution import Attribution
from evox_tpu_torch.core.instrument import run_report
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.monitors import LineageMonitor
from evox_tpu_torch.problems.numerical import DTLZ2, Sphere

from tests.test_torch_instrument import _check_valid

DIM, POP, GENS = 5, 16, 12
LB, UB = -5.0 * np.ones(DIM, np.float32), 5.0 * np.ones(DIM, np.float32)
# the churn is a mean of Euclidean distances over the front, and the
# ledger's improvement mass a sum over the slots: the two libraries add in
# other orders (float32, an ulp or so a step)
CHURN_RTOL = 1e-5
SUM_FIELDS = {"ring_churn", "ledger_improvement"}
# with several objectives the slot key is the mean objective, a sum of m
# values divided by m, which the two libraries round apart by an ulp
MEAN_KEY_FIELDS = {"prev_fit", "ring_best_fit", "ring_delta", "best_key"}
RINGS = ("ring_parent", "ring_op", "ring_best_slot", "ring_best_fit", "ring_delta",
         "ring_epoch", "age", "improvements", "prev_fit", "ledger_attempts", "ledger_success",
         "ledger_improvement", "best_key", "restarts_seen")


def _ns(**fields):
    return types.SimpleNamespace(**fields)


def _assert_monitor_states(tm, jm, extra=(), mean_key=False):
    assert tm.count == int(jm.count)
    assert tm.epoch_extra == int(jm.epoch_extra)
    for name in RINGS + tuple(extra):
        got, want = getattr(tm, name), getattr(jm, name)
        if want is None:
            assert got is None, name
            continue
        if name in SUM_FIELDS or (mean_key and name in MEAN_KEY_FIELDS):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CHURN_RTOL, atol=1e-7)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def _assert_reports(tmon, tm, jmon, jm, mean_key=False):
    assert tmon.best_ancestry(tm) == jmon.best_ancestry(jm)
    tl, jl = tmon.ledger(tm), jmon.ledger(jm)
    assert tl.keys() == jl.keys()
    for op in tl:
        assert tl[op]["attempts"] == jl[op]["attempts"] and tl[op]["successes"] == jl[op]["successes"]
        assert tl[op]["improvement"] == pytest.approx(jl[op]["improvement"], rel=CHURN_RTOL)
    tt, jt = tmon.get_trajectory(tm), jmon.get_trajectory(jm)
    assert tt.keys() == jt.keys()
    for key in tt:
        rtol = CHURN_RTOL if key == "churn" or (mean_key and key in ("best_fitness", "delta")) \
            else 0
        np.testing.assert_allclose(np.asarray(tt[key], float), np.asarray(jt[key], float),
                                   rtol=rtol, err_msg=key)
    ts, js = tmon.search_report(tm), jmon.search_report(jm)
    for key in ("generations", "capacity", "width", "num_objectives", "epoch", "restarts",
                "age", "ancestry"):
        assert ts[key] == js[key], key


@pytest.fixture(scope="module")
def jax_de_generations():
    """A live JAX DE run on Sphere (its ask and tell compiled, as a
    workflow runs them): each generation's candidates' fitness and the
    algorithm's attribution, as numpy."""
    jalgo = JaxDE(LB, UB, pop_size=POP)
    state = jalgo.init(jax.random.PRNGKey(3))
    cand, state = jalgo.init_ask(state)
    state = jalgo.init_tell(state, jnp.sum(cand**2, axis=1))
    ask, tell = jax.jit(jalgo.ask), jax.jit(jalgo.tell)
    out = []
    for _ in range(GENS):
        cand, state = ask(state)
        fit = jnp.sum(cand**2, axis=1)
        state = tell(state, fit)
        out.append((np.asarray(fit), {k: np.asarray(getattr(state.attrib, k)) for k in
                                      ("parent_idx", "op_tag", "success", "improvement")}))
    return out


@pytest.mark.parametrize("direction", [1.0, -1.0], ids=["min", "max"])
def test_de_attribution_rings_equal_jax(jax_de_generations, direction):
    """DE's exact attribution (slot descent, DE/rand/1 tags, greedy
    success): every ring and ledger equals the JAX monitor's, with a
    ring of 8 that wraps, a guardrail restart mirrored from generation 7
    and a manual epoch bump at 10 (ancestry stops at the boundary)."""
    tmon = LineageMonitor(8, device="cpu")
    jmon = JaxLineageMonitor(8)
    tmon.set_opt_direction(torch.tensor([direction]))
    jmon.set_opt_direction(jnp.asarray([direction]))
    tm, jm = tmon.init(), jmon.init()
    for g, (fit, attrib) in enumerate(jax_de_generations):
        user = fit * direction  # the monitors see the user's convention
        restarts = 1 if g >= 7 else 0
        tm = tmon.post_eval(tm, None, torch.from_numpy(user))
        jm = jmon.post_eval(jm, None, jnp.asarray(user))
        talgo = _ns(attrib=Attribution(**{k: torch.from_numpy(v.copy()) for k, v in attrib.items()}),
                    restarts=torch.tensor(restarts, dtype=torch.int32))
        jalgo = _ns(attrib=JaxAttribution(**{k: jnp.asarray(v) for k, v in attrib.items()}),
                    restarts=jnp.int32(restarts))
        tm = tmon.post_step(tm, _ns(algo=talgo))
        jm = jmon.post_step(jm, _ns(algo=jalgo))
        if g == 9:
            tm, jm = tmon.bump_epoch(tm), jmon.bump_epoch(jm)
        _assert_monitor_states(tm, jm)
    _assert_reports(tmon, tm, jmon, jm)
    assert tmon.counter_tracks(tm).keys() == jmon.counter_tracks(jm).keys()
    assert tmon.ledger(tm)["de_rand_1"]["attempts"] == POP * GENS


def test_fallback_tagging_and_width_folding_equal_jax():
    """No attribution: parent = slot, tag ``init`` then ``velocity``,
    success = the slot improved; a batch three times the width folds by
    slot (CoDE's layout) and a narrower one pads with inf."""
    rng = np.random.default_rng(1)
    tmon = LineageMonitor(4, default_op="velocity", device="cpu")
    jmon = JaxLineageMonitor(4, default_op="velocity")
    tm, jm = tmon.init(), jmon.init()
    for g, n in enumerate((10, 10, 30, 10, 7, 10)):
        fit = rng.normal(size=n).astype(np.float32)
        fit[rng.random(n) < 0.2] = np.inf
        tm = tmon.post_eval(tm, None, torch.from_numpy(fit))
        jm = jmon.post_eval(jm, None, jnp.asarray(fit))
        tm = tmon.post_step(tm, _ns(algo=None))
        jm = jmon.post_step(jm, _ns(algo=None))
        _assert_monitor_states(tm, jm)
    _assert_reports(tmon, tm, jmon, jm)
    with pytest.raises(ValueError, match="cannot fold"):
        tmon.post_eval(tm, None, torch.zeros(13))
    with pytest.raises(ValueError, match="num_objectives"):
        tmon.post_eval(tm, None, torch.zeros(10, 2))


def test_mo_front_and_churn_rings_equal_jax():
    """Three objectives, width 40, with duplicated rows and rows holding
    inf: each generation's rank-0 front (one dominance launch on the card)
    and the churn between consecutive fronts equal the JAX monitor's."""
    rng = np.random.default_rng(2)
    tmon = LineageMonitor(4, num_objectives=3, default_op="crossover", device="cpu")
    jmon = JaxLineageMonitor(4, num_objectives=3, default_op="crossover")
    tm, jm = tmon.init(), jmon.init()
    extra = ("ring_front_size", "ring_churn", "cur_front_mask", "prev_front")
    for g in range(6):
        fit = rng.integers(0, 4, size=(40, 3)).astype(np.float32)
        fit[rng.random(40) < 0.1, 1] = np.inf
        tm = tmon.post_eval(tm, None, torch.from_numpy(fit))
        jm = jmon.post_eval(jm, None, jnp.asarray(fit))
        tm = tmon.post_step(tm, _ns(algo=None))
        jm = jmon.post_step(jm, _ns(algo=None))
        _assert_monitor_states(tm, jm, extra, mean_key=True)
    _assert_reports(tmon, tm, jmon, jm, mean_key=True)
    assert all(op["op"] in ("crossover", "init") for op in tmon.best_ancestry(tm))


def _same(a, b):
    for (pa, x), (pb, y) in zip(named_leaves(a), named_leaves(b)):
        assert pa == pb
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, pa


def test_attached_or_not_every_other_state_is_the_same():
    """DE on Sphere, and NSGA-II on DTLZ2: with the monitor attached the
    algorithm states equal the unmonitored twin's bit for bit, ``run``
    equals a ``step`` loop (the fingerprint), and the report's ``search``
    section validates."""
    for make, problem, mon_kw in (
            (lambda: DE(LB, UB, POP, device="cpu"), Sphere(), {}),
            (lambda: NSGA2(np.zeros(7), np.ones(7), 3, 24, device="cpu"), DTLZ2(7, 3, device="cpu"),
             {"num_objectives": 3, "default_op": "crossover"})):
        mon = LineageMonitor(16, device="cpu", **mon_kw)
        watched = StdWorkflow(make(), problem, monitors=(mon,), device="cpu")
        twin = StdWorkflow(make(), problem, device="cpu")
        ran = watched.run(watched.init(7), 10)
        _same(ran.algo, twin.run(twin.init(7), 10).algo)
        stepped = watched.init(7)
        for _ in range(10):
            stepped = watched.step(stepped)
        assert mon.fingerprint(stepped.monitors[0]) == mon.fingerprint(ran.monitors[0])
        report = run_report(watched, ran)
        assert report["search"]["enabled"] is True and report["search"]["generations"] == 10
        _check_valid(report=report)
        chain = mon.best_ancestry(ran.monitors[0])
        assert 1 <= len(chain) <= 10 and len({e["epoch"] for e in chain}) == 1
    assert "search" not in run_report(twin, twin.init(0))
    with pytest.raises(ValueError, match="vocabulary"):
        LineageMonitor(default_op="teleport", device="cpu")
