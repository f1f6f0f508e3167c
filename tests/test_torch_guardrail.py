"""GuardedAlgorithm, recenter_state, IPOPRestarts and ``StdWorkflow.run(
restarts=)`` of the port against the JAX package, on the CPU.

The guarded CMA-ES pairs step the algorithms directly: JAX's normals are
handed to the port's ``_draw``, the decomposition period is longer than the
runs (``B = I``, ``D = 1`` throughout, so no eigendecomposition needs
handing over), and both tells get the same fitness, made with numpy from
the JAX side's candidates. Triggers, restart counts, stagnation counts and
the best-so-far fitness are then compared exactly; CMA-ES's own fields
and the best-so-far point within ``RTOL``/``ATOL``: its weighted sums over
the population are added by XLA and PyTorch in other orders (~1 ulp a sum,
a few generations of compounding, as in ``test_torch_cmaes.py``). The
restart runs a fresh CMA-ES ``init``, which draws nothing, so the
restarted state is comparable too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import cma_es as jcma
from evox_tpu.algorithms.so.pso import CSO as JaxCSO
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.core import guardrail as jg
from evox_tpu_torch import Problem, StdWorkflow, interop
from evox_tpu_torch.algorithms.so.de import DE
from evox_tpu_torch.algorithms.so.es import cma_es as tcma
from evox_tpu_torch.algorithms.so.pso import CSO, PSO
from evox_tpu_torch.core import guardrail as tg
from evox_tpu_torch.problems.numerical import Sphere
from tests._chaos import PlateauSphere

RTOL, ATOL = 1e-5, 1e-6
DIM, POP = 5, 8
NO_DECOMPOSITION = 10**6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(cand):
    return np.sum(np.asarray(cand, np.float32) ** 2, axis=1, dtype=np.float32)


def _cma_pair(pop=POP, **guard):
    center = np.full(DIM, 3.0, np.float32)
    jalgo = jg.GuardedAlgorithm(jcma.CMAES(center, 1.0, pop_size=pop,
                                           decomp_per_iter=NO_DECOMPOSITION), **guard)
    talgo = tg.GuardedAlgorithm(tcma.CMAES(center, 1.0, pop_size=pop,
                                           decomp_per_iter=NO_DECOMPOSITION, device="cpu"),
                                **guard)
    jstate = jalgo.init(jax.random.PRNGKey(4))
    return jalgo, talgo, jstate, interop.guarded_state(talgo, _np(jstate), seed=3)


def _cma_step(jalgo, talgo, jstate, tstate, fitness=_sphere):
    _, k = jax.random.split(jstate.inner.key)
    talgo.algorithm._draw = lambda s, z=_t(jax.random.normal(k, (jalgo.pop_size, DIM))): z
    jcand, jstate = jit_once(jalgo, "ask")(jstate)
    _, tstate = talgo.ask(tstate)
    fit = fitness(jcand)
    return jit_once(jalgo, "tell")(jstate, jnp.asarray(fit)), talgo.tell(tstate, torch.from_numpy(fit))


def _assert_guarded(tstate, jstate):
    for name in ("stagnation", "restarts", "checked_restarts", "last_trigger", "pop_size"):
        assert getattr(tstate, name) == int(getattr(jstate, name)), name
    assert float(tstate.best_fitness) == float(jstate.best_fitness)
    np.testing.assert_allclose(tstate.best_x.numpy(), np.asarray(jstate.best_x), RTOL, ATOL)
    for f in dataclasses.fields(tstate.inner):
        if not hasattr(jstate.inner, f.name):
            continue
        ours, theirs = getattr(tstate.inner, f.name), np.asarray(getattr(jstate.inner, f.name))
        if isinstance(ours, int):
            assert ours == int(theirs), f.name
        else:
            np.testing.assert_allclose(ours.numpy(), theirs, RTOL, ATOL, err_msg=f.name)


def _poison(tstate, jstate, **fields):
    t_inner = tstate.inner.replace(**{k: torch.full_like(getattr(tstate.inner, k), v)
                                      for k, v in fields.items()})
    j_inner = jstate.inner.replace(**{k: jnp.full_like(getattr(jstate.inner, k), v)
                                      for k, v in fields.items()})
    return tstate.replace(inner=t_inner), jstate.replace(inner=j_inner)


# ------------------------------------------------------------- no trigger


@pytest.mark.parametrize("make", [
    lambda: tcma.CMAES(np.full(DIM, 3.0), 1.0, pop_size=16, device="cpu"),
    lambda: PSO(-5 * np.ones(DIM), 5 * np.ones(DIM), 16, device="cpu"),
    lambda: CSO(-5 * np.ones(DIM), 5 * np.ones(DIM), 16, device="cpu"),
], ids=["CMAES", "PSO", "CSO"])
def test_no_trigger_guard_is_the_bare_algorithm_bit_for_bit(make):
    """Guards on (NaN check, the sigma rails, a stagnation limit no healthy
    run reaches) but never triggered: every field of the inner state
    equals the bare algorithm's, bit for bit, over 12 generations (CSO's
    first batch is its whole population, the later ones half)."""
    wf_bare = StdWorkflow(make(), Sphere(), device="cpu")
    wf_guard = StdWorkflow(tg.GuardedAlgorithm(make(), stagnation_limit=10_000), Sphere(),
                           device="cpu")
    sb, sg = wf_bare.init(7), wf_guard.init(7)
    for _ in range(12):
        sb, sg = wf_bare.step(sb), wf_guard.step(sg)
    assert sg.algo.restarts == 0 and sg.algo.last_trigger == 0
    for f in dataclasses.fields(sb.algo):
        ours, theirs = getattr(sg.algo.inner, f.name), getattr(sb.algo, f.name)
        if isinstance(theirs, torch.Tensor):
            assert torch.equal(ours, theirs), f.name
        elif f.name != "pending":
            assert ours == theirs, f.name


# -------------------------------------------------------- restarts, triggers


def test_nan_covariance_restarts_at_the_next_tell_recentered_like_jax():
    """Poison C, B and D with NaN (what a failed eigendecomposition leaves)
    after 5 generations: both packages find the NaN at the next tell,
    restart once with the non-finite bit, the fresh CMA-ES centered on
    best-so-far; then both run on, healthy, for 3 more generations."""
    jalgo, talgo, jstate, tstate = _cma_pair()
    _assert_guarded(tstate, jstate)
    for _ in range(5):
        jstate, tstate = _cma_step(jalgo, talgo, jstate, tstate)
        _assert_guarded(tstate, jstate)
    best_before = tstate.best_x.clone()
    tstate, jstate = _poison(tstate, jstate, C=np.nan, B=np.nan, D=np.nan)
    jstate, tstate = _cma_step(jalgo, talgo, jstate, tstate)
    assert tstate.restarts == 1 and tstate.last_trigger == tg.TRIGGER_NONFINITE
    assert torch.equal(tstate.inner.mean, tstate.best_x)  # re-centered on best-so-far
    assert torch.equal(tstate.best_x, best_before)  # the NaN batch claims nothing
    assert bool(torch.isfinite(tstate.inner.C).all())
    _assert_guarded(tstate, jstate)
    for _ in range(3):
        jstate, tstate = _cma_step(jalgo, talgo, jstate, tstate)
        _assert_guarded(tstate, jstate)
    assert tstate.restarts == 1
    # and back: the port's state, as numpy fields by name, into JAX's
    back = interop.numpy_fields(tstate)
    inner = {k: jnp.asarray(v) for k, v in back["inner"].items()
             if k in {f.name for f in dataclasses.fields(jstate.inner)} and k != "key"}
    carried = jstate.replace(inner=jstate.inner.replace(**inner), **{
        k: jnp.asarray(back[k]) for k in ("best_x", "best_fitness", "stagnation", "restarts",
                                          "checked_restarts", "last_trigger")})
    _assert_guarded(tstate, carried)
    assert isinstance(back["restarts"], int) and back["pop_size"] == POP
    report = talgo.health_report(tstate)
    assert report == jalgo.health_report(jstate)
    poisoned, _ = _poison(tstate, jstate, pc=np.nan)
    poisoned = talgo.tell(poisoned, torch.ones(POP))
    report = talgo.health_report(poisoned)
    assert report["restarts"] == 2 and report["last_trigger_names"] == ["nonfinite_state"]


@pytest.mark.parametrize("case", ["sigma", "inf", "stagnation", "diversity"])
def test_triggers_and_last_trigger_match_jax(case):
    """Each trigger against the JAX package, generation by generation:
    sigma poisoned to 0 (the floor is inclusive); pc poisoned to +inf with
    ``check_inf``; a constant fitness with a stagnation limit of 3 (the
    first tell improves on +inf, then 3 tells do not); a diversity floor
    above any batch's diversity. Trigger bits, restarts and stagnation
    exactly."""
    guard = {"sigma": {}, "inf": {"check_inf": True}, "stagnation": {"stagnation_limit": 3},
             "diversity": {"diversity_floor": 1e9}}[case]
    fitness = (lambda c: np.full(POP, 7.0, np.float32)) if case == "stagnation" else _sphere
    jalgo, talgo, jstate, tstate = _cma_pair(**guard)
    triggers = []
    for gen in range(8):
        if gen == 3 and case == "sigma":
            tstate, jstate = _poison(tstate, jstate, sigma=0.0)
        if gen == 3 and case == "inf":
            tstate, jstate = _poison(tstate, jstate, pc=np.inf)
        jstate, tstate = _cma_step(jalgo, talgo, jstate, tstate, fitness)
        _assert_guarded(tstate, jstate)
        triggers.append(tstate.last_trigger)
    bit = {"sigma": tg.TRIGGER_SIGMA, "inf": tg.TRIGGER_NONFINITE,
           "stagnation": tg.TRIGGER_STAGNATION, "diversity": tg.TRIGGER_DIVERSITY}[case]
    assert bit in triggers
    want = {"sigma": [0, 0, 0, bit, 0, 0, 0, 0], "inf": [0, 0, 0, bit, 0, 0, 0, 0],
            "stagnation": [0, 0, 0, bit, 0, 0, bit, 0], "diversity": [bit] * 8}[case]
    assert triggers == want


def test_diversity_statistic_matches_jax_on_non_finite_batches():
    """The finite-masked mean per-dimension std over a batch with NaN, ±inf
    and a column with no finite entry: a float32 sum over rows, added in
    another order by the two packages, so 1e-6 relative (a few ulps of a
    64-row sum)."""
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(64, 7)).astype(np.float32) * np.float32([1, 10, 0.1, 3, 1, 2, 5])
    batch[3, 1], batch[9, 2], batch[11, 4] = np.nan, np.inf, -np.inf
    batch[:, 6] = np.nan
    want = float(jg.GuardedAlgorithm._diversity(jnp.asarray(batch)))
    got = float(tg.GuardedAlgorithm._diversity(torch.from_numpy(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tree = {"a": batch[:, :3], "b": batch[:, 3:]}
    np.testing.assert_allclose(
        float(tg.GuardedAlgorithm._diversity({k: torch.from_numpy(v) for k, v in tree.items()})),
        float(jg.GuardedAlgorithm._diversity({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=1e-6)


def _cso_draws(jalgo, jinner):
    _, k_pair = jax.random.split(jinner.key)
    k_perm, k1, k2, k3 = jax.random.split(k_pair, 4)
    rs = [jax.random.uniform(k, (jalgo.pop_size // 2, jalgo.dim)) for k in (k1, k2, k3)]
    return tuple(_t(a) for a in (jax.random.permutation(k_perm, jalgo.pop_size), *rs))


def test_cso_wider_first_ask_reads_the_scored_rows_like_jax():
    """CSO scores its whole population first (8 rows) and half of it after
    (4): best-so-far is read from the rows the fitness scored, the JAX
    package's ``pop[: fitness.shape[0]]`` of its fixed-width buffer, and
    equals JAX's bit for bit (CSO with phi 0 is exact)."""
    lb, ub = -5 * np.ones(DIM, np.float32), 5 * np.ones(DIM, np.float32)
    jbase = JaxCSO(lb=lb, ub=ub, pop_size=8)
    jalgo = jg.GuardedAlgorithm(jbase, stagnation_limit=10_000)
    talgo = tg.GuardedAlgorithm(CSO(lb, ub, 8, device="cpu"), stagnation_limit=10_000)
    jstate = jalgo.init(jax.random.PRNGKey(1))
    tstate = interop.guarded_state(talgo, _np(jstate), seed=2)
    assert jstate.pop.shape == (8, DIM)  # JAX's buffer: the widest batch
    widths = []
    for gen in range(5):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        if gen:
            talgo.algorithm._draw = lambda s, d=_cso_draws(jbase, jstate.inner): d
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        widths.append(tcand.shape[0])
        assert torch.equal(tstate.pop, tcand)  # the port keeps the last batch
        fit = np.round(_sphere(jcand)).astype(np.float32)
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        np.testing.assert_array_equal(tstate.best_x.numpy(), np.asarray(jstate.best_x))
        assert float(tstate.best_fitness) == float(jstate.best_fitness)
        assert tstate.stagnation == int(jstate.stagnation)
    assert widths == [8, 4, 4, 4, 4]


def test_migrate_folds_migrants_into_best_so_far_like_jax():
    """A migrant better than best-so-far refreshes it and clears the
    stagnation counter; a worse one leaves both; the inner PSO ingests
    both through its own ``migrate``."""
    lb, ub = -5 * np.ones(DIM, np.float32), 5 * np.ones(DIM, np.float32)
    jalgo = jg.GuardedAlgorithm(JaxPSO(lb=lb, ub=ub, pop_size=8), stagnation_limit=50)
    talgo = tg.GuardedAlgorithm(PSO(lb, ub, 8, device="cpu"), stagnation_limit=50)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    tstate = interop.guarded_state(talgo, _np(jstate), seed=1)
    jcand, jstate = jit_once(jalgo, "init_ask")(jstate)
    _, tstate = talgo.init_ask(tstate)
    _, k1, k2 = jax.random.split(jstate.inner.key, 3)
    shape = (8, DIM)
    talgo.algorithm._draw = lambda s: (_t(jax.random.uniform(k1, shape)),
                                       _t(jax.random.uniform(k2, shape)))
    fit = _sphere(jcand)
    jstate = jit_once(jalgo, "init_tell")(jstate, jnp.asarray(fit))
    tstate = talgo.init_tell(tstate, torch.from_numpy(fit))
    for migrant, mfit, stag in ((np.zeros((1, DIM)), [0.0], 40), (np.full((1, DIM), 9.0), [405.0], 7)):
        jstate = jstate.replace(stagnation=jnp.asarray(stag, jnp.int32))
        tstate = tstate.replace(stagnation=stag)
        jstate = jalgo.migrate(jstate, jnp.asarray(migrant, jnp.float32), jnp.asarray(mfit))
        tstate = talgo.migrate(tstate, torch.tensor(migrant, dtype=torch.float32),
                               torch.tensor(mfit))
        assert tstate.stagnation == int(jstate.stagnation)
        assert float(tstate.best_fitness) == float(jstate.best_fitness) == 0.0
        np.testing.assert_array_equal(tstate.best_x.numpy(), np.asarray(jstate.best_x))
        for name in ("pbest_fitness", "pbest_position", "gbest_fitness", "population"):
            np.testing.assert_array_equal(getattr(tstate.inner, name).numpy(),
                                          np.asarray(getattr(jstate.inner, name)), err_msg=name)
    assert tstate.stagnation == 7


def test_recenter_state_variants():
    best = torch.arange(DIM, dtype=torch.float32)
    cma = tcma.CMAES(np.full(DIM, 3.0), 1.0, pop_size=8, device="cpu").init(0)
    assert torch.equal(tg.recenter_state(cma, best).mean, best)  # the port's CMA-ES: ``mean``
    assert torch.equal(tg.recenter_state(cma, best.numpy()).mean, best)  # numpy best too
    de = DE(-5 * np.ones(DIM), 5 * np.ones(DIM), 8, device="cpu").init(0)
    rd = tg.recenter_state(de, best)
    assert torch.equal(rd.population[0], best) and torch.equal(rd.population[1:], de.population[1:])
    assert tg.recenter_state(de, {"w": best}) is de  # a tree: nothing to re-center
    assert not torch.equal(de.population[0], best)  # the original is untouched


# ------------------------------------------------------------------- IPOP


class _Plateau(Problem):
    """Every candidate scores 1e3: the same fitness as JAX's
    ``PlateauSphere(radius=0.0)``, so every stagnation-driven trigger lands
    on the same generation in both packages, whatever their draws."""

    def evaluate(self, state, pop):
        return torch.full((pop.shape[0],), 1e3, device=pop.device), state


def _ipop_factories(jax_side: bool):
    center = np.full(DIM, 3.0, np.float32)

    def make(pop, handoff=False):
        if jax_side:
            inner = jcma.CMAES(center, 1.0 + handoff, pop_size=pop)
            return jg.GuardedAlgorithm(inner, stagnation_limit=5)
        inner = tcma.CMAES(center, 1.0 + handoff, pop_size=pop, device="cpu")
        return tg.GuardedAlgorithm(inner, stagnation_limit=5)

    return make, lambda pop: make(pop, handoff=True)


def test_ipop_doubling_schedule_matches_jax():
    """A plateau: the guard restarts at generation 6 (the first tell
    improves on +inf, then 5 do not), the boundary at 10 doubles λ to 16,
    the next restart (generation 15) doubles it to 32 at 20, through the
    handoff factory (``handoff_pop`` 32); the budget (2) is then spent and
    later restarts only move the baseline. ``_ipop_events``, the final λ
    and the counters equal the JAX package's."""
    results = []
    for jax_side, cls, wf_cls, prob in ((True, jg, JaxStdWorkflow, PlateauSphere(radius=0.0)),
                                        (False, tg, StdWorkflow, _Plateau())):
        make, handoff = _ipop_factories(jax_side)
        policy = cls.IPOPRestarts(make, max_restarts=2, check_every=10, handoff_pop=32,
                                  handoff_factory=handoff)
        kwargs = {} if jax_side else {"device": "cpu"}
        wf = wf_cls(make(8), prob, **kwargs)
        state = wf.init(jax.random.PRNGKey(0) if jax_side else 0)
        state = wf.run(state, 45, restarts=policy)
        results.append((wf._ipop_events, int(state.generation), int(state.algo.pop_size),
                        int(state.algo.restarts), int(state.algo.checked_restarts),
                        float(state.algo.inner.sigma)))
    (j_events, *j_rest), (t_events, *t_rest) = results
    assert t_events == j_events
    assert [e["pop_size"] for e in t_events] == [16, 32]
    assert [e["generation"] for e in t_events] == [10, 20]
    assert [e["handoff"] for e in t_events] == [False, True]
    # restarts at generations 6, 15, 20, 25, ..., 45 (8); the last check,
    # at 40, saw 7
    assert t_rest == j_rest == [45, 32, 8, 7, 2.0]  # sigma: the handoff track's init_stdev


def test_ipop_host_rules_and_refusals(tmp_path):
    """The policy's own stagnation limit escalates without a restart
    (to the budget, then only the baseline moves); the schedule is built
    eagerly at entry; ``run(restarts=)`` needs a GuardedAlgorithm; a resume
    from a directory without a snapshot keeps the given state (the resume
    law itself: tests/test_torch_checkpoint.py)."""
    make, _ = _ipop_factories(False)
    guard_off = lambda pop: tg.GuardedAlgorithm(  # noqa: E731
        tcma.CMAES(np.full(DIM, 3.0), 1.0, pop_size=pop, device="cpu"), stagnation_limit=10_000)
    policy = tg.IPOPRestarts(guard_off, max_restarts=2, check_every=4, stagnation_limit=3)
    wf = StdWorkflow(guard_off(8), _Plateau(), device="cpu")
    state = wf.run(wf.init(0), 20, restarts=policy)
    assert [(e["generation"], e["pop_size"]) for e in wf._ipop_events] == [(4, 16), (8, 32)]
    assert state.algo.pop_size == 32 and state.algo.restarts == 0 and state.generation == 20
    # a second run on the same workflow appends to its history (8
    # generations: one boundary that doubles, at 4)
    wf.run(wf.init(0), 8, restarts=policy)
    assert len(wf._ipop_events) == 3

    built = []

    def fragile(pop):
        built.append(pop)
        if pop > 16:
            raise ValueError(f"no room for {pop}")
        return make(pop)

    wf = StdWorkflow(fragile(8), _Plateau(), device="cpu")
    with pytest.raises(ValueError, match="no room for 32"):
        wf.run(wf.init(0), 30, restarts=tg.IPOPRestarts(fragile, max_restarts=2, check_every=10))
    assert built == [8, 16, 32]  # refused at entry, before any generation ran
    bare = StdWorkflow(tcma.CMAES(np.full(DIM, 3.0), 1.0, pop_size=8, device="cpu"), _Plateau(),
                       device="cpu")
    with pytest.raises(TypeError, match="GuardedAlgorithm"):
        bare.run(bare.init(0), 5, restarts=tg.IPOPRestarts(make, check_every=5))
    with pytest.raises(TypeError, match="GuardedAlgorithm"):
        tg.IPOPRestarts(lambda pop: tcma.CMAES(np.zeros(DIM), 1.0, pop_size=pop,
                                               device="cpu")).make_algorithm(8)
    for bad in ({"max_restarts": -1}, {"growth": 1}, {"check_every": 0}, {"handoff_pop": 8}):
        with pytest.raises(ValueError):
            tg.IPOPRestarts(make, **bad)
    from evox_tpu_torch.workflows.ipop import resolve_ipop_resume

    wf = StdWorkflow(make(8), _Plateau(), device="cpu")
    state = wf.init(0)
    got_wf, got, remaining, ckpt = resolve_ipop_resume(wf, tg.IPOPRestarts(make), state, 5,
                                                       str(tmp_path / "none"))
    assert (got_wf, got, remaining) == (wf, state, 5) and ckpt.snapshots() == []
