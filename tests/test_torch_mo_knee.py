"""The port's GDE3, KnEA and BiGE against the JAX package, on the CPU.

GDE3's tell on inputs where a share of the parent-trial pairs dominate each
other (both ``+inf`` branches), KnEA's knees over two generations with its
``r`` and ``t`` carried, BiGE's bi-goals and selection. JAX's draws reach
the port through each algorithm's ``_draw`` method
(``tests/_torch_mo_draws.py``) and JAX's state through ``interop``.
Survivors, ranks and knee masks are compared exactly, floats with the
tolerance stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mo_draws as draws
from evox_tpu.algorithms.mo import GDE3 as JaxGDE3
from evox_tpu.algorithms.mo import BiGE as JaxBiGE
from evox_tpu.algorithms.mo import KnEA as JaxKnEA
from evox_tpu.algorithms.mo import bige as jbige
from evox_tpu.algorithms.mo import knea as jknea
from evox_tpu.problems.numerical import DTLZ2 as JaxDTLZ2
from evox_tpu.problems.numerical import LSMOP1 as JaxLSMOP1
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms import mo as tmo
from evox_tpu_torch.algorithms.mo import bige as tbige
from evox_tpu_torch.algorithms.mo import knea as tknea
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.problems import numerical as tnum

# SBX, the polynomial mutation and DE's F · difference: powers and products
# in other orders: the last ulps
POW_RTOL, POW_ATOL = 1e-5, 1e-6
D, M, POP = 7, 3, 32


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _objs(n, m, seed):
    rng = np.random.default_rng(seed)
    pts = rng.dirichlet(np.ones(m), size=n) + rng.random((n, 1)) * 0.3
    return pts.astype(np.float32)


# ------------------------------------------------------------------ GDE3


def _gde3_pair(pop_size, d=D):
    jalgo = JaxGDE3(jnp.zeros(d), jnp.ones(d), n_objs=M, pop_size=pop_size)
    talgo = tmo.GDE3(np.zeros(d), np.ones(d), n_objs=M, pop_size=pop_size, device="cpu")
    return jalgo, talgo


def test_gde3_ask_on_jax_draws_matches():
    """The DE/rand/1/bin trials, clipped to the box: F · difference within
    the POW tolerance (XLA may fuse the multiply-add)."""
    jalgo, talgo = _gde3_pair(POP)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    tstate = interop.mo_state(talgo, _numpy_tree(jstate))
    talgo._draw = lambda seed, d=draws.gde3(jalgo, jstate.key): d
    j_off, _ = jalgo.ask(jstate)
    t_off, t_after = talgo.ask(tstate)
    np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
    assert torch.equal(t_after.offspring, t_off)


@pytest.mark.parametrize("case", ["random", "dominating_pairs", "duplicates"])
def test_gde3_tell_with_inf_rows_matches_jax(case):
    """GDE3's tell: parents and trials of which a share dominate each other
    (both +inf branches taken), so +inf rows reach the dominance matrix, the
    peel and the crowding distance (inf - inf = NaN there, 0 in the
    distance). Survivors, their order and their fitness (the +inf rows
    included when they survive) exactly."""
    rng = np.random.default_rng(len(case))
    n = 24
    parents = _objs(n, M, 1)
    trials = _objs(n, M, 2)
    if case == "dominating_pairs":
        trials[:8] = parents[:8] - 0.05  # the trial dominates: the parent goes to +inf
        trials[8:16] = parents[8:16] + 0.05  # the parent dominates: the trial goes to +inf
        trials[16] = parents[16]  # equal: neither dominates
    elif case == "duplicates":
        trials[:12] = parents[:12] + 0.01
        parents[12:] = parents[12]
        trials[12:] = trials[12]
    jalgo, talgo = _gde3_pair(n)
    pop = rng.random((n, D)).astype(np.float32)
    off = rng.random((n, D)).astype(np.float32)
    jstate = jalgo.init(jax.random.PRNGKey(1)).replace(
        population=jnp.asarray(pop), fitness=jnp.asarray(parents), offspring=jnp.asarray(off))
    tstate = interop.mo_state(talgo, _numpy_tree(jstate))
    want = jalgo.tell(jstate, jnp.asarray(trials))
    got = talgo.tell(tstate, _t(trials))
    np.testing.assert_array_equal(got.population.numpy(), _np(want.population))
    np.testing.assert_array_equal(got.fitness.numpy(), _np(want.fitness))
    assert np.isfinite(got.fitness.numpy()).all()  # n finite rows or more: no +inf survives


def test_gde3_when_every_parent_dominates_its_trial():
    """Every trial dominated: all 24 trials go to +inf and the 24 parents
    survive, in JAX's order."""
    parents = _objs(24, M, 3)
    trials = parents + 0.1  # every parent dominates its trial
    jalgo, talgo = _gde3_pair(24)
    jstate = jalgo.init(jax.random.PRNGKey(2)).replace(fitness=jnp.asarray(parents))
    tstate = interop.mo_state(talgo, _numpy_tree(jstate))
    want = jalgo.tell(jstate, jnp.asarray(trials))
    got = talgo.tell(tstate, _t(trials))
    np.testing.assert_array_equal(got.fitness.numpy(), _np(want.fitness))
    np.testing.assert_array_equal(got.population.numpy(), _np(want.population))
    assert np.isfinite(got.fitness.numpy()).all()


def test_gde3_generations_on_lsmop1_match():
    """Three GDE3 generations on LSMOP1 (d 30, m 3, pop 32, path 10's
    problem at a small width) from JAX's state on JAX's draws, the state
    carried through ``interop`` every generation: survivors (fitness)
    exact, the population within the POW tolerance."""
    jprob = JaxLSMOP1(d=30, m=M)
    lb, ub = (np.asarray(b) for b in jprob.bounds())
    jalgo = JaxGDE3(jnp.asarray(lb), jnp.asarray(ub), n_objs=M, pop_size=POP)
    talgo = tmo.GDE3(lb, ub, n_objs=M, pop_size=POP, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(3))
    jstate = jalgo.init_tell(jstate, jprob.evaluate(None, jstate.population)[0])
    infs = 0
    for gen in range(3):
        tstate = interop.mo_state(talgo, _numpy_tree(jstate), seed=gen)
        talgo._draw = lambda seed, d=draws.gde3(jalgo, jstate.key): d
        j_off, jstate = jalgo.ask(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        fit = _np(jprob.evaluate(None, j_off)[0])
        par = _np(jstate.fitness)
        infs += int((np.all(fit <= par, 1) & np.any(fit < par, 1)).sum())
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        np.testing.assert_array_equal(tstate.fitness.numpy(), _np(jstate.fitness))
        np.testing.assert_allclose(tstate.population.numpy(), _np(jstate.population),
                                   rtol=POW_RTOL, atol=POW_ATOL)
    assert infs > 0  # trials dominated parents: the +inf branch ran


# ------------------------------------------------------------------ KnEA


def test_knea_helpers_match_jax():
    """DW (the k + 1 smallest distances of each row: within 1e-5, a sum of
    weighted distances), the front plane (an m x m solve: 1e-5), and its
    diagonal fallback on a singular front; ``argsort`` puts NaN last in both
    packages."""
    fit = _objs(30, M, 4)
    np.testing.assert_allclose(tknea.weighted_neighbor_dist(_t(fit), 3).numpy(),
                               _np(jknea.weighted_neighbor_dist(jnp.asarray(fit), 3)),
                               rtol=1e-5, atol=1e-6)
    masked = fit.copy()
    masked[10:] = np.nan
    singular = masked.copy()
    singular[:10] = np.array([1.0, 1.0, 1.0], np.float32)
    for f in (masked, singular):
        np.testing.assert_allclose(tknea.front_plane(_t(f), M).numpy(),
                                   _np(jknea._front_plane(jnp.asarray(f), M)), rtol=1e-5, atol=1e-6)
    v = np.array([0.3, np.nan, -1.0, np.nan, 0.3, np.inf], np.float32)
    np.testing.assert_array_equal(torch.argsort(_t(v), stable=True).numpy(), _np(jnp.argsort(v)))


def test_knea_generations_with_carried_r_and_t_match():
    """Two KnEA generations (pop 32, DTLZ2 d 7) from JAX's state on JAX's
    draws, ``r`` and ``t`` carried by the port's own state from the first
    generation to the second: survivors (fitness), ranks and knee masks
    exact; ``r`` and ``t`` within 1e-6 (``r`` takes an exp per front);
    the population within the POW tolerance."""
    jalgo = JaxKnEA(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=POP)
    talgo = tmo.KnEA(np.zeros(D), np.ones(D), n_objs=M, pop_size=POP, device="cpu")
    jprob = JaxDTLZ2(d=D, m=M)
    jstate = jalgo.init(jax.random.PRNGKey(7))
    jstate = jalgo.init_tell(jstate, jprob.evaluate(None, jstate.population)[0])
    tstate = interop.mo_family_state(talgo, _numpy_tree(jstate))
    np.testing.assert_array_equal(tstate.rank.numpy(), _np(jstate.rank))
    knees = 0
    for _ in range(2):
        talgo._draw = lambda seed, d=draws.tournament_ga(jalgo, jstate.key): d
        j_off, jstate = jalgo.ask(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        fit = _np(jprob.evaluate(None, j_off)[0])
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        for name in ("fitness", "rank", "knee"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(), _np(getattr(jstate, name)),
                                          err_msg=name)
        for name in ("r", "t"):
            np.testing.assert_allclose(float(getattr(tstate, name)), float(getattr(jstate, name)),
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(tstate.population.numpy(), _np(jstate.population),
                                   rtol=POW_RTOL, atol=POW_ATOL)
        knees += int(tstate.knee.sum())
    assert float(tstate.r) != 1.0 and knees > 0


# ------------------------------------------------------------------ BiGE


def test_bi_goals_match_jax():
    """Proximity (a sum over m 3 in order: exact) and the crowding degree
    (a sum over n sharing terms and a root: within 1e-5), live rows only."""
    fit = _objs(40, M, 8)
    mask = np.random.default_rng(8).random(40) < 0.6
    for msk in (np.ones(40, bool), mask):
        want = _np(jbige.bi_goals(jnp.asarray(fit), jnp.asarray(msk)))
        got = tbige.bi_goals(_t(fit), _t(msk)).numpy()
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=1e-6)
        assert np.isinf(got[~msk]).all()


def test_bige_generations_match(monkeypatch):
    """Two BiGE generations (pop 32, DTLZ2 d 7) from JAX's state on JAX's
    draws, three dominance matrices a generation (the plain version on the
    CPU; on the card, three ``packed_dominance`` launches): survivors
    (fitness) exact, the population within the POW tolerance."""
    jalgo = JaxBiGE(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=POP)
    talgo = tmo.BiGE(np.zeros(D), np.ones(D), n_objs=M, pop_size=POP, device="cpu")
    jprob = JaxDTLZ2(d=D, m=M)
    jstate = jalgo.init(jax.random.PRNGKey(9))
    jstate = jalgo.init_tell(jstate, jprob.evaluate(None, jstate.population)[0])
    calls = []
    plain = tdom.packed_dominance_reference
    monkeypatch.setattr(tdom, "packed_dominance_reference",
                        lambda fit: calls.append(fit.shape) or plain(fit))
    for gen in range(2):
        tstate = interop.mo_state(talgo, _numpy_tree(jstate), seed=gen)
        talgo._draw = lambda seed, d=draws.tournament_ga(jalgo, jstate.key): d
        j_off, jstate = jalgo.ask(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        fit = _np(jprob.evaluate(None, j_off)[0])
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        np.testing.assert_array_equal(tstate.fitness.numpy(), _np(jstate.fitness))
        np.testing.assert_allclose(tstate.population.numpy(), _np(jstate.population),
                                   rtol=POW_RTOL, atol=POW_ATOL)
    assert calls == [(POP, 2), (2 * POP, M), (2 * POP, 2)] * 2


# ---------------------------------------------------- gates and devices


@pytest.mark.parametrize("name", ["GDE3", "KnEA", "BiGE"])
def test_knee_family_passes_a_dtlz2_igd_gate(name):
    """GDE3, KnEA and BiGE on DTLZ2 (d 7, m 3, pop 64, 30 generations),
    drawn by the port: IGD below 0.3 on seeds 0 and 1 (the port's: GDE3
    0.123 and 0.121, KnEA 0.122 and 0.138, BiGE 0.145 and 0.134; torch
    2.13, CPU)."""
    for seed in range(2):
        prob = tnum.DTLZ2(d=D, m=M, device="cpu")
        algo = getattr(tmo, name)(torch.zeros(D), torch.ones(D), n_objs=M, pop_size=64, device="cpu")
        wf = StdWorkflow(algo, prob, device="cpu")
        fit = wf.run(wf.init(seed), 30).algo.fitness
        assert float(igd(fit, prob.pf())) < 0.3, (name, seed)
