"""The port's indicator-based MOEAs against the JAX package, on the CPU:
IBEA, SRA, BCE-IBEA in both phases, SPEA2 in both branches of its
selection, and HypE on its three routes (the exact 2-D sweep, the exact
3-D contributions, the Monte Carlo estimate).

JAX's draws reach the port through each algorithm's ``_draw`` method
(``tests/_torch_mo_draws.py``) and JAX's state through ``interop``, every
generation; both tells get the same fitness. Survivor sets, ranks and the
SRA order are compared exactly, floats with the tolerance stated at each
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mo_draws as draws
import evox_tpu.algorithms.mo as jmo
from evox_tpu.algorithms.mo import BCEIBEA as JaxBCEIBEA
from evox_tpu.algorithms.mo import IBEA as JaxIBEA
from evox_tpu.algorithms.mo import SPEA2 as JaxSPEA2
from evox_tpu.algorithms.mo import SRA as JaxSRA
from evox_tpu.algorithms.mo import HypE as JaxHypE
from evox_tpu.algorithms.mo import bce_ibea as jbce
from evox_tpu.algorithms.mo import hype as jhype
from evox_tpu.algorithms.mo import ibea as jibea
from evox_tpu.algorithms.mo import spea2 as jspea2
from evox_tpu.algorithms.mo import sra as jsra
from evox_tpu.operators.selection.non_dominate import non_dominated_sort as jnds
from evox_tpu.problems.numerical import DTLZ2 as JaxDTLZ2
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms import mo as tmo
from evox_tpu_torch.algorithms.mo import bce_ibea as tbce
from evox_tpu_torch.algorithms.mo import hype as thype
from evox_tpu_torch.algorithms.mo import ibea as tibea
from evox_tpu_torch.algorithms.mo import spea2 as tspea2
from evox_tpu_torch.algorithms.mo import sra as tsra
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.problems import numerical as tnum

# SBX and the polynomial mutation take powers: XLA's and PyTorch's differ
# in the last ulps
POW_RTOL, POW_ATOL = 1e-5, 1e-6
# IBEA's scores: XLA's exp misses the correctly rounded value the port takes
# (exp_rn) in about one float32 input in ten, and the column sums add in
# other orders; a score is a sum of up to n terms whose own term (-1) is
# taken off again, so its error is a few ulps of the largest term in its
# column: 1e-5 relative, 1e-5 of the largest |score| absolute
SCORE_RTOL = 1e-5
# the Monte Carlo HypE fitness: sums of the weights over 8192 samples and a
# cumulative product, in other orders than XLA's
HYPE_RTOL = 1e-5
# the exact 3-D contributions: differences of two volumes, to 1e-5 of the
# largest (test_torch_mo_family.py's HV_RTOL)
HV_ATOL = 1e-5
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


def _score_close(got, want):
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_RTOL * float(np.abs(want).max()))


def _removal_gaps(expo, keep):
    """JAX's removal loop replayed in float64 on JAX's terms: the least gap
    between the removed row's score and the next live score, over every
    removal, and the largest |score| at the start (the scale of the score
    tolerance, which the gap must exceed twice over for the order to hold
    on the port's scores)."""
    expo = np.asarray(expo, np.float64)
    n = expo.shape[0]
    alive = np.ones(n, bool)
    scores = expo.sum(axis=0) - np.diagonal(expo)
    scale = float(np.abs(scores).max())
    gaps = []
    for _ in range(n - keep):
        masked = np.where(alive, scores, np.inf)
        worst = int(np.argmin(masked))
        gaps.append(np.partition(masked, 1)[1] - masked[worst])
        alive[worst] = False
        scores = scores - expo[worst]
    return min(gaps), scale


# ------------------------------------------------------------------ IBEA


@pytest.mark.parametrize("n", [16, 64])
def test_ibea_fitness_and_indicator_match_jax(n):
    """The indicator matrix (a running maximum: exact), the exponential
    terms and the fitness, on Dirichlet points with a repeated row."""
    fit = _objs(n, M, n)
    fit[3] = fit[5]
    np.testing.assert_array_equal(tibea.eps_indicator_matrix(_t(fit)).numpy(),
                                  _np(jibea._eps_indicator_matrix(jnp.asarray(fit))))
    _score_close(tibea.ibea_fitness(_t(fit), 0.05).numpy(),
                 _np(jibea.ibea_fitness(jnp.asarray(fit), 0.05)))


@pytest.mark.parametrize("n,keep", [(64, 32), (48, 20), (12, 11)])
def test_ibea_select_matches_jax_where_the_scores_are_apart(n, keep):
    """IBEA's worst removal: the survivor set of JAX's ``fori_loop``. On
    these inputs every removal's least score stands apart from the next by
    far more than the score tolerance (checked here on JAX's terms), so
    the order cannot turn on the last bits. The fast loop (dead rows at
    +inf, three launches a removal) equals the step-by-step one exactly and
    hands its matrix back as it found it."""
    fit = _objs(n, M, 100 + n)
    jalgo = JaxIBEA(jnp.zeros(D), jnp.ones(D), M, keep)
    talgo = tmo.IBEA(np.zeros(D), np.ones(D), M, keep, device="cpu")
    pop = np.random.default_rng(n).random((n, D)).astype(np.float32)
    j_pop, j_fit = jalgo.select(None, jnp.asarray(pop), jnp.asarray(fit))
    t_pop, t_fit = talgo.select(None, _t(pop), _t(fit))
    np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))
    np.testing.assert_array_equal(t_pop.numpy(), _np(j_pop))
    # the margin: JAX's own terms, its loop replayed
    I = jibea._eps_indicator_matrix(jnp.asarray(fit))
    c = jnp.maximum(jnp.max(jnp.abs(I)), 1e-12)
    gap, scale = _removal_gaps(-jnp.exp(-I / (c * 0.05)), keep)
    assert gap > 4 * SCORE_RTOL * scale, (gap, scale)
    expo = tibea.indicator_terms(_t(fit), 0.05)
    stepwise, order = tibea.worst_removal_stepwise(expo.clone(), keep)
    before = expo.clone()
    assert torch.equal(tibea.worst_removal(expo, keep), stepwise)
    assert torch.equal(expo, before)
    assert order.shape == (n - keep,) and len(set(order.tolist())) == n - keep


def test_ibea_select_on_nan_and_infinite_objectives_matches_jax():
    """A NaN or infinite objective makes every term NaN; JAX's argmin then
    removes rows in index order, and so does the port's (its NaNs set to
    0)."""
    for bad in (np.nan, np.inf):
        fit = _objs(20, M, 7)
        fit[4, 1] = bad
        jalgo = JaxIBEA(jnp.zeros(D), jnp.ones(D), M, 8)
        talgo = tmo.IBEA(np.zeros(D), np.ones(D), M, 8, device="cpu")
        _, j_fit = jalgo.select(None, jnp.asarray(fit), jnp.asarray(fit))
        _, t_fit = talgo.select(None, _t(fit), _t(fit))
        np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))
        np.testing.assert_array_equal(t_fit.numpy(), fit[12:])


def _start(jalgo, talgo, jprob, seed, carry=interop.mo_state):
    jstate = jalgo.init(jax.random.PRNGKey(seed))
    jstate = jalgo.init_tell(jstate, jprob.evaluate(None, jstate.population)[0])
    return jstate, carry(talgo, _numpy_tree(jstate))


def _generation(jalgo, talgo, jprob, jstate, tstate, d):
    """One ask and tell on both sides, JAX's draws ``d`` handed to the
    port, the same fitness (JAX's offspring evaluated) told to both:
    ``(jax state, port state, the fitness told)``."""
    talgo._draw = lambda *args, d=d: d
    j_off, jstate = jalgo.ask(jstate)
    t_off, tstate = talgo.ask(tstate)
    np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
    fit = _np(jprob.evaluate(None, j_off)[0])
    return jalgo.tell(jstate, jnp.asarray(fit)), talgo.tell(tstate, _t(fit)), fit


def _check(tstate, jstate, exact=("fitness",), close=("population",)):
    for name in exact:
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), _np(getattr(jstate, name)),
                                      err_msg=name)
    for name in close:
        np.testing.assert_allclose(getattr(tstate, name).numpy(), _np(getattr(jstate, name)),
                                   rtol=POW_RTOL, atol=POW_ATOL, err_msg=name)


@pytest.mark.parametrize("cls", ["IBEA", "SPEA2"])
def test_generations_from_a_jax_state_match(cls):
    """Three generations of IBEA and SPEA2 (pop 32, DTLZ2 d 7) from JAX's
    state, the state carried across through ``interop`` every generation:
    the tournament winners (offspring within the POW tolerance) and the
    survivors (fitness exact; population within the POW tolerance)."""
    jalgo = getattr(jmo, cls)(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=POP)
    talgo = getattr(tmo, cls)(np.zeros(D), np.ones(D), n_objs=M, pop_size=POP, device="cpu")
    jprob = JaxDTLZ2(d=D, m=M)
    jstate, tstate = _start(jalgo, talgo, jprob, 2)
    for gen in range(3):
        tstate = interop.mo_state(talgo, _numpy_tree(jstate), seed=gen)
        jstate, tstate, _ = _generation(jalgo, talgo, jprob, jstate, tstate,
                                        draws.tournament_ga(jalgo, jstate.key))
        _check(tstate, jstate)


# ------------------------------------------------------------------- SRA


def test_sra_indicators_and_ranking_match_jax():
    """The indicators within the score tolerance (SDE: a norm over m 3, an
    ulp); the stochastic ranking's order exactly, on JAX's indicators and
    JAX's draws (a fixed pc and a drawn one), against JAX's sweeps re-run
    as its select runs them."""
    fit = _objs(40, M, 3)
    fit[6] = fit[7]
    i_eps, sde = tsra.sra_indicators(_t(fit))
    j_eps = -jibea.ibea_fitness(jnp.asarray(fit), 0.05)
    j_sde = -jsra._sde_density(jnp.asarray(fit))
    _score_close(i_eps.numpy(), _np(j_eps))
    np.testing.assert_allclose(sde.numpy(), _np(j_sde), rtol=1e-6, atol=1e-7)
    for pc in (None, 0.5):
        jalgo = JaxSRA(jnp.zeros(D), jnp.ones(D), M, 20, pc=pc, sweeps=15)
        key = jax.random.PRNGKey(11)
        d = draws.sra(jalgo, key, pc)
        state = jalgo.init(key).replace(key=jax.random.split(key, 3)[0])
        _, want = jalgo.select(state, jnp.arange(40)[:, None], jnp.asarray(fit))
        order = tsra.stochastic_ranking(_t(j_eps), _t(j_sde), d["perm"], d["u_sweeps"], d["pc"])
        np.testing.assert_array_equal(_t(fit)[order[:20]].numpy(), _np(want))


def test_sra_generations_from_a_jax_state_match():
    """Two SRA generations (pop 32, pop_size sweeps) from JAX's state on
    JAX's draws: survivors (fitness) exact, the population within the POW
    tolerance."""
    jalgo = JaxSRA(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=POP)
    talgo = tmo.SRA(np.zeros(D), np.ones(D), n_objs=M, pop_size=POP, device="cpu")
    jprob = JaxDTLZ2(d=D, m=M)
    jstate, tstate = _start(jalgo, talgo, jprob, 4)
    for gen in range(2):
        tstate = interop.mo_state(talgo, _numpy_tree(jstate), seed=gen)
        jstate, tstate, _ = _generation(jalgo, talgo, jprob, jstate, tstate, draws.sra(jalgo, jstate.key))
        _check(tstate, jstate)
        assert tstate.select_draws is None


# -------------------------------------------------------------- BCE-IBEA


def test_bce_ibea_helpers_match_jax():
    """The exploration mask and the PC selection (the thinning taken: 30
    non-dominated rows for 12 slots; and not: padded with the first kept
    row), exactly."""
    rng = np.random.default_rng(5)
    t_ = rng.random(30)
    front = np.stack([t_, 1.0 - t_, 0.5 + 0.1 * rng.random(30)], axis=1).astype(np.float32)
    front[:, 2] = 0.5
    npc = _objs(30, M, 6)
    pc = rng.random((30, D)).astype(np.float32)
    for n_nd in (30, 12):
        np.testing.assert_array_equal(
            tbce.exploration(_t(front), _t(npc), torch.tensor(n_nd, dtype=torch.int32), 12).numpy(),
            _np(jbce.exploration(jnp.asarray(front), jnp.asarray(npc), jnp.int32(n_nd), 12)))
    mixed = np.concatenate([front[:8], front[:8] + 0.5, _objs(14, M, 9) + 1.0]).astype(np.float32)
    for fit, n in ((front, 12), (mixed, 12)):
        want = jbce.pc_selection(jnp.asarray(pc), jnp.asarray(fit), n)
        got = tbce.pc_selection(_t(pc), _t(fit), n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))


def test_bce_ibea_generations_in_both_phases_match():
    """Four BCE-IBEA generations (pop 32): odd (exploration) and even (NPC
    round, PC selection over 3 pop rows) phases on JAX's draws, the state
    carried through ``interop`` every generation: the PC archive and the
    NPC population's fitness exact, ``n_nd`` and ``counter`` exact, the
    populations within the POW tolerance."""
    jalgo = JaxBCEIBEA(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=POP)
    talgo = tmo.BCEIBEA(np.zeros(D), np.ones(D), n_objs=M, pop_size=POP, device="cpu")
    jprob = JaxDTLZ2(d=D, m=M)
    jstate, tstate = _start(jalgo, talgo, jprob, 5, carry=interop.mo_family_state)
    launches = tdom.packed_dominance.launches
    for gen in range(4):
        tstate = interop.mo_family_state(talgo, _numpy_tree(jstate), seed=gen)
        assert tstate.counter == gen + 1
        d = draws.bce_ibea(jalgo, jstate.key, even=tstate.counter % 2 == 0)
        jstate, tstate, _ = _generation(jalgo, talgo, jprob, jstate, tstate, d)
        _check(tstate, jstate, exact=("fitness", "npc_fit", "new_pc_fit", "n_nd"),
               close=("population", "npc", "new_pc"))
        assert tstate.counter == int(jstate.counter)
    assert tdom.packed_dominance.launches == launches  # the CPU takes the plain version


# ----------------------------------------------------------------- SPEA2


def test_spea2_fitness_and_both_branches_match_jax():
    """The strength fitness (raw counts exact, the density within 1e-6:
    a distance from a matrix product) and the selection by both branches:
    by fitness when the non-dominated rows fit, by the truncation when they
    overflow (40 rows on one front for 16 slots), exactly."""
    dominated = _objs(48, M, 8)
    rng = np.random.default_rng(8)
    t_ = rng.random(40)
    overflow = np.concatenate([np.stack([t_, 1.0 - t_, np.full(40, 0.5)], 1),
                               _objs(8, M, 9) + 1.0]).astype(np.float32)
    pop = rng.random((48, D)).astype(np.float32)
    for fit, keep in ((dominated, 16), (overflow, 16)):
        np.testing.assert_allclose(tspea2.spea2_fitness(_t(fit)).numpy(),
                                   _np(jspea2.spea2_fitness(jnp.asarray(fit))), rtol=1e-6, atol=1e-7)
        jalgo = JaxSPEA2(jnp.zeros(D), jnp.ones(D), M, keep)
        talgo = tmo.SPEA2(np.zeros(D), np.ones(D), M, keep, device="cpu")
        j_pop, j_fit = jalgo.select(None, jnp.asarray(pop), jnp.asarray(fit))
        t_pop, t_fit = talgo.select(None, _t(pop), _t(fit))
        np.testing.assert_array_equal(t_pop.numpy(), _np(j_pop))
        np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))
    assert int((tspea2.spea2_fitness(_t(overflow)) < 1).sum()) == 40


# ------------------------------------------------------------------ HypE


@pytest.mark.parametrize("m", [2, 3])
def test_hype_exact_contributions_match_jax(m):
    """The exact 2-D sweep (products of differences: exact) and the exact
    3-D contributions grouped by rank (within 1e-5 of the largest)."""
    fit = _objs(30, m, 10 + m)
    fit[4] = fit[5] + 0.05
    rank = _np(jnds(jnp.asarray(fit))).astype(np.int32)
    ref = np.full(m, 1.6, np.float32)
    if m == 2:
        np.testing.assert_array_equal(
            thype.exact_contrib_2d(_t(fit), _t(ref), _t(rank)).numpy(),
            _np(jhype.exact_contrib_2d(jnp.asarray(fit), jnp.asarray(ref), jnp.asarray(rank))))
    else:
        want = _np(jhype.exact_contrib_3d(jnp.asarray(fit), jnp.asarray(ref), jnp.asarray(rank)))
        got = thype.exact_contrib_3d(_t(fit), _t(ref), _t(rank)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=HV_ATOL * want.max())


def test_hype_monte_carlo_fitness_matches_jax():
    """The Monte Carlo fitness on JAX's uniforms: within HYPE_RTOL (zero
    where no sample is covered alone)."""
    fit = _objs(40, 4, 12)
    ref = jnp.full((4,), 1.6)
    key = jax.random.PRNGKey(3)
    want = _np(jhype.hype_fitness(key, jnp.asarray(fit), ref, 20, 4096))
    u = draws.t(jax.random.uniform(key, (4096, 4)))
    got = thype.hype_fitness(0, _t(fit), _t(ref), 20, 4096, u=u).numpy()
    np.testing.assert_allclose(got, want, rtol=HYPE_RTOL, atol=HYPE_RTOL * want.max())


@pytest.mark.parametrize("route,m,exact_max", [("exact_2d", 2, 512), ("exact_3d", 3, 512),
                                               ("monte_carlo", 3, 0)])
def test_hype_generations_on_each_route_match(route, m, exact_max):
    """Two HypE generations (pop 32) on each route, from JAX's state on
    JAX's draws: the survivors (fitness) and their ranks exact, the
    population within the POW tolerance, the reference point carried. The
    exact 3-D contributions are differences of two volumes, good to 1e-5 of
    the largest (``HV_ATOL``): there the survivors may differ only on the
    cut front, between rows whose JAX contributions lie within twice that
    of each other."""
    jalgo = JaxHypE(jnp.zeros(D), jnp.ones(D), n_objs=m, pop_size=POP, exact_hv_max_n=exact_max)
    talgo = tmo.HypE(np.zeros(D), np.ones(D), n_objs=m, pop_size=POP, exact_hv_max_n=exact_max,
                     device="cpu")
    mc = route == "monte_carlo"
    assert talgo._monte_carlo(POP) == mc and talgo._monte_carlo(2 * POP) == mc
    jprob = JaxDTLZ2(d=D, m=m)
    jstate, tstate = _start(jalgo, talgo, jprob, 6, carry=interop.mo_family_state)
    np.testing.assert_array_equal(tstate.ref_point.numpy(), _np(jstate.ref_point))
    for gen in range(2):
        tstate = interop.mo_family_state(talgo, _numpy_tree(jstate), seed=gen)
        d = draws.hype(jalgo, jstate.key, mc, mc)
        before = jstate
        jstate, tstate, told = _generation(jalgo, talgo, jprob, jstate, tstate, d)
        if route == "exact_3d":
            _check_cut_ties(before, told, jstate, tstate)
        else:
            _check(tstate, jstate, exact=("fitness", "rank"))
        assert tstate.u_select is None


def _check_cut_ties(before, told, jstate, tstate):
    """HypE's exact 3-D selection against JAX's: the same rows but where
    the cut front's contributions lie within twice ``HV_ATOL`` of each
    other (see the test above)."""
    merged = np.concatenate([_np(before.fitness), told])
    rank = _np(jnds(jnp.asarray(merged)))
    contrib = _np(jhype.exact_contrib_3d(jnp.asarray(merged), before.ref_point, jnp.asarray(rank)))
    rows = {tuple(r): i for i, r in enumerate(merged.tolist())}
    kept_j = {rows[tuple(r)] for r in _np(jstate.fitness).tolist()}
    kept_t = {rows[tuple(r)] for r in tstate.fitness.numpy().tolist()}
    differ = sorted(kept_j ^ kept_t)
    cut = np.sort(rank)[POP]
    assert all(rank[i] == cut for i in differ), differ
    if differ:
        spread = contrib[differ].max() - contrib[differ].min()
        assert spread <= 2 * HV_ATOL * contrib.max(), (spread, contrib.max())
    np.testing.assert_array_equal(np.sort(tstate.rank.numpy()), np.sort(_np(jstate.rank)))


# ----------------------------------------------------------------- gates


@pytest.mark.parametrize("name", ["IBEA", "SRA", "BCEIBEA", "SPEA2", "HypE"])
def test_indicator_family_passes_a_dtlz2_igd_gate(name):
    """Each on DTLZ2 (d 7, m 3, pop 64, 30 generations), drawn by the port:
    IGD below 0.3 on seeds 0 and 1 (the port's: IBEA 0.111 and 0.125, SRA
    0.140 and 0.150, BCE-IBEA 0.141 and 0.171, SPEA2 0.146 and 0.173, HypE
    0.109 and 0.134; torch 2.13, CPU)."""
    for seed in range(2):
        prob = tnum.DTLZ2(d=D, m=M, device="cpu")
        algo = getattr(tmo, name)(torch.zeros(D), torch.ones(D), n_objs=M, pop_size=64, device="cpu")
        wf = StdWorkflow(algo, prob, device="cpu")
        fit = wf.run(wf.init(seed), 30).algo.fitness
        assert float(igd(fit, prob.pf())) < 0.3, (name, seed)
