"""The port's NSGA-II slice against the JAX package, on the CPU.

Operators, selection, LSMOP1, IGD and whole NSGA-II generations: the same
numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``evox_tpu_torch`` (``device="cpu"``). Random draws do not
cross between the two libraries, so the JAX draws are handed to the port
(SBX's ``u``, polynomial's ``site`` and ``u``, the tournament's
``contestants``). Integer outputs (ranks, survivor indices and sets) are
compared exactly; float outputs with the tolerance stated at each test.
Whole runs are held by the ZDT1 IGD < 0.1 convergence gate.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.mo import NSGA2 as JaxNSGA2
from evox_tpu.metrics import igd as jax_igd
from evox_tpu.operators.crossover.sbx import simulated_binary as jax_sbx
from evox_tpu.operators.mutation.ops import polynomial as jax_polynomial
from evox_tpu.operators.mutation.ops import bitflip as jax_bitflip
from evox_tpu.operators.mutation.ops import gaussian as jax_gaussian
from evox_tpu.operators.sampling.uniform import UniformSampling as JaxUniformSampling
from evox_tpu.operators.selection import basic as jbasic
from evox_tpu.operators.selection.basic import tournament_multifit as jax_tournament_multifit
from evox_tpu.problems import numerical as jnum
from evox_tpu.problems.numerical import LSMOP1 as JaxLSMOP1
from evox_tpu.problems.numerical import ZDT1 as JaxZDT1
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.mo import NSGA2, common as mo_common, nsga2 as mo_nsga2
from evox_tpu_torch.kernels import dominance as tdom, topk as ttopk
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.operators.crossover import simulated_binary
from evox_tpu_torch.operators.mutation import bitflip, gaussian, polynomial
from evox_tpu_torch.operators.sampling import UniformSampling
from evox_tpu_torch.operators.selection import basic as tbasic
from evox_tpu_torch.operators.selection import (
    NonDominate,
    crowding_distance,
    non_dominate_indices,
    rank_crowding_truncate,
    tournament_multifit,
)
from evox_tpu_torch.problems import numerical as tnum
from evox_tpu_torch.problems.numerical import LSMOP1, ZDT1

# the module, not the function of the same name its package exports
jnd = importlib.import_module("evox_tpu.operators.selection.non_dominate")
tnd = importlib.import_module("evox_tpu_torch.operators.selection.non_dominate")

# SBX and polynomial mutation raise float32 numbers to powers (1/21 and 21)
# in chains; the two libraries' pow may differ in the last ulps.
POW_RTOL, POW_ATOL = 1e-5, 1e-6
# crowding distance: differences of sorted objectives over their range,
# summed over objectives in the same order; one ulp of the division at most
CROWD_RTOL = 1e-6
# LSMOP1: means of squares over ~60-element subgroups, reduced in another
# order than XLA's; fitness of order 1e1-1e3
LSMOP_RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mo_fitness(n, m, seed):
    rng = np.random.default_rng(seed)
    fit = rng.random((n, m)).astype(np.float32)
    fit[:, 0] = np.round(fit[:, 0], 2)  # per-objective ties
    fit[n // 3] = fit[0]  # a duplicate row
    return fit


# ------------------------------------------------------------- operators


def test_sbx_with_jax_draws():
    key = jax.random.PRNGKey(0)
    pop = np.random.default_rng(0).uniform(0, 10, (33, 7)).astype(np.float32)  # odd tail
    u = _np(jax.random.uniform(key, (16, 7)))
    want = _np(jax_sbx(key, jnp.asarray(pop)))
    got = simulated_binary(0, _t(pop), u=_t(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=POW_RTOL, atol=POW_ATOL)
    np.testing.assert_array_equal(got[-1].numpy(), pop[-1])


def test_polynomial_with_jax_draws():
    key = jax.random.PRNGKey(1)
    n, d = 64, 9
    lb = np.zeros(d, np.float32)
    ub = np.full(d, 10.0, np.float32)
    ub[0] = lb[0]  # a zero span
    pop = np.random.default_rng(1).uniform(0, 10, (n, d)).astype(np.float32)
    pop[:, 0] = 0.0
    k1, k2 = jax.random.split(key)
    pro_m = 3.0  # mutate more genes than the default 1/d
    site = _np(jax.random.uniform(k1, (n, d)) < (pro_m / d))
    u = _np(jax.random.uniform(k2, (n, d)))
    want = _np(jax_polynomial(key, jnp.asarray(pop), (jnp.asarray(lb), jnp.asarray(ub)), pro_m=pro_m))
    got = polynomial(0, _t(pop), (_t(lb), _t(ub)), pro_m=pro_m, site=_t(site), u=_t(u))
    assert site.any() and (got.numpy() != pop).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=POW_RTOL, atol=POW_ATOL)


@pytest.mark.parametrize("size", [2, 3])
def test_tournament_multifit_with_jax_contestants(size):
    """Lexicographic winner over (rank, -crowd) keys with ties in both keys
    and ±inf crowding: exact."""
    key = jax.random.PRNGKey(2)
    n = 200
    rng = np.random.default_rng(2)
    keys = np.stack([rng.integers(0, 4, n), -np.round(rng.random(n), 1)], axis=1).astype(np.float32)
    keys[::17, 1] = -np.inf
    pop = np.arange(n, dtype=np.float32)[:, None].repeat(3, axis=1)
    contestants = _np(jax.random.randint(key, (n, size), 0, n))
    want = _np(jax_tournament_multifit(key, jnp.asarray(pop), jnp.asarray(keys), tournament_size=size))
    got = tournament_multifit(0, _t(pop), _t(keys), tournament_size=size, contestants=_t(contestants))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_and_bitflip_with_jax_draws():
    """Exact: one add of the same noise, one select of the same flips."""
    key = jax.random.PRNGKey(9)
    pop = np.random.default_rng(9).normal(size=(20, 5)).astype(np.float32)
    noise = _np(jax.random.normal(key, (20, 5)))
    np.testing.assert_array_equal(
        gaussian(0, _t(pop), 0.3, noise=_t(noise)).numpy(),
        _np(jax_gaussian(key, jnp.asarray(pop), 0.3)))
    bits = (pop > 0).astype(np.float32)
    flip = _np(jax.random.bernoulli(key, 0.2, bits.shape))
    np.testing.assert_array_equal(bitflip(0, _t(bits), 0.2, flip=_t(flip)).numpy(),
                                  _np(jax_bitflip(key, jnp.asarray(bits), 0.2)))
    np.testing.assert_array_equal(bitflip(0, _t(bits > 0), 0.2, flip=_t(flip)).numpy(),
                                  _np(jax_bitflip(key, jnp.asarray(bits > 0), 0.2)))


def test_single_fitness_selection_with_jax_draws():
    """tournament, uniform_rand, select_rand_pbest and topk_fit, with JAX's
    draws handed over; exact (ties in the fitness included)."""
    key = jax.random.PRNGKey(10)
    n = 300
    rng = np.random.default_rng(10)
    pop = rng.normal(size=(n, 4)).astype(np.float32)
    fit = np.round(rng.random(n), 2).astype(np.float32)
    jpop, jfit = jnp.asarray(pop), jnp.asarray(fit)
    contestants = _np(jax.random.randint(key, (n, 3), 0, n))
    np.testing.assert_array_equal(
        tbasic.tournament(0, _t(pop), _t(fit), tournament_size=3, contestants=_t(contestants)).numpy(),
        _np(jbasic.tournament(key, jpop, jfit, tournament_size=3)))
    idx = _np(jax.random.randint(key, (50,), 0, n))
    np.testing.assert_array_equal(tbasic.uniform_rand(0, _t(pop), 50, idx=_t(idx)).numpy(),
                                  _np(jbasic.uniform_rand(key, jpop, 50)))
    choice = _np(jax.random.randint(key, (n,), 0, 30))
    np.testing.assert_array_equal(
        tbasic.select_rand_pbest(0, 0.1, _t(pop), _t(fit), choice=_t(choice)).numpy(),
        _np(jbasic.select_rand_pbest(key, 0.1, jpop, jfit)))
    t_pop, t_fit = tbasic.topk_fit(_t(pop), _t(fit), 40)
    j_pop, j_fit = jbasic.topk_fit(jpop, jfit, 40)
    np.testing.assert_array_equal(t_pop.numpy(), _np(j_pop))
    np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))
    # roulette: JAX's choice draw has no torch counterpart; the given draw
    # selects, and a drawn one favours low fitness
    np.testing.assert_array_equal(tbasic.roulette_wheel(0, _t(pop), _t(fit), idx=_t(idx)).numpy(),
                                  pop[idx])
    drawn = tbasic.roulette_wheel(0, _t(fit[:, None]), _t(fit), n=5000)
    assert float(drawn.mean()) < float(fit.mean())


@pytest.mark.parametrize("n,m", [(100, 3), (12, 2), (91, 5), (30, 8), (10, 10)])
def test_uniform_sampling_matches_jax(n, m):
    """Reference vectors, including the two-layer case (m = 8, 10): exact."""
    w, count = UniformSampling(n, m, device="cpu")()
    jw, jcount = JaxUniformSampling(n, m)()
    assert count == jcount
    np.testing.assert_array_equal(w.numpy(), _np(jw))


# ------------------------------------------------------------- selection


@pytest.mark.parametrize("masked", [False, True])
def test_crowding_distance_matches_jax(masked):
    fit = _mo_fitness(300, 3, 3)
    mask = np.random.default_rng(3).random(300) < 0.4 if masked else None
    want = _np(jnd.crowding_distance(jnp.asarray(fit), None if mask is None else jnp.asarray(mask)))
    got = crowding_distance(_t(fit), None if mask is None else _t(mask))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=CROWD_RTOL)


def _truncation_cases():
    x = np.linspace(0, 1, 600, dtype=np.float32)
    y = np.linspace(0, 1, 500, dtype=np.float32)
    return [
        # k above the Pallas block: JAX's kernel path takes its reference
        # top-k, as at NSGA-II's own shape (k = 10000)
        (_mo_fitness(3000, 3, 5), 1500),
        # many tiny fronts: a deep peel and a small cut front
        (np.stack([x, x**2], axis=1), 100),
        # one front: truncation is pure crowding selection
        (np.stack([y, 1 - y], axis=1), 100),
    ]


@pytest.mark.parametrize("case", range(3))
def test_rank_crowding_truncate_both_paths_match_jax(case):
    """The lexsort path gives JAX's order exactly; the partial-top-k path
    gives JAX's kernel-path order exactly, and the same survivor set (with
    the same per-survivor ranks) as the lexsort path."""
    fit, k = _truncation_cases()[case]
    tf, jf = _t(fit), jnp.asarray(fit)
    o_lex, r_lex = rank_crowding_truncate(tf, k)
    o_top, r_top = rank_crowding_truncate(tf, k, use_kernel=True)
    j_lex, jr_lex = jnd.rank_crowding_truncate(jf, k)
    j_top, jr_top = jnd.rank_crowding_truncate(jf, k, use_kernel=True)
    np.testing.assert_array_equal(o_lex.numpy(), _np(j_lex))
    np.testing.assert_array_equal(r_lex.numpy(), _np(jr_lex))
    np.testing.assert_array_equal(o_top.numpy(), _np(j_top))
    np.testing.assert_array_equal(r_top.numpy(), _np(jr_top))
    assert len(set(o_top.tolist())) == k
    assert set(o_top.tolist()) == set(o_lex.tolist())
    ranks = dict(zip(o_lex.tolist(), r_lex.tolist()))
    assert all(ranks[i] == r for i, r in zip(o_top.tolist(), r_top.tolist()))


def test_non_dominate_deduplicate_matches_jax():
    """``deduplicate``: repeats of a decision vector go to the back."""
    rng = np.random.default_rng(6)
    pop = rng.integers(0, 5, (120, 3)).astype(np.float32)  # many repeated rows
    fit = _mo_fitness(120, 2, 6)
    want = _np(jnd.non_dominate_indices(jnp.asarray(fit), 60, jnp.asarray(pop), deduplicate=True))
    got = non_dominate_indices(_t(fit), 60, _t(pop), deduplicate=True)
    np.testing.assert_array_equal(got.numpy(), want)
    j_pop, j_fit = jnd.non_dominate(jnp.asarray(pop), jnp.asarray(fit), 60)
    t_pop, t_fit = NonDominate(60)(_t(pop), _t(fit))
    np.testing.assert_array_equal(t_pop.numpy(), _np(j_pop))
    np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))


def test_non_dominate_deduplicate_nan_and_signed_zero_rows_match_jax():
    """``jnp.unique`` holds every NaN equal to every other (sign and
    payload aside) and ``-0.0`` equal to ``0.0``: repeated NaN rows, NaN
    rows with other payloads or signs, and ``±0.0`` rows give JAX's
    first-occurrence mask and survivors exactly."""
    bits = lambda b: np.array(b, dtype=np.uint32).view(np.float32)
    nan, quiet1, neg, signalling = np.nan, bits(0x7FC00001), bits(0xFFC00000), bits(0x7F800001)
    pop = np.array([[nan, 1], [nan, 1], [2, 1], [0, 3], [-0.0, 3], [quiet1, 1], [neg, 1],
                    [signalling, 1], [1, nan], [1, quiet1], [-0.0, -0.0], [0.0, 0.0],
                    [5, 5], [2, 1]], dtype=np.float32)
    n = pop.shape[0]
    _, idx = jnp.unique(jnp.asarray(pop), axis=0, size=n, return_index=True,
                        fill_value=jnp.nan)
    want_first = np.zeros(n, dtype=bool)
    want_first[_np(idx)] = True
    np.testing.assert_array_equal(tnd._first_occurrence(_t(pop)).numpy(), want_first)
    fit = _mo_fitness(n, 2, 11)
    for k in (4, 7, 10):
        want = _np(jnd.non_dominate_indices(jnp.asarray(fit), k, jnp.asarray(pop),
                                            deduplicate=True))
        got = non_dominate_indices(_t(fit), k, _t(pop), deduplicate=True)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- problem and metric


def test_lsmop1_matches_jax_at_full_width():
    """d 300, m 3: the subgroup cut, the linkage and the objectives."""
    jp, tp = JaxLSMOP1(d=300, m=3), LSMOP1(d=300, m=3, device="cpu")
    assert tp.sublen == jp.sublen and tp.group_start == jp.group_start
    lb, ub = tp.bounds()
    np.testing.assert_array_equal(lb.numpy(), _np(jp.bounds()[0]))
    np.testing.assert_array_equal(ub.numpy(), _np(jp.bounds()[1]))
    pop = (np.random.default_rng(7).random((64, 300)) * ub.numpy()).astype(np.float32)
    want, _ = jp.evaluate(None, jnp.asarray(pop))
    got, _ = tp.evaluate(None, _t(pop))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LSMOP_RTOL)
    np.testing.assert_array_equal(tp.pf().numpy(), _np(jp.pf()))


@pytest.mark.parametrize("k", range(1, 10))
def test_lsmop_suite_matches_jax(k):
    """The table-driven evaluator for every LSMOP (both linkages, all three
    front geometries) at d 60, and the fronts: to LSMOP_RTOL (the inner
    functions sum in another order than XLA's; Griewank's product and
    Ackley's exp too)."""
    name = f"LSMOP{k}"
    jp, tp = getattr(jnum, name)(d=60, m=3), getattr(tnum, name)(d=60, m=3, device="cpu")
    ub = tp.bounds()[1].numpy()
    pop = (np.random.default_rng(k).random((32, 60)) * ub).astype(np.float32)
    want, _ = jp.evaluate(None, jnp.asarray(pop))
    got, _ = tp.evaluate(None, _t(pop))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LSMOP_RTOL, atol=1e-6)
    np.testing.assert_allclose(tp.pf().numpy(), _np(jp.pf()), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["ZDT1", "ZDT2", "ZDT3", "ZDT4", "ZDT6"])
def test_zdt_suite_matches_jax(name):
    """Objectives to 1e-5 (float32 means, sqrt, sin) and fronts to one ulp
    of the linspace (ZDT3's non-dominated filter must keep the same
    points)."""
    jp, tp = getattr(jnum, name)(n_dim=10), getattr(tnum, name)(n_dim=10, device="cpu")
    pop = np.random.default_rng(0).random((64, 10)).astype(np.float32)
    if name == "ZDT4":
        pop[:, 1:] = pop[:, 1:] * 10 - 5
    want, _ = jp.evaluate(None, jnp.asarray(pop))
    got, _ = tp.evaluate(None, _t(pop))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.pf().numpy(), _np(jp.pf()), rtol=1e-6, atol=1e-7)


def test_igd_matches_jax():
    """IGD on ZDT1's front: a mean of float32 distances from a matrix
    product; rtol 1e-5."""
    objs = np.random.default_rng(8).random((150, 2)).astype(np.float32)
    pf = ZDT1(device="cpu").pf()
    # the two linspaces may round a point differently by one ulp
    np.testing.assert_allclose(pf.numpy(), _np(JaxZDT1().pf()), rtol=0, atol=6e-8)
    want = float(jax_igd(jnp.asarray(objs), JaxZDT1().pf()))
    np.testing.assert_allclose(float(igd(_t(objs), pf)), want, rtol=1e-5)


# ---------------------------------------------------- whole generations


def _jax_draws(jax_state_key, pop_size, dim):
    """The draws JAX's NSGA-II ask takes from its key (nsga2.py, mo/common.py,
    sbx.py, mutation/ops.py)."""
    _, k_mate, k_var = jax.random.split(jax_state_key, 3)
    contestants = jax.random.randint(k_mate, (pop_size, 2), 0, pop_size)
    k1, k2 = jax.random.split(k_var)
    u_sbx = jax.random.uniform(k1, (pop_size // 2, dim))
    kk1, kk2 = jax.random.split(k2)
    site = jax.random.uniform(kk1, (pop_size, dim)) < (1.0 / dim)
    u_pm = jax.random.uniform(kk2, (pop_size, dim))
    return {name: _t(v) for name, v in
            dict(contestants=contestants, u_sbx=u_sbx, site=site, u_pm=u_pm).items()}


def _inject(monkeypatch, draws):
    """Hand the JAX draws to the port's operators where NSGA-II calls them."""
    monkeypatch.setattr(mo_nsga2, "tournament_multifit",
                        functools.partial(tournament_multifit, contestants=draws["contestants"]))
    monkeypatch.setattr(mo_common, "simulated_binary",
                        functools.partial(simulated_binary, u=draws["u_sbx"]))
    monkeypatch.setattr(mo_common, "polynomial",
                        functools.partial(polynomial, site=draws["site"], u=draws["u_pm"]))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_one_generation_from_a_jax_state_matches(monkeypatch, use_kernel):
    """NSGA-II on LSMOP1 (d 30, m 3, pop 64): the port starts from JAX's
    state after init_tell (through interop), asks with JAX's draws, and both
    tells get the same fitness. Survivor fitness and ranks exact, crowd to
    CROWD_RTOL, population to the POW tolerance of the variation."""
    pop_size, d = 64, 30
    jprob = JaxLSMOP1(d=d, m=3)
    lb, ub = jprob.bounds()
    jalgo = JaxNSGA2(lb, ub, n_objs=3, pop_size=pop_size, use_kernel=use_kernel)
    talgo = NSGA2(_np(lb), _np(ub), n_objs=3, pop_size=pop_size, use_kernel=use_kernel,
                  device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(4))
    jstate = jit_once(jalgo, "init_tell")(jstate, jit_once(jprob, "evaluate")(None, jstate.population)[0])
    tstate = interop.nsga2_state(talgo, _numpy_tree(jstate))
    np.testing.assert_array_equal(tstate.rank.numpy(), _np(jstate.rank))

    draws = _jax_draws(jstate.key, pop_size, d)
    j_off, jstate = jit_once(jalgo, "ask")(jstate)
    _inject(monkeypatch, draws)
    t_off, tstate = talgo.ask(tstate)
    np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)

    fit = _np(jit_once(jprob, "evaluate")(None, j_off)[0])
    jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
    tstate = talgo.tell(tstate, _t(fit))
    np.testing.assert_array_equal(tstate.fitness.numpy(), _np(jstate.fitness))
    np.testing.assert_array_equal(tstate.rank.numpy(), _np(jstate.rank))
    np.testing.assert_allclose(tstate.crowd.numpy(), _np(jstate.crowd), rtol=CROWD_RTOL)
    np.testing.assert_allclose(tstate.population.numpy(), _np(jstate.population),
                               rtol=POW_RTOL, atol=POW_ATOL)


def test_migrate_matches_jax():
    """GA-skeleton migration: migrants merged and truncated by (rank,
    crowding), NSGA-II's mating keys refreshed. Population, fitness and
    ranks exact; crowd to CROWD_RTOL."""
    pop_size, d = 48, 10
    lb, ub = np.zeros(d, np.float32), np.ones(d, np.float32)
    jalgo = JaxNSGA2(jnp.asarray(lb), jnp.asarray(ub), n_objs=2, pop_size=pop_size)
    talgo = NSGA2(lb, ub, n_objs=2, pop_size=pop_size, device="cpu")
    jprob = JaxZDT1(n_dim=d)
    jstate = jalgo.init(jax.random.PRNGKey(6))
    jstate = jit_once(jalgo, "init_tell")(jstate, jit_once(jprob, "evaluate")(None, jstate.population)[0])
    tstate = interop.nsga2_state(talgo, _numpy_tree(jstate))
    migrants = np.random.default_rng(6).random((16, d)).astype(np.float32)
    m_fit = _np(jit_once(jprob, "evaluate")(None, jnp.asarray(migrants))[0])
    jstate = jalgo.migrate(jstate, jnp.asarray(migrants), jnp.asarray(m_fit))
    tstate = talgo.migrate(tstate, _t(migrants), _t(m_fit))
    np.testing.assert_array_equal(tstate.population.numpy(), _np(jstate.population))
    np.testing.assert_array_equal(tstate.fitness.numpy(), _np(jstate.fitness))
    np.testing.assert_array_equal(tstate.rank.numpy(), _np(jstate.rank))
    np.testing.assert_allclose(tstate.crowd.numpy(), _np(jstate.crowd), rtol=CROWD_RTOL)


def test_slice_nsga2_lsmop1_workflow_matches_jax(monkeypatch):
    """The slice as a whole: StdWorkflow(NSGA2(use_kernel=True), LSMOP1)
    on both sides, d 300, m 3, pop 32; the port takes JAX's workflow state
    after the first (init) step, then runs two generations with JAX's
    draws and its own LSMOP1. Survivor ranks exact; fitness to LSMOP_RTOL
    and an absolute 1e-5: each side evaluates its own offspring, which
    differ by the variation's ulps (POW_RTOL of genes up to 10), and an
    objective near 0 keeps that error in absolute terms."""
    pop_size, d = 32, 300
    jprob = JaxLSMOP1(d=d, m=3)
    lb, ub = jprob.bounds()
    jwf = JaxStdWorkflow(JaxNSGA2(lb, ub, n_objs=3, pop_size=pop_size, use_kernel=True), jprob)
    twf = StdWorkflow(NSGA2(_np(lb), _np(ub), n_objs=3, pop_size=pop_size, use_kernel=True,
                            device="cpu"),
                      LSMOP1(d=d, m=3, device="cpu"), device="cpu")
    jstate = jwf.step(jwf.init(jax.random.PRNGKey(5)))
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    assert tstate.generation == 1 and tstate.first_step is False
    for _ in range(2):
        _inject(monkeypatch, _jax_draws(jstate.algo.key, pop_size, d))
        jstate = jwf.step(jstate)
        tstate = twf.step(tstate)
        np.testing.assert_array_equal(tstate.algo.rank.numpy(), _np(jstate.algo.rank))
        np.testing.assert_allclose(tstate.algo.fitness.numpy(), _np(jstate.algo.fitness),
                                   rtol=LSMOP_RTOL, atol=1e-5)
    assert tstate.generation == int(jstate.generation) == 3


@pytest.mark.parametrize("use_kernel", [False, True])
def test_nsga2_converges_on_zdt1(use_kernel):
    """The convergence gate: NSGA-II on ZDT1 (d 12, pop 100, 200
    generations) reaches IGD < 0.1 on three seeds, on both truncation
    paths. The port's IGDs (torch 2.13 on the CPU): lexsort path 0.0059,
    0.0069, 0.0069; partial-top-k path 0.0057, 0.0064, 0.0072 for seeds
    0, 1, 2. (The JAX package reaches 0.086-0.093 at 100 generations.)"""
    d = 12
    for seed in range(3):
        algo = NSGA2(torch.zeros(d), torch.ones(d), n_objs=2, pop_size=100,
                     use_kernel=use_kernel, device="cpu")
        prob = ZDT1(n_dim=d, device="cpu")
        wf = StdWorkflow(algo, prob, device="cpu")
        state = wf.run(wf.init(seed), 200)
        fit = state.algo.fitness
        assert torch.isfinite(fit).all()
        assert float(igd(fit, prob.pf())) < 0.1, seed


def test_init_population_draw_and_launch_counters_on_the_cpu(monkeypatch):
    """The uniform_init draw sits behind ``_init_population``; on the CPU no
    kernel launches."""
    algo = NSGA2(torch.zeros(4), torch.ones(4), n_objs=2, pop_size=8, device="cpu")
    fixed = torch.rand(8, 4, generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(algo, "_init_population", lambda seed: fixed)
    assert torch.equal(algo.init(0).population, fixed)
    launches = (tdom.packed_dominance.launches, ttopk.partial_topk.launches)
    wf = StdWorkflow(NSGA2(torch.zeros(4), torch.ones(4), n_objs=2, pop_size=8, use_kernel=True,
                           device="cpu"), ZDT1(n_dim=4, device="cpu"), device="cpu")
    wf.run(wf.init(0), 3)
    assert (tdom.packed_dominance.launches, ttopk.partial_topk.launches) == launches


def test_mo_deferred_arguments_raise():
    """The mesh is ported: NSGA-II on an 8-shard CPU mesh (the row-sharded
    sort in its tell, one B3 rows launch a shard on the card) runs the
    unsharded workflow's states bit for bit, and ``NonDominate`` with a
    mesh keeps the same survivors."""
    from evox_tpu_torch.core.distributed import create_mesh

    mesh = create_mesh(devices=["cpu"] * 8)
    runs = []
    for m in (mesh, None):
        algo = NSGA2(torch.zeros(8), torch.ones(8), n_objs=2, pop_size=100, mesh=m, device="cpu")
        wf = StdWorkflow(algo, ZDT1(n_dim=8, device="cpu"), device="cpu")
        runs.append(wf.run(wf.init(4), 5).algo)
    assert torch.equal(runs[0].population, runs[1].population)
    assert torch.equal(runs[0].fitness, runs[1].fitness)
    fit = torch.rand(60, 2, generator=torch.Generator().manual_seed(1))
    pop = torch.rand(60, 3, generator=torch.Generator().manual_seed(2))
    got, want = NonDominate(30, mesh=mesh)(pop, fit), NonDominate(30)(pop, fit)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
