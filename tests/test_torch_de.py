"""The DE family of the port against the JAX package, on the CPU: DE (rand
and best, one and two difference vectors, reflect), ODE, CoDE, SaDE, JaDE
(with and without its archive) and SHADE, each compared field by field
over sixteen generations with JAX's draws handed to the port (``algo._draw``,
rebuilt from the JAX key as each JAX module splits it) and the state
carried across through ``interop.de_state`` every generation; the
operators of ``de_ops``, ``select_rand_indices``' distribution, the
attribution helpers, the pbest cut on ``partial_topk`` against a stable
argsort, and the convergence gates of ``tests/test_so_de.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so import de as jde
from evox_tpu.algorithms.so.de import de as jde_module
from evox_tpu.core import attribution as jattr
from evox_tpu.operators.crossover import de_ops as jops
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so import de as tde
from evox_tpu_torch.algorithms.so.de import common as tcommon
from evox_tpu_torch.algorithms.so.de.shade import pbest_k
from evox_tpu_torch.core import attribution as tattr
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.operators.crossover import de_ops as tops
from evox_tpu_torch.problems.numerical import Sphere

from _torch_mo_draws import choice_uniform

# The trials, the selection, the archive, the attribution and every draw-fed
# parameter are elementwise float32 on the same inputs: exact. The float sums
# over the population are not: JaDE's Lehmer and arithmetic means (mu_F,
# mu_CR), SHADE's weighted means (M_F, M_CR), SaDE's CR memory and its
# probabilities' normalising sum; XLA and PyTorch add in other orders, an ulp
# or so of values <= 1 over pop 16: 2e-6 relative and 1e-6 absolute.
SUM_FIELDS = {"mu_F", "mu_CR", "M_F", "M_CR", "CRm", "probs"}
RTOL, ATOL = 2e-6, 1e-6

DIM, POP, GENS = 5, 16, 16
LB, UB = -5.0 * np.ones(DIM, np.float32), 5.0 * np.ones(DIM, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mutate_draws(key, n, count, d):
    """DE._mutate's draws (de.py)."""
    k_idx, k_cr, k_j = jax.random.split(key, 3)
    return {"idx": _t(jde_module.select_rand_indices(k_idx, n, count)),
            "u_cr": _t(jax.random.uniform(k_cr, (n, d))),
            "j_rand": _t(jax.random.randint(k_j, (n, 1), 0, d))}


def _de_draws(jalgo, key):
    _, k = jax.random.split(key)
    return _mutate_draws(k, jalgo.pop_size, 2 * jalgo.n_diff + 1, jalgo.dim)


def _ode_draws(jalgo, key):
    _, k_jump, k_mut = jax.random.split(key, 3)
    return {**_mutate_draws(k_mut, jalgo.pop_size, 2 * jalgo.n_diff + 1, jalgo.dim),
            "u_jump": _t(jax.random.uniform(k_jump))}


def _code_draws(jalgo, key):
    n, d = jalgo.pop_size, jalgo.dim
    _, k_idx, k_par, k_cr, k_j, k_rec = jax.random.split(key, 6)
    return {"idx": _t(jde_module.select_rand_indices(k_idx, n, 5)),
            "pool_rows": _t(jax.random.randint(k_par, (3, n), 0, 3)),
            "u_rec": _t(jax.random.uniform(k_rec, (n, 1))),
            "u_cr": _t(jax.random.uniform(k_cr, (2, n, d))),
            "j_rand": _t(jax.random.randint(k_j, (2, n, 1), 0, d))}


def _sade_draws(jalgo, key):
    n, d = jalgo.pop_size, jalgo.dim
    _, ks, kF, kCR, ki, kcr, kj, krec = jax.random.split(key, 8)
    return {"u_strategy": choice_uniform(ks, (n,)),
            "z_F": _t(jax.random.normal(kF, (n, 1))),
            "z_CR": _t(jax.random.normal(kCR, (n, 1))),
            "idx": _t(jde_module.select_rand_indices(ki, n, 5)),
            "u_rec": _t(jax.random.uniform(krec, (n, 1))),
            "u_cr": _t(jax.random.uniform(kcr, (n, d))),
            "j_rand": _t(jax.random.randint(kj, (n, 1), 0, d))}


def _slots(key, n):
    """The tell's archive slots, from the key the ask leaves."""
    _, k_arch = jax.random.split(key)
    return _t(jax.random.randint(k_arch, (n,), 0, n))


def _jade_draws(jalgo, key):
    n, d = jalgo.pop_size, jalgo.dim
    key, kF, kCR, kp, k1, k2, kcr, kj = jax.random.split(key, 8)
    return {"cauchy": _t(jax.random.cauchy(kF, (n,))),
            "z_CR": _t(jax.random.normal(kCR, (n,))),
            "pbest_pick": _t(jax.random.randint(kp, (n,), 0, jalgo.p_num)),
            "r1": _t(jde_module.select_rand_indices(k1, n, 1)[:, 0]),
            "r2_raw": _t(jax.random.randint(k2, (n,), 0, 2 * n)),
            "u_cr": _t(jax.random.uniform(kcr, (n, d))),
            "j_rand": _t(jax.random.randint(kj, (n, 1), 0, d)),
            "slots": _slots(key, n)}


def _shade_draws(jalgo, key):
    n, d = jalgo.pop_size, jalgo.dim
    key, kh, kF, kCR, kp, k1, k2, kcr, kj, kpb = jax.random.split(key, 10)
    return {"h": _t(jax.random.randint(kh, (n,), 0, jalgo.H)),
            "cauchy": _t(jax.random.cauchy(kF, (n,))),
            "z_CR": _t(jax.random.normal(kCR, (n,))),
            "p": _t(jax.random.uniform(kpb, (n,), minval=2.0 / n, maxval=0.2)),
            "u_pbest": _t(jax.random.uniform(kp, (n,))),
            "r1": _t(jde_module.select_rand_indices(k1, n, 1)[:, 0]),
            "r2_raw": _t(jax.random.randint(k2, (n,), 0, 2 * n)),
            "u_cr": _t(jax.random.uniform(kcr, (n, d))),
            "j_rand": _t(jax.random.randint(kj, (n, 1), 0, d)),
            "slots": _slots(key, n)}


# name: (class, kwargs, JAX's draws of a generation)
CASES = {
    "de_rand": ("DE", dict(pop_size=POP), _de_draws),
    "de_best_2": ("DE", dict(pop_size=POP, base_vector="best", num_difference_vectors=2), _de_draws),
    "de_reflect": ("DE", dict(pop_size=POP, differential_weight=1.5, bound_handling="reflect"),
                   _de_draws),
    "ode": ("ODE", dict(pop_size=POP, jumping_rate=0.5), _ode_draws),
    "code": ("CoDE", dict(pop_size=POP), _code_draws),
    # learning period 2: the probabilities and the CR memory adapt from gen 2
    "sade": ("SaDE", dict(pop_size=POP, learning_period=2), _sade_draws),
    "jade": ("JaDE", dict(pop_size=POP, p_best=0.2), _jade_draws),
    "jade_no_archive": ("JaDE", dict(pop_size=POP, use_archive=False), _jade_draws),
    "shade": ("SHADE", dict(pop_size=POP, memory_size=3), _shade_draws),
}


def _first_fitness(n):
    """The first evaluation's fitness: ties (most rows at 1e6, so the next
    generations succeed often and the archive fills), zeros of both signs,
    infinities and NaNs of both signs with other payloads (a NaN incumbent
    is never replaced: it stays in the pbest key of every generation)."""
    f = np.full(n, 1e6, np.float32)
    f[[4, 6, 8]] = [40.0, 80.0, 40.0]
    f[[1, 5]] = -0.0
    bits = np.array([0x7FC00000, 0xFFC00001, 0x7F800123], dtype=np.uint32).view(np.float32)
    f[[2, 9, 12]] = bits
    f[[3, 14]] = [-np.inf, np.inf]  # row 14's trials are NaN: an inf gain would poison SHADE's means
    return f


def _fitness(cand):
    """A shifted Sphere on a coarse grid (ties among trials and with the
    incumbents); every seventh row NaN (CoDE folds NaN trials by argmin)."""
    x = np.asarray(cand, np.float64)
    f = np.round(np.sum((x - 0.7) ** 2, axis=1) * 8.0).astype(np.float32)
    f[::7] = np.nan
    return f


def _assert_field(ours, theirs, name):
    if dataclasses.is_dataclass(ours):
        for f in dataclasses.fields(ours):
            _assert_field(getattr(ours, f.name), getattr(theirs, f.name), f"{name}.{f.name}")
    elif isinstance(ours, int):
        assert ours == int(np.asarray(theirs)), name
    elif name in SUM_FIELDS:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:  # exact, by value (NaNs where JAX has them)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=name)


def _assert_states(tstate, jstate):
    names = [f.name for f in dataclasses.fields(tstate) if hasattr(jstate, f.name)]
    assert "attrib" in names and "population" in names
    for name in names:
        _assert_field(getattr(tstate, name), getattr(jstate, name), name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_de_family_generations_match_jax(case):
    name, kwargs, jax_draws = CASES[case]
    jalgo = getattr(jde, name)(LB, UB, **kwargs)
    talgo = getattr(tde, name)(LB, UB, **kwargs, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(3))
    jcand, jstate = jalgo.init_ask(jstate)
    fit = _first_fitness(POP)
    jstate = jalgo.init_tell(jstate, jnp.asarray(fit))
    for gen in range(GENS):
        tstate = interop.de_state(talgo, jax.tree.map(np.asarray, jstate), seed=gen)
        _assert_states(tstate, jstate)
        draws = jax_draws(jalgo, jstate.key)
        talgo._draw = lambda seed, draws=draws: draws
        jcand, jstate = jalgo.ask(jstate)
        tcand, tstate = talgo.ask(tstate)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
        fit = _fitness(jcand)
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, torch.from_numpy(fit))
        _assert_states(tstate, jstate)
    if name in ("JaDE", "SHADE") and kwargs.get("use_archive", True):
        assert int(jstate.archive_size) == POP  # the archive filled: its random slots ran


def test_code_argmin_and_min_match_jax_on_ties_and_nan():
    """CoDE folds its trials with ``torch.argmin``/``torch.amin`` over the
    strategy axis: the first minimum, a NaN counting as the minimum."""
    nan, inf = np.nan, np.inf
    fit = np.array([[1.0, 2.0, nan, 0.0, -0.0, nan, inf, 3.0],
                    [1.0, 1.0, 2.0, -0.0, 0.0, 1.0, inf, nan],
                    [0.5, 2.0, nan, 0.0, -1.0, nan, -inf, nan]], np.float32)
    t = torch.from_numpy(fit)
    np.testing.assert_array_equal(torch.argmin(t, dim=0).numpy(), np.asarray(jnp.argmin(fit, axis=0)))
    np.testing.assert_array_equal(torch.amin(t, dim=0).numpy(), np.asarray(jnp.min(fit, axis=0)))


@pytest.mark.parametrize("pop,n", [(5, 2), (6, 5), (2, 1)])
def test_select_rand_indices_distribution(pop, n):
    """Every row's picks are distinct and never the row itself, and every
    ordered tuple of other rows is equally likely (JAX's distribution: a
    choice without replacement over the other rows)."""
    draws = torch.stack([tde.select_rand_indices(s, pop, n, device="cpu") for s in range(3000)])
    assert draws.shape == (3000, pop, n) and draws.dtype == torch.int64
    rows = torch.arange(pop)[None, :, None]
    assert bool((draws != rows).all())
    assert bool((torch.sort(draws, dim=2).values.diff(dim=2) > 0).all())
    tuples = np.prod(range(pop - n, pop))  # ordered n-tuples of the pop - 1 others
    for i in range(pop):
        _, counts = np.unique(draws[:, i].numpy(), axis=0, return_counts=True)
        assert len(counts) == tuples
        expect = 3000 / tuples
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        assert chi2 < tuples + 6 * np.sqrt(2 * tuples) + 10, (i, chi2)
    jax_draw = np.asarray(jde_module.select_rand_indices(jax.random.PRNGKey(0), pop, n))
    assert jax_draw.shape == (pop, n)  # the same contract, the port's own values


def test_de_ops_match_jax():
    rng = np.random.default_rng(0)
    n, d, padding = 12, 6, 5
    pop = rng.normal(size=(n, d)).astype(np.float32)
    mutant = rng.normal(size=(n, d)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    index = jnp.arange(n)
    want_sum, want_idx = jops.de_diff_sum(key, padding, jnp.asarray(2), index, jnp.asarray(pop))
    choices = _t(jax.random.randint(key, (n, padding), 0, n - 1))
    got_sum, got_idx = tops.de_diff_sum(0, padding, 2, torch.arange(n), torch.from_numpy(pop),
                                        random_choices=choices)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    # a sum of four signed rows: XLA and PyTorch may add them in other orders
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), rtol=1e-6, atol=1e-6)
    k1, k2 = jax.random.split(key)
    u, jrand = _t(jax.random.uniform(k1, (n, d))), _t(jax.random.randint(k2, (n,), 0, d))
    for cr in (0.3, np.linspace(0.0, 1.0, n).astype(np.float32)):
        want = jops.de_bin_cross(key, jnp.asarray(mutant), jnp.asarray(pop), cr)
        got = tops.de_bin_cross(0, torch.from_numpy(mutant), torch.from_numpy(pop), cr, u=u, jrand=jrand)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        start = _t(jax.random.randint(k1, (n, 1), 0, d))
        ue = _t(jax.random.uniform(k2, (n, 1), minval=1e-12, maxval=1.0))
        want = jops.de_exp_cross(key, jnp.asarray(mutant), jnp.asarray(pop), cr)
        got = tops.de_exp_cross(0, torch.from_numpy(mutant), torch.from_numpy(pop), cr, start=start, u=ue)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jops.de_arith_recom(jnp.asarray(mutant), jnp.asarray(pop), 0.4)
    got = tops.de_arith_recom(torch.from_numpy(mutant), torch.from_numpy(pop), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p3 = rng.normal(size=(n, d)).astype(np.float32)
    want = jops.DifferentialEvolve(0.7, 0.6)(key, *(jnp.asarray(a) for a in (pop, mutant, p3)))
    got = tops.DifferentialEvolve(0.7, 0.6)(0, *(torch.from_numpy(a) for a in (pop, mutant, p3)),
                                            u=u, jrand=jrand)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attribution_helpers_match_jax():
    assert (tattr.OP_NAMES, tattr.N_OPS, tattr.SADE_STRATEGY_TAGS, tattr.CODE_STRATEGY_TAGS) == (
        jattr.OP_NAMES, jattr.N_OPS, jattr.SADE_STRATEGY_TAGS, jattr.CODE_STRATEGY_TAGS)
    for base, n_diff in (("best", 1), ("rand", 1), ("rand", 2), ("rand", 3)):
        assert tattr.de_variant_tag(base, n_diff) == jattr.de_variant_tag(base, n_diff)
    rng = np.random.default_rng(1)
    n = 40
    prev = rng.normal(size=n).astype(np.float32)
    prev[[0, 3]] = [np.inf, np.nan]
    new = (prev + rng.normal(size=n)).astype(np.float32)
    new[5] = np.nan
    values = rng.uniform(size=n).astype(np.float32)
    strategy = rng.integers(0, 4, n)
    tags = rng.integers(0, tattr.N_OPS, n).astype(np.int32)
    T = lambda a: torch.from_numpy(np.array(a))
    for op_tag, parent in ((tattr.OP_DE_RAND_1, None), (tags, rng.permutation(n).astype(np.int32))):
        want = jattr.slot_attribution(jnp.asarray(new), jnp.asarray(prev), op_tag,
                                      None if parent is None else jnp.asarray(parent))
        got = tattr.slot_attribution(T(new), T(prev), T(op_tag) if isinstance(op_tag, np.ndarray)
                                     else op_tag, None if parent is None else T(parent))
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)))
        for j, t in zip(jattr.op_credit(want), tattr.op_credit(got)):
            # the improvement sums over a tag's slots: another order, an ulp
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    success = new < prev
    for j, t in zip(jattr.strategy_success_counts(jnp.asarray(success), jnp.asarray(strategy), 4),
                    tattr.strategy_success_counts(T(success), T(strategy), 4)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # float sums over the population: another order, an ulp of values <= n
    np.testing.assert_allclose(
        tattr.lehmer_mean_of_successful(T(values), T(success)).numpy(),
        np.asarray(jattr.lehmer_mean_of_successful(jnp.asarray(values), jnp.asarray(success))), rtol=1e-6)
    count = int(success.sum())
    np.testing.assert_allclose(
        tattr.arithmetic_mean_of_successful(T(values), T(success), torch.tensor(count)).numpy(),
        np.asarray(jattr.arithmetic_mean_of_successful(jnp.asarray(values), jnp.asarray(success),
                                                       jnp.asarray(count))), rtol=1e-6)
    order = rng.permutation(n).astype(np.int32)
    np.testing.assert_array_equal(tattr.argsort_inverse(T(order)).numpy(),
                                  np.asarray(jattr.argsort_inverse(jnp.asarray(order))))
    empty = tattr.Attribution.empty(n, torch.device("cpu"))
    for f in dataclasses.fields(empty):
        np.testing.assert_array_equal(getattr(empty, f.name).numpy(),
                                      np.asarray(getattr(jattr.Attribution.empty(n), f.name)))

    @dataclasses.dataclass
    class Wrapper:
        inner: object

    state = tde.DE(LB, UB, 4, device="cpu").init(0)
    assert tattr.find_attribution(Wrapper(Wrapper(state))) is state.attrib
    assert tattr.find_attribution(Wrapper(None)) is None


def _adversarial_keys():
    """Fitness vectors where argsort's ties and B4's total order part ways
    unless the key is canonical: ties, zeros of both signs, infinities, NaNs
    of both signs and several payloads."""
    nan_bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7FC0BEEF],
                        dtype=np.uint32).view(np.float32)
    rng = np.random.default_rng(5)
    out = []
    for n in (7, 64, 1000):
        f = np.round(rng.normal(size=n) * 2).astype(np.float32)
        f[rng.random(n) < 0.2] = -0.0
        f[rng.random(n) < 0.05] = np.inf
        f[rng.random(n) < 0.05] = -np.inf
        sites = rng.random(n) < 0.15
        f[sites] = rng.choice(nan_bits, int(sites.sum()))
        out.append(f)
    out.append(np.array([0.0, -0.0, np.nan, -np.nan, 0.0, -0.0], np.float32))
    return out


@pytest.mark.parametrize("case", range(4))
def test_pbest_cut_equals_stable_argsort(case):
    """JaDE's and SHADE's cut, ``partial_topk`` on ``sort_key``, gives
    ``jnp.argsort(fitness)[:k]`` for every k, whatever the input."""
    f = _adversarial_keys()[case]
    want = np.asarray(jnp.argsort(jnp.asarray(f)))
    for k in sorted({1, 2, len(f) // 5 + 1, len(f) // 2, len(f)}):
        np.testing.assert_array_equal(tcommon.pbest_cut(torch.from_numpy(f), k).numpy(), want[:k])
    # the key itself: one +0.0 and one positive NaN, order otherwise untouched
    key = tcommon.sort_key(torch.from_numpy(f)).numpy()
    assert not np.signbit(key[(key == 0) | np.isnan(key)]).any()
    np.testing.assert_array_equal(key[~np.isnan(f)], f[~np.isnan(f)])


@pytest.mark.parametrize("n", [10, 100, 1000, 4096, 10000])
def test_shade_pbest_k_holds_the_largest_drawable_rank(n):
    """``pbest_k(n)`` holds every rank SHADE can draw: p at the top of JAX's
    uniform on [2/n, 0.2) (and one ulp above float32(0.2)), u just below 1.
    The gather of the cut at that rank equals the stable argsort's."""
    lo, hi = np.float32(2.0 / n), np.float32(0.2)
    span = hi - lo
    u_max = np.float32(1.0) - np.float32(2.0**-24)
    p_top = np.float32(np.float32(span * u_max) + lo)  # JAX's uniform at its largest float
    p_cases = np.array([p_top, hi, np.nextafter(hi, np.float32(1.0))], np.float32)
    jax_top = float(jax.random.uniform(jax.random.PRNGKey(0), (), minval=2.0 / n, maxval=0.2))
    assert jax_top <= p_cases.max()
    k = pbest_k(n)
    assert k <= int(hi * np.float32(n)) + 1
    algo = tde.SHADE(np.zeros(2), np.ones(2), n, device="cpu")
    assert algo.pbest_k == k
    fitness = np.round(np.random.default_rng(n).normal(size=n) * 3).astype(np.float32)
    fitness[::7] = -0.0
    order = np.asarray(jnp.argsort(jnp.asarray(fitness)))
    p = torch.from_numpy(p_cases)
    u = torch.full((3,), float(u_max))
    p_num = np.maximum(1, (p_cases * np.float32(n)).astype(np.int32))
    rank = (np.float32(u_max) * p_num.astype(np.float32)).astype(np.int32)
    assert rank.max() < k and rank.max() == p_num.max() - 1
    got = algo.pbest_indices(torch.from_numpy(fitness), p, u)
    np.testing.assert_array_equal(got.numpy(), order[rank])


@pytest.mark.parametrize("n", range(2, 10))
def test_shade_pbest_at_small_pop_draws_jaxs_p_and_rows(n):
    """Below n 10, 2/n > 0.2 and JAX's clamped uniform makes every p equal
    float32(2/n), so p_num is 2. JAX's p and u_pbest handed to the port's
    ``pbest_indices`` give JAX's pbest rows; the port's own draw gives p_num
    2 (and ``pbest_k`` 2); JAX's whole ask on its draws equals the port's."""
    assert pbest_k(n) == 2
    jalgo = jde.SHADE(LB, UB, pop_size=n, memory_size=3)
    talgo = tde.SHADE(LB, UB, pop_size=n, memory_size=3, device="cpu")
    assert talgo.pbest_k == 2
    jstate = jalgo.init(jax.random.PRNGKey(n))
    fitness = np.round(np.random.default_rng(n).normal(size=n) * 2).astype(np.float32)
    jstate = jalgo.init_tell(jstate, jnp.asarray(fitness))
    draws = _shade_draws(jalgo, jstate.key)
    p = draws["p"].numpy()
    assert (p == np.float32(2.0 / n)).all()
    # JAX's pbest rows, as its ask computes them
    p_num = jnp.maximum(1, (jnp.asarray(p) * n).astype(jnp.int32))
    rank = (jnp.asarray(draws["u_pbest"].numpy()) * p_num).astype(jnp.int32)
    want = np.asarray(jnp.argsort(jnp.asarray(fitness))[rank])
    assert (np.asarray(p_num) == 2).all()
    got = talgo.pbest_indices(torch.from_numpy(fitness), draws["p"], draws["u_pbest"])
    np.testing.assert_array_equal(got.numpy(), want)
    tstate = interop.de_state(talgo, jax.tree.map(np.asarray, jstate))
    talgo._draw = lambda seed: draws
    jcand, _ = jalgo.ask(jstate)
    tcand, _ = talgo.ask(tstate)
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
    own = tde.SHADE.__dict__["_draw"](talgo, 5)["p"]
    assert (own == np.float32(2.0 / n)).all()
    assert ((own * n).to(torch.int32) == 2).all()


def _best(algo, steps, seed=11):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, Sphere(), monitors=[mon], device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


T_LB, T_UB = torch.full((5,), -10.0), torch.full((5,), 10.0)
# tests/test_so_de.py's gates (Sphere, d 5, pop 100)
GATES = {
    "de_rand": (lambda: tde.DE(T_LB, T_UB, 100, device="cpu"), 100),
    "de_best": (lambda: tde.DE(T_LB, T_UB, 100, base_vector="best", device="cpu"), 60),
    "ode": (lambda: tde.ODE(T_LB, T_UB, 100, device="cpu"), 100),
    "code": (lambda: tde.CoDE(T_LB, T_UB, 100, device="cpu"), 60),
    "jade": (lambda: tde.JaDE(T_LB, T_UB, 100, device="cpu"), 60),
    "sade": (lambda: tde.SaDE(T_LB, T_UB, 100, device="cpu"), 60),
    "shade": (lambda: tde.SHADE(T_LB, T_UB, 100, device="cpu"), 60),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_de_family_converges_on_sphere(case):
    make, steps = GATES[case]
    assert _best(make(), steps) < 0.1


def test_de_family_entry_points_refuse_a_missing_cuda(monkeypatch):
    """device=None means cuda: without a card every new entry point raises,
    and with device="cpu" each builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tde.DE, tde.ODE, tde.CoDE, tde.SaDE, tde.JaDE, tde.SHADE):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(LB, UB, 8)
        cls(LB, UB, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.select_rand_indices(0, 8, 2)
