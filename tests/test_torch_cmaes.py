"""The CMA-ES family of the port and its shared ES helpers against the JAX
package, on the CPU: ``common.py``'s helpers (``safe_eigh`` by its
invariants), ClipUp, CMAES, SepCMAES, the restart variants and the driver,
and the slice as a whole, a ``StdWorkflow(CMAES)`` against JAX's. JAX's
draws and JAX's ``(B, D)`` are handed to the port by replacing its draw and
decomposition methods."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import cma_es as jcma
from evox_tpu.algorithms.so.es import common as jcommon
from evox_tpu.monitors import EvalMonitor as JaxEvalMonitor
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu.utils.optimizers import clipup
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.es import cma_es as tcma
from evox_tpu_torch.algorithms.so.es import common as tcommon
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.utils.optimizers import ClipUp, make_optimizer

# A CMA-ES generation is float32 products over pop and dim (d 10 here) that
# XLA and PyTorch sum in other orders: ~1 ulp a sum, a few per field, and a
# few generations of compounding (sigma multiplies, C accumulates). 1e-5
# relative and 1e-6 absolute hold every field with a margin of ~10 over
# what the runs below reach.
RTOL, ATOL = 1e-5, 1e-6


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_states(tstate, jstate, rtol=RTOL, atol=ATOL):
    for f in dataclasses.fields(tstate):
        if not hasattr(jstate, f.name):
            continue  # the keys: the port holds seeds
        ours, theirs = getattr(tstate, f.name), np.asarray(getattr(jstate, f.name))
        if isinstance(ours, int):
            assert ours == int(theirs), f.name
        elif ours.dtype.is_floating_point:
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=rtol, atol=atol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f.name)


def _tied_sphere(pop):
    """Sphere on a coarse grid: tied fitness, so the stable sort shows."""
    return np.round(np.sum(np.asarray(pop) ** 2, axis=1) / 4.0).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ------------------------------------------------------------ common.py


@pytest.mark.parametrize("mu,mu_half", [(1, None), (3, None), (12, 12.5), (8, 9.0), (500, None),
                                        (500000, None)])
def test_recombination_weights_match_jax(mu, mu_half):
    """Both compute log1p, log, logsumexp and exp in float32 in one order,
    but XLA's CPU log1p and log are not PyTorch's: they differ by an ulp,
    and log near 1 (the last ranks' raw weights) amplifies that to a few.
    Both land equally far from the float64 weights, so the port is held to
    be as accurate as JAX (at most one ulp further from float64's weights)
    and within 32 ulps of JAX's, about 4e-6 relative; mueff, a ratio of
    float32 sums, within 1e-6 relative."""
    want = np.asarray(jcommon.recombination_weights(mu, mu_half))
    got = tcommon.recombination_weights(mu, mu_half)
    assert got.dtype == torch.float32 and got.shape == (mu,)
    r = np.arange(1, mu + 1, dtype=np.float64)
    raw = np.log1p(((mu + 0.5 if mu_half is None else mu_half) - r) / r)
    exact = (raw / raw.sum()).astype(np.float32)
    assert _ulps(got.numpy(), exact).max() <= _ulps(want, exact).max() + 1
    assert _ulps(got.numpy(), want).max() <= 32
    jw = jnp.asarray(want)
    want_me = float(jnp.sum(jw) ** 2 / jnp.sum(jw**2))
    assert tcommon.mueff_of(got) == pytest.approx(want_me, rel=1e-6)


@pytest.mark.parametrize("lam,mu,prefactor", [(16, None, False), (100, 10, False), (31, None, True),
                                              (8, 4, True)])
def test_capped_mu_weights_match_jax(lam, mu, prefactor):
    jmu, jw = jcommon.capped_mu_weights(lam, mu, prefactor)
    tmu, tw = tcommon.capped_mu_weights(lam, mu, prefactor)
    assert tmu == jmu
    assert _ulps(tw.numpy(), np.asarray(jw)).max() <= 32  # as above


def test_capped_mu_weights_and_recombination_weights_refuse_bad_mu():
    for bad in (0, 9):
        with pytest.raises(ValueError, match="mu must be in"):
            tcommon.capped_mu_weights(16, bad)
    with pytest.raises(ValueError):
        tcommon.recombination_weights(0)
    with pytest.raises(ValueError, match="must exceed"):
        tcommon.recombination_weights(4, 4.0)


def test_step_size_rails_match_jax_exactly():
    sigma = np.array([0.0, 1e-30, 0.5, 3e25, np.inf, np.nan], np.float32)
    log_step = np.array([-5.0, 0.1, 0.69, 0.7, -0.2, 0.0], np.float32)
    np.testing.assert_array_equal(
        tcommon.clamp_step_size(_t(sigma)).numpy(), np.asarray(jcommon.clamp_step_size(sigma)))
    np.testing.assert_array_equal(
        tcommon.bounded_sigma_step(_t(sigma), _t(log_step)).numpy(),
        np.asarray(jcommon.bounded_sigma_step(jnp.asarray(sigma), jnp.asarray(log_step))))


def test_sorted_selection_and_weights_at_ranks_match_jax():
    w = tcommon.recombination_weights(5)
    ranks = np.array([0, 7, 4, 5, 1, 2, 9, 3, 6, 8], np.int32)
    np.testing.assert_array_equal(
        tcommon.weights_at_ranks(w, _t(ranks), 5).numpy(),
        np.asarray(jcommon.weights_at_ranks(jnp.asarray(w.numpy()), jnp.asarray(ranks), 5)))


def test_check_dense_scale_raises_as_jax():
    tcommon.check_dense_scale(100, 10, 4096, 2**26)
    with pytest.raises(tcommon.EighScaleError, match="eigh_max_dim"):
        tcommon.check_dense_scale(5000, 10, 4096, None)
    with pytest.raises(tcommon.EighScaleError, match="dense_budget_elems"):
        tcommon.check_dense_scale(4000, 20000, None, 2**26)
    with pytest.raises(tcommon.EighScaleError):
        tcma.CMAES(np.zeros(5000), 1.0, device="cpu")
    with pytest.raises(tcommon.EighScaleError, match="max_dim"):
        tcommon.safe_eigh(torch.eye(6), max_dim=5)


def _spd(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.exp(rng.uniform(-spread, spread, size=n))
    c = (q * eig) @ q.T
    # a slightly asymmetric input, as an accumulated covariance drifts
    return (c + 1e-7 * rng.normal(size=(n, n))).astype(np.float32)


def _repeated(n, seed):
    """Eigenvalues 2, 2, 2, 0.5, ...: degenerate eigenspaces, whose basis
    is free."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.where(np.arange(n) < 3, 2.0, 0.5)
    return ((q * eig) @ q.T).astype(np.float32)


@pytest.mark.parametrize("make", [lambda: _spd(8, 0), lambda: _spd(24, 1, 6.0),
                                  lambda: _repeated(10, 2), lambda: np.eye(5, dtype=np.float32)],
                         ids=["spd-8", "spd-24", "degenerate-10", "identity"])
def test_safe_eigh_invariants_against_jax(make):
    c = make()
    n = c.shape[0]
    B, D = tcommon.safe_eigh(_t(c))
    jB, jD = jcommon.safe_eigh(jnp.asarray(c))
    B64, D64 = B.numpy().astype(np.float64), D.numpy().astype(np.float64)
    sym = (c.astype(np.float64) + c.T) / 2
    scale = np.abs(sym).max()
    # B diag(D^2) B^T rebuilds the symmetrised C: eigh's backward error is
    # ~n eps |C| in float32 (eps 6e-8; n <= 24 here), so 1e-5 |C|
    np.testing.assert_allclose((B64 * D64**2) @ B64.T, sym, rtol=0, atol=1e-5 * scale)
    # B is orthonormal to float32's eigh accuracy, ~n eps
    np.testing.assert_allclose(B64.T @ B64, np.eye(n), rtol=0, atol=1e-5)
    # D equals JAX's D (both ascending, the sort is the identity): the two
    # eigensolvers' eigenvalues agree to ~n eps of the largest one, and D
    # is their square root
    np.testing.assert_allclose(np.sort(D.numpy()), np.sort(np.asarray(jD)), rtol=1e-5,
                               atol=1e-6 * float(D.max()))
    # B itself may differ from JAX's by column signs and, in a degenerate
    # eigenspace, by its basis; the projector onto each eigenspace may not
    jB64 = np.asarray(jB).astype(np.float64)
    np.testing.assert_allclose((B64 * D64**2) @ B64.T, (jB64 * np.asarray(jD, np.float64) ** 2)
                               @ jB64.T, rtol=0, atol=1e-5 * scale)


def test_safe_eigh_condition_clamp_is_exact():
    eig = np.array([1e-20, 1e-16, 1e-9, 0.25, 1.0, 4.0], np.float32)
    c = np.diag(eig)
    for cap in (1e14, 1e6):
        B, D = tcommon.safe_eigh(_t(c), cond_cap=cap)
        jB, jD = jcommon.safe_eigh(jnp.asarray(c), cond_cap=cap)
        np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
        floor = np.float32(np.float32(4.0) / np.float32(cap))
        assert D.numpy()[0] == np.sqrt(floor)
        assert (D.numpy() ** 2).max() / (D.numpy() ** 2).min() <= cap * (1 + 1e-6)


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
def test_safe_eigh_non_finite_falls_back_as_jax(poison):
    c = _spd(6, 3)
    c[2, 4] = poison
    B, D = tcommon.safe_eigh(_t(c))
    jB, jD = jcommon.safe_eigh(jnp.asarray(c))
    np.testing.assert_array_equal(B.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
    np.testing.assert_array_equal(B.numpy(), np.eye(6, dtype=np.float32))
    np.testing.assert_array_equal(D.numpy(), np.ones(6, np.float32))


@pytest.mark.parametrize("tf32", [True, False])
def test_full_f32_matmul_sets_ieee_and_restores(tf32):
    cublas = torch.backends.cuda.matmul
    was = cublas.allow_tf32
    try:
        cublas.allow_tf32 = tf32
        with tcommon.full_f32_matmul():
            assert cublas.fp32_precision == "ieee"
        assert cublas.allow_tf32 is tf32  # the legacy flag reads back unchanged
        assert cublas.fp32_precision == ("tf32" if tf32 else "ieee")
    finally:
        cublas.allow_tf32 = was


# -------------------------------------------------------------- ClipUp


@pytest.mark.parametrize("kwargs", [{}, dict(fix_gradient_size=False, max_speed=0.05),
                                    dict(learning_rate=0.5, momentum=0.5)],
                         ids=["default", "raw-gradient-clipped", "fast"])
def test_clipup_matches_jax(kwargs):
    rng = np.random.default_rng(4)
    params = rng.normal(size=9).astype(np.float32)
    jopt = clipup(**kwargs)
    topt = ClipUp(**kwargs)
    jstate, tstate = jopt.init(jnp.asarray(params)), topt.init(_t(params))
    for step in range(5):
        g = (rng.normal(size=9) * 10.0 ** (step - 2)).astype(np.float32)
        if step == 3:
            g[:] = 0.0  # a zero gradient: the 1e-12 floor of the norm
        ju, jstate = jopt.update(jnp.asarray(g), jstate)
        tu, tstate = topt.update(_t(g), tstate)
        # a norm (a sum of 9 squares) then elementwise: ~1 ulp
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tstate.velocity.numpy(), np.asarray(jstate.velocity),
                                   rtol=1e-6, atol=1e-8)


def test_make_optimizer_resolves_clipup_as_jax():
    opt = make_optimizer("clipup", 0.2, momentum=0.8)
    assert isinstance(opt, ClipUp) and opt.learning_rate == 0.2 and opt.momentum == 0.8
    assert type(make_optimizer("rmsprop", 0.1)).__name__ == "RMSProp"
    with pytest.raises(ValueError, match="objective's value"):
        make_optimizer("lbfgs", 0.1)  # refused, with the reason


# --------------------------------------------------------------- CMA-ES


def _cmaes_generations(jalgo, talgo, gens, seed=0, check_pop=True):
    """Run both for ``gens`` generations on tied Sphere fitness, JAX's draws
    and JAX's ``(B, D)`` handed to the port; compare every field after each
    ``tell``. Returns the number of decompositions the port made."""
    jstate = jalgo.init(jax.random.PRNGKey(seed))
    tstate = interop.es_state(talgo, _numpy_tree(jstate), seed=seed + 1)
    _assert_states(tstate, jstate)
    decomps = []
    for _ in range(gens):
        jpop, jstate = jit_once(jalgo, "ask")(jstate)
        talgo._draw = lambda s, z=_t(jstate.z): z
        tpop, tstate = talgo.ask(tstate)
        if check_pop:
            np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop), rtol=RTOL, atol=ATOL)
        fit = _tied_sphere(jpop)
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        talgo._decompose = lambda C, b=_t(jstate.B), d=_t(jstate.D): decomps.append(1) or (b, d)
        tstate = talgo.tell(tstate, _t(fit))
        _assert_states(tstate, jstate)
    return len(decomps)


@pytest.mark.parametrize("kwargs,gens,want_decomps", [
    (dict(pop_size=16), 4, 4),  # decomp_per_iter resolves to 1 at d 10
    (dict(pop_size=16, decomp_per_iter=3), 9, 3),  # the lazy path
    (dict(pop_size=9, cm=0.7, recombination_weights=[0.5, 0.3, 0.2]), 4, 4),
], ids=["default", "lazy", "custom-weights"])
def test_cmaes_generations_match_jax(kwargs, gens, want_decomps):
    center = np.linspace(-2.0, 3.0, 10).astype(np.float32)
    jalgo = jcma.CMAES(center, 1.5, **kwargs)
    talgo = tcma.CMAES(center, 1.5, **kwargs, device="cpu")
    for name in ("mu", "pop_size", "decomp_per_iter"):
        assert getattr(talgo, name) == getattr(jalgo, name), name
    np.testing.assert_allclose(talgo.mueff, jalgo.mueff, rtol=1e-6)
    assert _cmaes_generations(jalgo, talgo, gens) == want_decomps


def test_cmaes_own_decomposition_matches_jax_up_to_the_basis():
    """Without the injected (B, D), in a generation that decomposes: the
    port's own eigh gives the same D and the same covariance factor B
    diag(D) B^T. (B's column signs may differ, and with them the next
    population drawn from the same z, which is why the trajectory tests
    hand JAX's (B, D) over.)"""
    center = np.full(6, 2.0, np.float32)
    jalgo = jcma.CMAES(center, 1.0, pop_size=12)
    talgo = tcma.CMAES(center, 1.0, pop_size=12, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(3))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    for gen in range(2):
        jpop, jstate = jit_once(jalgo, "ask")(jstate)
        talgo._draw = lambda s, z=_t(jstate.z): z
        _, tstate = talgo.ask(tstate)
        fit = np.sum(np.asarray(jpop) ** 2, axis=1).astype(np.float32)
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        if gen == 0:  # the next generation samples through JAX's basis
            tstate = tstate.replace(B=_t(jstate.B), D=_t(jstate.D))
    np.testing.assert_allclose(tstate.D.numpy(), np.asarray(jstate.D), rtol=1e-5, atol=1e-7)
    B, D = tstate.B.numpy().astype(np.float64), tstate.D.numpy().astype(np.float64)
    jB, jD = np.asarray(jstate.B, np.float64), np.asarray(jstate.D, np.float64)
    np.testing.assert_allclose((B * D) @ B.T, (jB * jD) @ jB.T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tstate.C.numpy(), np.asarray(jstate.C), rtol=1e-5, atol=1e-6)


def test_cmaes_tied_fitness_sorts_stably():
    """Every fitness equal: the stable sort keeps index order, so the first
    mu samples are the selected ones, as jnp.argsort selects them."""
    jalgo = jcma.CMAES(np.zeros(4, np.float32), 1.0, pop_size=8)
    talgo = tcma.CMAES(np.zeros(4, np.float32), 1.0, pop_size=8, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    _, jstate = jit_once(jalgo, "ask")(jstate)
    talgo._draw = lambda s, z=_t(jstate.z): z
    _, tstate = talgo.ask(tstate)
    fit = np.ones(8, np.float32)
    jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
    talgo._decompose = lambda C: (_t(jstate.B), _t(jstate.D))
    tstate = talgo.tell(tstate, _t(fit))
    _assert_states(tstate, jstate)
    w = talgo.weights
    np.testing.assert_allclose(tstate.mean.numpy(), (w @ tstate.z[:4]).numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kwargs", [dict(pop_size=12), dict(pop_size=40, mu=6)], ids=["default", "capped-mu"])
def test_sep_cmaes_generations_match_jax(kwargs):
    center = np.linspace(-1.0, 2.0, 7).astype(np.float32)
    jalgo = jcma.SepCMAES(center, 0.8, **kwargs)
    talgo = tcma.SepCMAES(center, 0.8, **kwargs, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(5))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    for _ in range(4):
        jpop, jstate = jit_once(jalgo, "ask")(jstate)
        talgo._draw = lambda s, z=_t(jstate.z): z
        tpop, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop), rtol=RTOL, atol=ATOL)
        fit = _tied_sphere(jpop)
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        _assert_states(tstate, jstate)


@pytest.mark.parametrize("cls", ["IPOPCMAES", "BIPOPCMAES"])
@pytest.mark.parametrize("restart", [False, True], ids=["continue", "restart"])
def test_restart_cmaes_tell_matches_jax(cls, restart):
    """A restart in place (forced by a stagnation tolerance above every
    spread) or none: the state after tell equals JAX's field by field, the
    restart's uniform mean handed over from JAX's draw."""
    center = np.full(5, 1.0, np.float32)
    kw = dict(pop_size=8, stagnation_tol=1e9 if restart else 1e-12, restart_bounds=(-2.0, 3.0))
    jalgo = getattr(jcma, cls)(center, 1.0, **kw)
    talgo = getattr(tcma, cls)(center, 1.0, **kw, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(8))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    for _ in range(3):
        jpop, jstate = jit_once(jalgo, "ask")(jstate)
        talgo._draw = lambda s, z=_t(jstate.z): z
        _, tstate = talgo.ask(tstate)
        _, k = jax.random.split(jstate.key)  # the restart's draw, from the state tell holds
        mean = _t(jax.random.uniform(k, (5,), minval=-2.0, maxval=3.0))
        talgo._draw_restart = lambda s, m=mean: m
        fit = np.sum(np.asarray(jpop) ** 2, axis=1).astype(np.float32)
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        talgo._decompose = lambda C, b=_t(jstate.B), d=_t(jstate.D): (b, d)
        tstate = talgo.tell(tstate, _t(fit))
        _assert_states(tstate, jstate)
        if restart:
            np.testing.assert_array_equal(tstate.mean.numpy(), mean.numpy())
            np.testing.assert_array_equal(tstate.C.numpy(), np.eye(5, dtype=np.float32))


def test_restart_cmaes_draws_its_mean_within_bounds():
    algo = tcma.IPOPCMAES(np.zeros(50), 1.0, pop_size=8, stagnation_tol=1e9,
                          restart_bounds=(-2.0, 3.0), device="cpu")
    state = algo.init(0)
    pop, state = algo.ask(state)
    state = algo.tell(state, torch.sum(pop**2, dim=1))
    assert ((state.mean >= -2.0) & (state.mean < 3.0)).all() and float(state.sigma) == 1.0


@pytest.mark.parametrize("bipop", [False, True], ids=["ipop", "bipop"])
def test_restart_driver_grows_the_population_as_jax(bipop):
    """The driver's schedule: IPOP doubles the population on every restart;
    BIPOP doubles it only in the large regime and takes the small regime
    once its spent budget falls behind. Each run stops on a collapsed
    spread: a constant objective stops every run after one generation."""
    def flat(pop):
        return torch.zeros(pop.shape[0])

    sizes = []

    def jflat(pop):
        sizes.append(pop.shape[0])
        return jnp.zeros(pop.shape[0])

    driver = tcma.RestartCMAESDriver(np.zeros(10), 1.0, flat, bipop=bipop, device="cpu")
    best_x, best_f = driver.run(0, max_restarts=4, gens_per_run=5)
    jdriver = jcma.RestartCMAESDriver(np.zeros(10, np.float32), 1.0, jflat, bipop=bipop)
    jdriver.run(jax.random.PRNGKey(0), max_restarts=4, gens_per_run=5)
    base = tcma._default_pop_size(10)
    assert driver.base_pop_size == jdriver.base_pop_size == base
    if not bipop:
        assert driver.pop_sizes == sizes == [base, 2 * base, 4 * base, 8 * base]
    else:
        # restart 1 takes the large regime (nothing spent in the small one
        # yet... the small budget 0 < the large one), so the sizes alternate
        # large, small, large, small with draws of their own
        assert driver.pop_sizes[0] == sizes[0] == base
        assert driver.pop_sizes[2] == sizes[2] == 2 * base
        for small in (driver.pop_sizes[1], driver.pop_sizes[3]):
            assert small >= 4 and small % 2 == 0 and small <= 2 * base
    assert best_f == 0.0 and best_x.shape == (10,)


def test_restart_driver_finds_the_sphere_optimum():
    driver = tcma.RestartCMAESDriver(np.full(5, 3.0), 1.0, lambda p: torch.sum(p**2, dim=1),
                                     device="cpu")
    best_x, best_f = driver.run(17, max_restarts=2, gens_per_run=150)
    assert best_f < 1e-8 and float(torch.sum(best_x**2)) == pytest.approx(best_f, rel=1e-5)
    assert driver.pop_sizes == [8, 16]


# ------------------------------------------------------- the slice, whole


def test_slice_std_workflow_cmaes_matches_jax_over_three_decomposition_periods():
    """StdWorkflow(CMAES) with an EvalMonitor on Sphere at d 10, pop 16, a
    decomposition every 2 generations, against the JAX package's workflow
    over 3 periods (6 generations): the algorithm's state field by field and
    the monitor's best fitness, JAX's draws and (B, D) handed over."""
    dim, pop, period, gens = 10, 16, 2, 6
    center = np.full(dim, 3.0, np.float32)
    jalgo = jcma.CMAES(center, 1.0, pop_size=pop, decomp_per_iter=period)
    talgo = tcma.CMAES(center, 1.0, pop_size=pop, decomp_per_iter=period, device="cpu")
    jmon, tmon = JaxEvalMonitor(), EvalMonitor(device="cpu")
    jwf = JaxStdWorkflow(jalgo, JaxSphere(), monitors=(jmon,))
    twf = StdWorkflow(talgo, Sphere(), monitors=[tmon], device="cpu")
    jstate = jwf.init(jax.random.PRNGKey(17))
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate), seed=4)
    decomps = 0
    for _ in range(gens):
        _, k = jax.random.split(jstate.algo.key)
        talgo._draw = lambda s, z=_t(jax.random.normal(k, (pop, dim))): z
        jstate = jwf.step(jstate)
        bd = (_t(jstate.algo.B), _t(jstate.algo.D))

        def decompose(C, bd=bd):
            nonlocal decomps
            decomps += 1
            return bd

        talgo._decompose = decompose
        tstate = twf.step(tstate)
        _assert_states(tstate.algo, jstate.algo)
        # the best fitness is a sum of 10 squares of values that agree to
        # RTOL: its own sum order adds ~1 ulp
        np.testing.assert_allclose(float(tmon.get_best_fitness(tstate.monitors[0])),
                                   float(jmon.get_best_fitness(jstate.monitors[0])), rtol=3e-5)
    assert decomps == gens // period
    assert tstate.generation == int(jstate.generation) == gens
    assert float(tmon.get_best_fitness(tstate.monitors[0])) < 3.0**2 * dim


# ------------------------------------------------ convergence thresholds


def _sphere_best(algo, steps, seed=17):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, Sphere(), monitors=[mon], device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


DIM = 5  # tests/test_so_es.py's thresholds, at its DIM

CONVERGENCE = {
    "CMAES": (lambda: tcma.CMAES(np.full(DIM, 3.0), 1.0, pop_size=16, device="cpu"), 200, 0.01),
    "SepCMAES": (lambda: tcma.SepCMAES(np.full(DIM, 3.0), 1.0, pop_size=32, device="cpu"), 300, 0.1),
    "IPOPCMAES": (lambda: tcma.IPOPCMAES(np.full(DIM, 3.0), 1.0, pop_size=16, device="cpu"), 200, 0.01),
    "BIPOPCMAES": (lambda: tcma.BIPOPCMAES(np.full(DIM, 3.0), 1.0, pop_size=16, device="cpu"), 200,
                   0.01),
}


@pytest.mark.parametrize("case", sorted(CONVERGENCE))
def test_cma_family_converges_on_sphere(case):
    make, steps, threshold = CONVERGENCE[case]
    assert _sphere_best(make(), steps) < threshold
