"""The port's reference-vector MOEAs, metrics and entry points against the
JAX package, on the CPU.

APD selection, whole generations of RVEA, RVEAa and LMOCSO from a JAX
state (JAX's draws through ``tests/_torch_mo_draws.py`` and JAX's
reference vectors through ``interop.set_reference_vectors``), the
hypervolume (2-D, exact 3-D, contributions, Monte Carlo with JAX's draws)
and GD/GD+, and the new entry points' refusal of a missing card. Integer
outputs are compared exactly, floats with the tolerance stated at each
test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mo_draws as draws
from evox_tpu.algorithms.mo import LMOCSO as JaxLMOCSO
from evox_tpu.algorithms.mo import RVEA as JaxRVEA
from evox_tpu.algorithms.mo import RVEAa as JaxRVEAa
from evox_tpu.metrics import hypervolume as jhv
from evox_tpu.operators.selection import rvea_selection as jrvea
from evox_tpu.problems.numerical import DTLZ2 as JaxDTLZ2
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms import mo as tmo
from evox_tpu_torch.metrics import GD, HV, GDPlus, gd, gd_plus, igd
from evox_tpu_torch.metrics import hypervolume as thv
from evox_tpu_torch.operators import sampling as tsampling
from evox_tpu_torch.operators.selection import rvea_selection as trvea
from evox_tpu_torch.problems import numerical as tnum

# the modules, not the functions of the same names their package exports
jgd_mod = importlib.import_module("evox_tpu.metrics.gd")

POW_RTOL, POW_ATOL = 1e-5, 1e-6
# APD: arccos (XLA's and PyTorch's differ in the last ulps), products and a
# norm; the winners are compared exactly
APD_RTOL = 1e-5
# sums of n slabs in another order than XLA's
HV_RTOL = 1e-5
D, M = 7, 3


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


# ------------------------------------------------------------ selection


@pytest.mark.parametrize("theta", [0.0, 0.3, 1.0])
def test_ref_vec_guided_matches_jax(theta):
    """Winners and niche masks exact (an all-zero translated row, repeated
    rows and empty niches included); the selected population and fitness
    exact (rows copied)."""
    rng = np.random.default_rng(int(theta * 10))
    fit = _objs(120, M, 1)
    fit[3] = fit.min(axis=0)  # translates to the origin: never a winner
    fit[10:14] = fit[20]
    v = tnum.DTLZ2(m=M, device="cpu").pf()[::3].numpy()  # 34 unit vectors
    pop = rng.random((120, 5)).astype(np.float32)
    j_w, j_has = jrvea.ref_vec_guided_indices(jnp.asarray(fit), jnp.asarray(v), jnp.float32(theta))
    t_w, t_has = trvea.ref_vec_guided_indices(_t(fit), _t(v), torch.tensor(theta))
    np.testing.assert_array_equal(t_has.numpy(), _np(j_has))
    np.testing.assert_array_equal(t_w.numpy(), _np(j_w))
    assert not t_has.all() and 3 not in t_w[t_has].tolist()
    j_pop, j_fit = jrvea.ref_vec_guided(jnp.asarray(pop), jnp.asarray(fit), jnp.asarray(v), jnp.float32(theta))
    t_pop, t_fit = trvea.ref_vec_guided(_t(pop), _t(fit), _t(v), torch.tensor(theta))
    np.testing.assert_array_equal(t_pop.numpy(), _np(j_pop))
    np.testing.assert_array_equal(t_fit.numpy(), _np(j_fit))


# ------------------------------------------------------ whole generations


def _pair(jcls, tcls, **kw):
    jalgo = jcls(jnp.zeros(D), jnp.ones(D), n_objs=M, pop_size=100, **kw)
    talgo = tcls(np.zeros(D), np.ones(D), n_objs=M, pop_size=100, device="cpu", **kw)
    assert talgo.pop_size == jalgo.pop_size
    jvec = jalgo.vectors if isinstance(jalgo, JaxLMOCSO) else jalgo.v0
    interop.set_reference_vectors(talgo, _np(jvec))
    return jalgo, talgo


def _start(jalgo, talgo, jprob, seed):
    jstate = jalgo.init(jax.random.PRNGKey(seed))
    jstate = jalgo.init_tell(jstate, jprob.evaluate(None, jstate.population)[0])
    return jstate, interop.mo_family_state(talgo, _numpy_tree(jstate))


def _check(tstate, jstate, exact=("fitness",), close=("population",)):
    for name in exact:
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), _np(getattr(jstate, name)))
    for name in close:
        np.testing.assert_allclose(getattr(tstate, name).numpy(), _np(getattr(jstate, name)),
                                   rtol=POW_RTOL, atol=POW_ATOL)


@pytest.mark.parametrize("cls", ["RVEA", "RVEAa"])
def test_rvea_generations_from_a_jax_state_match(monkeypatch, cls):
    """RVEA and RVEAa (max_gen 10, vectors adapted every generation): four
    generations from JAX's state with JAX's draws (the mating draw's
    uniforms, RVEAa's regenerated directions), both tells given the same
    fitness. The port works out the mating probabilities itself, over
    rows of which some are empty niches after the first tell (27-33 of
    RVEA's 100 here). Survivors (fitness) exact, population within the POW
    tolerance, the vectors within APD_RTOL, gen exact."""
    jcls, tcls = (JaxRVEA, tmo.RVEA) if cls == "RVEA" else (JaxRVEAa, tmo.RVEAa)
    jalgo, talgo = _pair(jcls, tcls, max_gen=10)
    jprob = JaxDTLZ2(d=D, m=M)
    jstate, tstate = _start(jalgo, talgo, jprob, 0)
    empty = []  # empty niches' +inf rows, which the mating draw must skip
    for _ in range(4):
        empty.append(int((~np.isfinite(_np(jstate.fitness)).all(axis=1)).sum()))
        d = draws.rvea(jalgo, jstate)
        monkeypatch.setattr(talgo, "_draw", lambda seed, rows, d=d: d)
        j_off, jstate = jalgo.ask(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        if cls == "RVEAa":
            rand = draws.rveaa_directions(jalgo, jstate.key)
            monkeypatch.setattr(talgo, "_draw_directions", lambda seed, rand=rand: rand)
        fit = _np(jprob.evaluate(None, j_off)[0])
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        _check(tstate, jstate)
        np.testing.assert_allclose(tstate.vectors.numpy(), _np(jstate.vectors), rtol=APD_RTOL,
                                   atol=1e-7)
    assert tstate.gen == int(jstate.gen) == 4
    assert min(empty[1:]) > 0, empty  # the draw had rows of probability 0


def _choice_p(case, n):
    rng = np.random.default_rng(n)
    if case == "random":
        return rng.random(n).astype(np.float32)
    if case == "all_zero":
        return np.zeros(n, np.float32)
    if case == "zero_runs":  # flat stretches: tied cumulative sums
        p = rng.random(n).astype(np.float32)
        p[rng.random(n) < 0.6] = 0.0
        p[:3] = p[-3:] = 0.0
        return p
    if case == "rvea_valid":  # RVEA's: the finite rows over their count
        valid = rng.random(n) < 0.7
        return (valid / max(valid.sum(), 1)).astype(np.float32)
    # EAGMOEAD's: success counts over their sum, floored at 0.002
    s = rng.integers(0, 5, n).astype(np.float32) + 1e-6
    d = s / s.sum() + 0.002
    return (d / d.sum()).astype(np.float32)


@pytest.mark.parametrize("n", [1, 16, 17, 100, 990, 4097, 65537])
def test_blocked_cumsum_matches_jax_cumsum_bit_for_bit(n):
    """``blocked_cumsum`` adds in the JAX package's CPU order (blocks of 16,
    the blocks' totals by the same rule, two levels of carries at n 65537):
    equal bit for bit on uniform, sparse and signed inputs, where
    ``torch.cumsum`` differs from it in many places at n 100 and above."""
    rng = np.random.default_rng(n)
    sparse = rng.random(n).astype(np.float32)
    sparse[rng.random(n) < 0.6] = 0.0
    for x in (rng.random(n).astype(np.float32), sparse,
              (rng.standard_normal(n) * 1e3).astype(np.float32)):
        np.testing.assert_array_equal(tmo.common.blocked_cumsum(_t(x)).numpy(),
                                      _np(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("case", ["random", "all_zero", "zero_runs", "rvea_valid", "eag_success"])
def test_weighted_indices_match_jax_choice(case):
    """``weighted_indices(p, u)`` on the uniforms ``jax.random.choice(key, n,
    shape, p=p)`` draws from ``key`` gives JAX's indices exactly: flat
    stretches of ``cumsum(p)`` go to the first index of the stretch (a
    left search), an all-zero ``p`` to index 0."""
    for n in (7, 100, 990):
        p = _choice_p(case, n)
        key = jax.random.PRNGKey(n)
        want = _np(jax.random.choice(key, n, (3 * n,), p=jnp.asarray(p)))
        got = tmo.common.weighted_indices(_t(p), draws.choice_uniform(key, (3 * n,)))
        np.testing.assert_array_equal(got.numpy(), want)
        if case == "all_zero":
            assert (want == 0).all()


def test_lmocso_generations_from_a_jax_state_match(monkeypatch):
    """LMOCSO: four generations from JAX's state with JAX's draws (pairing,
    r0, r1, mutation). The competitions' winners follow from a sum over
    objectives and the shift-based density, each within an ulp of JAX's, so
    survivors (fitness) are exact on these inputs; positions and velocities
    within the POW tolerance."""
    jalgo, talgo = _pair(JaxLMOCSO, tmo.LMOCSO, max_gen=10)
    jprob = JaxDTLZ2(d=D, m=M)
    jstate, tstate = _start(jalgo, talgo, jprob, 1)
    for _ in range(4):
        d = draws.lmocso(jalgo, jstate.key)
        monkeypatch.setattr(talgo, "_draw", lambda seed, d=d: d)
        j_off, jstate = jalgo.ask(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        _check(tstate, jstate, exact=(), close=("velocity", "off_velocity"))
        fit = _np(jprob.evaluate(None, j_off)[0])
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        _check(tstate, jstate, close=("population", "velocity"))
    assert tstate.gen == int(jstate.gen) == 4


def test_sde_density_matches_jax():
    from evox_tpu.algorithms.mo.sra import _sde_density

    fit = _objs(50, M, 4)
    fit[7] = fit[8]
    np.testing.assert_allclose(tmo.lmocso.sde_density(_t(fit)).numpy(),
                               _np(_sde_density(jnp.asarray(fit))), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ IGD gates


def _igd_after(algo, steps, seed):
    """``(igd, finite)``: IGD on DTLZ2 after ``steps`` steps (empty niches'
    +inf rows counted at 1e6) and the number of rows of finite fitness."""
    prob = tnum.DTLZ2(d=D, m=M, device="cpu")
    wf = StdWorkflow(algo, prob, device="cpu")
    fit = wf.run(wf.init(seed), steps).algo.fitness
    finite = torch.isfinite(fit).all(dim=1, keepdim=True)
    return float(igd(torch.where(finite, fit, 1e6), prob.pf())), int(finite.sum())


@pytest.mark.parametrize("name", ["RVEA", "RVEAa"])
def test_rvea_family_passes_the_dtlz2_igd_gate(name):
    """``tests/test_mo_algorithms.py``'s gate, IGD < 0.15 (DTLZ2, d 7, m 3,
    pop 100, max_gen 100, 100 generations), on seeds 0, 1 and 2. The port's
    IGDs (torch 2.13, CPU), seeds 0-4: RVEA 0.049-0.065, RVEAa
    0.041-0.057."""
    for seed in range(3):
        algo = getattr(tmo, name)(torch.zeros(D), torch.ones(D), n_objs=M, pop_size=100,
                                  max_gen=100, device="cpu")
        assert _igd_after(algo, 100, seed)[0] < 0.15, seed


def test_lmocso_passes_the_dtlz2_igd_gate_as_often_as_jax():
    """``test_lmocso_dtlz2_igd``'s gate, IGD < 0.3 (DTLZ2, d 7, m 3, pop 100,
    max_gen 100, 100 generations). LMOCSO collapses onto a few niches on
    some seeds in both packages: the JAX package's IGDs on its seeds 0-4
    are 0.310, 1.110, 0.786, 0.252, 0.021 (2 of 5 under the gate; its own
    test runs seed 3), the port's on seeds 0-4 0.032, 0.596, 1.032, 1.604,
    0.022 (jax 0.9, torch 2.13, CPU). Held: at least 2 of the 5 seeds pass,
    and every run ends with finite survivors (the port's: 90, 76, 30, 44 and
    90 of 91 rows). The rule rests on these five seeds on each side, a rate
    rather than a seed, since the collapse is the algorithm's (ROADMAP C).
    (One generation on JAX's draws equals JAX's:
    ``test_lmocso_generations_from_a_jax_state_match``.)"""
    results = []
    for seed in range(5):
        algo = tmo.LMOCSO(torch.zeros(D), torch.ones(D), n_objs=M, pop_size=100, max_gen=100,
                          device="cpu")
        results.append(_igd_after(algo, 100, seed))
    assert sum(r < 0.3 for r, _ in results) >= 2, results
    assert all(finite > 0 for _, finite in results), results


# -------------------------------------------------------------- metrics


def test_hypervolume_2d_and_3d_match_jax():
    """Exact 2-D and 3-D volumes, masked rows, points outside the box and
    duplicates included: to HV_RTOL."""
    for m, ref, fn in ((2, [1.5, 1.5], "hypervolume_2d"), (3, [1.2, 1.3, 1.4], "hypervolume_3d")):
        objs = _objs(80, m, m)
        objs[5] = 2.0  # outside the box
        objs[9] = objs[10]
        mask = np.random.default_rng(m).random(80) < 0.7
        for msk in (None, mask):
            want = float(getattr(jhv, fn)(jnp.asarray(objs), jnp.asarray(ref),
                                          None if msk is None else jnp.asarray(msk)))
            got = float(getattr(thv, fn)(_t(objs), torch.tensor(ref),
                                         None if msk is None else _t(msk)))
            assert want > 0
            np.testing.assert_allclose(got, want, rtol=HV_RTOL)
    objs = _objs(50, 3, 0)
    np.testing.assert_allclose(float(thv.hypervolume_3d(_t(objs), torch.tensor([1.2, 1.3, 1.4]),
                                                        chunk_rows=7)),
                               float(thv.hypervolume_3d(_t(objs), torch.tensor([1.2, 1.3, 1.4]))),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="3 objectives"):
        thv.hypervolume_3d(_t(_objs(4, 2, 0)), torch.ones(2))


@pytest.mark.parametrize("m", [2, 3])
def test_hypervolume_contributions_match_jax(m):
    """Leave-one-out contributions, plain and within groups (Pareto-rank
    labels): to HV_RTOL of the largest contribution (cancellation of two
    near-equal volumes); dominated points exactly 0."""
    objs = _objs(24, m, 5)
    objs[3] = objs[4] + 0.05  # dominated by row 4
    ref = jnp.full((m,), 1.6)
    group = (np.arange(24) % 3).astype(np.int32)
    for grp in (None, group):
        want = _np(jhv.hypervolume_contributions(jnp.asarray(objs), ref,
                                                 None if grp is None else jnp.asarray(grp)))
        got = thv.hypervolume_contributions(_t(objs), _t(ref), None if grp is None else _t(grp)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=HV_RTOL * want.max())
    assert thv.hypervolume_contributions(_t(objs), _t(ref))[3] == 0


@pytest.mark.parametrize("method", ["bounding_cube", "each_cube"])
def test_hypervolume_mc_with_jax_draws(method):
    """With JAX's uniform draws handed over: to 1e-5 relative (the same
    counts; a product of box sides in another order). Drawn by the port:
    within 3 % of the exact 3-D volume at 20000 samples."""
    objs = _objs(20, 3, 6)
    ref = jnp.array([1.5, 1.5, 1.5])
    key = jax.random.PRNGKey(4)
    n_samples = 4000
    if method == "bounding_cube":
        u = jax.random.uniform(key, (n_samples, 3))
    else:
        u = jnp.stack([jax.random.uniform(k, (n_samples // 20, 3)) for k in jax.random.split(key, 20)])
    want = float(jhv.hypervolume_mc(key, jnp.asarray(objs), ref, n_samples, method))
    got = float(thv.hypervolume_mc(0, _t(objs), _t(ref), n_samples, method, u=_t(u)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = float(thv.hypervolume_3d(_t(objs), _t(ref)))
    drawn = float(thv.hypervolume_mc(1, _t(objs), _t(ref), 20000, method))
    assert abs(drawn - exact) < 0.03 * exact
    hv = HV(_t(ref))
    np.testing.assert_allclose(float(hv(0, _t(objs))), exact, rtol=0)
    np.testing.assert_allclose(float(HV(torch.full((4,), 1.5), 20000)(1, _t(_objs(20, 4, 6)))),
                               float(jhv.HV(jnp.full((4,), 1.5), 20000)(key, jnp.asarray(_objs(20, 4, 6)))),
                               rtol=0.05)


def test_gd_and_gd_plus_match_jax():
    """GD (p 1 and 2) and GD+ on DTLZ2's front: to 1e-5 relative (means of
    float32 distances from a matrix product)."""
    objs = _objs(60, 3, 7)
    pf = _np(JaxDTLZ2(m=3).pf())
    for p in (1.0, 2.0):
        np.testing.assert_allclose(float(gd(_t(objs), _t(pf), p)),
                                   float(jgd_mod.gd(jnp.asarray(objs), jnp.asarray(pf), p)), rtol=1e-5)
        np.testing.assert_allclose(float(GD(_t(pf), p)(_t(objs))), float(gd(_t(objs), _t(pf), p)))
    want = float(jgd_mod.gd_plus(jnp.asarray(objs), jnp.asarray(pf)))
    np.testing.assert_allclose(float(gd_plus(_t(objs), _t(pf))), want, rtol=1e-5)
    np.testing.assert_allclose(float(GDPlus(_t(pf))(_t(objs))), want, rtol=1e-5)


# ------------------------------------------------- interop and devices


def test_interop_refuses_wrong_constants():
    algo = tmo.MOEAD(np.zeros(3), np.ones(3), n_objs=2, pop_size=10, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        interop.set_neighbors(algo, np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="outside"):
        interop.set_neighbors(algo, np.full(tuple(algo.neighbors.shape), algo.pop_size))
    with pytest.raises(NotImplementedError, match="MOEAD has no reference vectors"):
        interop.set_reference_vectors(algo, np.zeros((3, 2)))
    nsga3 = tmo.NSGA3(np.zeros(3), np.ones(3), n_objs=2, pop_size=10, device="cpu")
    with pytest.raises(ValueError, match="refs has shape"):
        interop.set_reference_vectors(nsga3, np.zeros((3, 2)))


def test_new_entry_points_refuse_a_missing_cuda(monkeypatch):
    """device=None means cuda: without a card every new entry point raises,
    and with device="cpu" each builds (the MOEAs and problems of the
    decomposition, indicator and knee slices, MaF1-15, the samplers)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lb, ub = torch.zeros(D), torch.ones(D)
    makers = [lambda cls=cls, **kw: cls(lb, ub, n_objs=M, pop_size=20, **kw)
              for cls in (tmo.MOEAD, tmo.MOEADDRA, tmo.MOEADM2M, tmo.EAGMOEAD, tmo.NSGA3,
                          tmo.TDEA, tmo.RVEA, tmo.RVEAa, tmo.LMOCSO, tmo.GDE3, tmo.IBEA, tmo.SRA,
                          tmo.BCEIBEA, tmo.SPEA2, tmo.HypE, tmo.KnEA, tmo.BiGE)]
    makers += [lambda cls=getattr(tnum, f"DTLZ{i}"), **kw: cls(m=M, **kw) for i in range(1, 8)]
    makers += [lambda cls=getattr(tnum, f"MaF{i}"), **kw: cls(m=M, **kw) for i in range(1, 16)]
    makers += [lambda **kw: tsampling.GridSampling(3, 2, **kw),
               lambda **kw: tsampling.LatinHypercubeSampling(5, 2, **kw)]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsampling.latin_hypercube(0, 5, 2)
    assert tsampling.latin_hypercube(0, 5, 2, device="cpu").shape == (5, 2)
