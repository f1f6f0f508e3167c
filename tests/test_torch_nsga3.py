"""The port's NSGA-III and θ-DEA against the JAX package, on the CPU.

The normalisation (with its own m × m solve), the closed-form niching
against the sequential loop it replaces and against JAX's
``lax.while_loop``, the sort that stops at the cut, and whole generations
from a JAX state. JAX's reference directions cross through
``interop.set_reference_vectors`` and its draws through
``tests/_torch_mo_draws.py``. Survivor sets and ranks are compared
exactly, floats with the tolerance stated at each test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
import _torch_mo_draws as draws
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.mo import NSGA3 as JaxNSGA3
from evox_tpu.algorithms.mo import TDEA as JaxTDEA
from evox_tpu.problems.numerical import DTLZ1 as JaxDTLZ1
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.mo import NSGA3, TDEA
from evox_tpu_torch.algorithms.mo import nsga3 as tnsga3
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.operators.selection import non_dominated_sort
from evox_tpu_torch.problems.numerical import DTLZ1, DTLZ2

jnsga3 = importlib.import_module("evox_tpu.algorithms.mo.nsga3")

POW_RTOL, POW_ATOL = 1e-5, 1e-6
# the normalisation: one m x m solve (Gaussian elimination here, LAPACK's
# LU there) and a division per entry: a few ulps of the intercepts
NORM_RTOL, NORM_ATOL = 1e-5, 1e-7
D, M = 7, 3


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(pop_size, d=D, m=M, cls=(JaxNSGA3, NSGA3)):
    """The JAX and port algorithms, the port on JAX's reference directions."""
    jalgo = cls[0](jnp.zeros(d), jnp.ones(d), n_objs=m, pop_size=pop_size)
    talgo = cls[1](np.zeros(d), np.ones(d), n_objs=m, pop_size=pop_size, device="cpu")
    assert talgo.pop_size == jalgo.pop_size
    np.testing.assert_allclose(talgo.refs.numpy(), _np(jalgo.refs), rtol=1e-6)
    interop.set_reference_vectors(talgo, _np(jalgo.refs))
    return jalgo, talgo


# ---------------------------------------------------------- normalisation


@pytest.mark.parametrize("m", [2, 3, 5])
def test_solve_and_det_matches_numpy(m):
    """Against float64 LAPACK: x and det to 1e-5 relative on well-posed
    systems; a singular matrix gives det 0 and a non-finite x, no error."""
    rng = np.random.default_rng(m)
    for _ in range(5):
        a = rng.normal(size=(m, m)).astype(np.float32)
        b = rng.normal(size=m).astype(np.float32)
        x, det = tnsga3.solve_and_det(_t(a), _t(b))
        a64 = a.astype(np.float64)
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(a64, b), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(det), np.linalg.det(a64), rtol=1e-5)
    a[1] = a[0]  # two equal rows
    x, det = tnsga3.solve_and_det(_t(a), _t(b))
    assert float(det) == 0.0 and not bool(torch.isfinite(x).all())


def _front(n, m, rng, ref_point=None):
    """n mutually non-dominated rows: points on the plane sum(f) = 1 (near
    ``ref_point`` when given)."""
    if ref_point is None:
        pts = rng.dirichlet(np.ones(m), size=n)
    else:
        noise = rng.normal(size=(n, m)) * 1e-3
        pts = ref_point + noise - noise.mean(axis=1, keepdims=True)
    return pts.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "duplicate extremes"])
def test_normalize_matches_jax(case):
    """The intercept path and, with two axes sharing one extreme point (a
    singular extreme set, |det| <= 1e-10), the nadir path: to NORM_RTOL."""
    rng = np.random.default_rng(0)
    fit = (rng.random((60, M)) * 3).astype(np.float32)
    if case == "duplicate extremes":
        fit[:] = fit * 0.5 + 1.0
        fit[7] = [0.0, 0.0, 2.0]  # the extreme point of axes 0 and 1
    want = _np(jnsga3._normalize(jnp.asarray(fit)))
    got = tnsga3.normalize(_t(fit)).numpy()
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL, atol=NORM_ATOL)
    if case == "duplicate extremes":
        f = fit - fit.min(axis=0)
        np.testing.assert_allclose(got, f / f.max(axis=0), rtol=1e-6)


# ------------------------------------------------------------- niching


@pytest.mark.parametrize("trial", range(6))
def test_closed_form_niching_equals_the_loop(trial):
    """On random niching inputs with many ties (few references, rounded
    distances, NaN distances, references without candidates, selected rows
    already in niches): the closed form equals the sequential loop."""
    rng = np.random.default_rng(trial)
    n, nref = 200, [3, 7, 40][trial % 3]
    rank = rng.integers(0, 3, n)
    selected, candidate = rank < 1, rank == 1
    pi = rng.integers(0, nref, n)
    dist = np.round(rng.random(n), 1).astype(np.float32)
    dist[rng.random(n) < 0.05] = np.nan
    rho = np.bincount(pi[selected], minlength=nref).astype(np.int32)
    for need in (1, int(candidate.sum()) // 2, int(candidate.sum())):
        args = (_t(selected), _t(candidate), _t(pi), _t(dist), _t(rho), torch.tensor(need))
        closed = tnsga3.niche(*args)
        np.testing.assert_array_equal(closed.numpy(), tnsga3.niche_sequential(*args).numpy())
        assert int(closed.sum()) == int(selected.sum()) + need


def _niching_cases():
    rng = np.random.default_rng(7)
    front0 = _front(40, M, rng)
    behind = _front(80, M, rng) + 0.5  # a second front, all dominated
    random_fronts = np.concatenate([front0, behind, _front(60, M, rng) + 1.0])
    # one front clustered on one reference direction: every candidate
    # associates with the same reference point
    one_ref = _front(150, M, rng, ref_point=np.array([0.2, 0.3, 0.5]))
    # ties of distance: repeated rows in the split front
    ties = np.concatenate([front0, np.repeat(behind[:20], 4, axis=0)])
    # a NaN objective: its column's ideal point, and every distance, is NaN
    nan_rows = random_fronts.copy()
    nan_rows[[5, 50]] = np.nan
    return {"random fronts": random_fronts, "one reference": one_ref, "distance ties": ties,
            "NaN rows": nan_rows}


@pytest.mark.parametrize("name", list(_niching_cases()))
def test_select_niching_matches_jax(name):
    """NSGA-III's selection at pop 91 on merged fronts: the closed form, the
    sequential loop and JAX's while_loop keep the same survivors in the same
    order; JAX's full peel and the port's sort to the cut agree on every
    rank up to the cut."""
    fit = _niching_cases()[name]
    jalgo, talgo = _pair(100)
    n = fit.shape[0]
    pop = np.arange(n, dtype=np.float32)[:, None]
    j_pop, _ = jalgo.select(None, jnp.asarray(pop), jnp.asarray(fit))
    want = _np(j_pop)[:, 0].astype(np.int64)
    t_pop, t_fit = talgo.select(None, _t(pop), _t(fit))
    np.testing.assert_array_equal(t_pop.numpy()[:, 0].astype(np.int64), want)
    selected, rank = talgo.select_mask(_t(fit))
    _, args = tnsga3.niching_inputs(_t(fit), talgo.refs, talgo.pop_size)
    np.testing.assert_array_equal(tnsga3.niche_sequential(*args).numpy(), selected.numpy())
    full = _np(jnsga3.non_dominated_sort(jnp.asarray(fit)))
    cut = full[np.argsort(full, kind="stable")[talgo.pop_size - 1]]
    ranked = full <= cut
    np.testing.assert_array_equal(rank.numpy()[ranked], full[ranked])
    assert (rank.numpy()[~ranked] == n).all()


def test_infinite_distance_case_is_a_fault_of_the_reference():
    """A candidate whose normalised row overflows the norm (distance +inf,
    cosine 0 with every direction, so reference 0) is reference 0's only
    candidate. JAX's loop takes argmin over a row of +inf, index 0, each
    time reference 0 comes up: it selects the dominated row 0 and wastes
    the later picks, and its survivors are filled up with dominated rows in
    index order. The sequential port does the same; the closed form takes
    the candidate and only candidates (ROADMAP C)."""
    rng = np.random.default_rng(11)

    def front(n):  # directions away from reference 0 (the third axis)
        pts = rng.dirichlet(np.ones(M), size=4 * n)
        return pts[pts[:, 2] < 0.5][:n].astype(np.float32)

    block = front(60)
    block[0] = [1e30, 1e30, -1e-3]  # non-dominated by its last objective
    fit = np.concatenate([front(30) + 2.0, block])  # rows 0-29 are dominated
    inf_row = 30
    jalgo, talgo = _pair(60)
    k = talgo.pop_size
    pop = np.arange(fit.shape[0], dtype=np.float32)[:, None]
    want = _np(jalgo.select(None, jnp.asarray(pop), jnp.asarray(fit))[0])[:, 0].astype(np.int64)
    closed, _ = talgo.select_mask(_t(fit))
    seq = tnsga3.niche_sequential(*tnsga3.niching_inputs(_t(fit), talgo.refs, k)[1])
    np.testing.assert_array_equal(torch.argsort(~seq, stable=True)[:k].numpy(), want)
    assert 0 in want and inf_row not in want
    kept = set(torch.argsort(~closed, stable=True)[:k].tolist())
    assert int(closed.sum()) == k and inf_row in kept and min(kept) >= inf_row


# ------------------------------------------------------ whole generations


@pytest.mark.parametrize("cls", [(JaxNSGA3, NSGA3), (JaxTDEA, TDEA)], ids=["NSGA3", "TDEA"])
def test_generations_from_a_jax_state_match(monkeypatch, cls):
    """NSGA3 and TDEA on DTLZ1 (d 7, m 3, pop 91): three generations from
    JAX's state with JAX's mating permutation and variation draws, both
    tells given the same fitness. Survivors are the same rows: fitness
    exact, population within the variation's POW tolerance."""
    jalgo, talgo = _pair(100, cls=cls)
    jprob = JaxDTLZ1(d=D, m=M)
    jstate = jalgo.init(jax.random.PRNGKey(1))
    jstate = jit_once(jalgo, "init_tell")(jstate, jit_once(jprob, "evaluate")(None, jstate.population)[0])
    tstate = interop.mo_state(talgo, _numpy_tree(jstate))
    for _ in range(3):
        draws.inject_ga(monkeypatch, talgo, jstate.key)
        j_off, jstate = jit_once(jalgo, "ask")(jstate)
        t_off, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(t_off.numpy(), _np(j_off), rtol=POW_RTOL, atol=POW_ATOL)
        fit = _np(jit_once(jprob, "evaluate")(None, j_off)[0])
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        np.testing.assert_array_equal(tstate.fitness.numpy(), _np(jstate.fitness))
        np.testing.assert_allclose(tstate.population.numpy(), _np(jstate.population),
                                   rtol=POW_RTOL, atol=POW_ATOL)


def test_slice_nsga3_dtlz1_workflow_matches_jax(monkeypatch):
    """The slice as a whole: StdWorkflow(NSGA3, DTLZ1) on both sides (d 7,
    m 3, pop 91); the port takes JAX's workflow state after the init step
    and JAX's reference directions, then runs three generations with JAX's
    draws and its own DTLZ1. Fitness to 1e-5 relative (each side evaluates
    its own offspring, which differ by the variation's ulps, and DTLZ1's g
    sums cosines scaled by 100); no kernel launches on the CPU."""
    jalgo, talgo = _pair(100)
    jwf = JaxStdWorkflow(jalgo, JaxDTLZ1(d=D, m=M))
    twf = StdWorkflow(talgo, DTLZ1(d=D, m=M, device="cpu"), device="cpu")
    jstate = jwf.step(jwf.init(jax.random.PRNGKey(2)))
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    launches = tdom.packed_dominance.launches
    for _ in range(3):
        draws.inject_ga(monkeypatch, talgo, jstate.algo.key)
        jstate = jwf.step(jstate)
        tstate = twf.step(tstate)
        np.testing.assert_allclose(tstate.algo.fitness.numpy(), _np(jstate.algo.fitness),
                                   rtol=1e-5, atol=1e-5)
    assert tstate.generation == int(jstate.generation) == 4
    assert tdom.packed_dominance.launches == launches


# ------------------------------------------------------------ IGD gates


@pytest.mark.parametrize("cls", [NSGA3, TDEA], ids=lambda c: c.__name__)
def test_passes_the_dtlz2_igd_gate(cls):
    """``tests/test_mo_algorithms.py``'s gate, IGD < 0.15 (DTLZ2, d 7, m 3,
    pop 100, 100 generations), on seeds 0, 1 and 2. The port's IGDs (torch
    2.13, CPU), seeds 0-4: NSGA3 0.068-0.076, TDEA 0.051-0.076."""
    for seed in range(3):
        algo = cls(torch.zeros(D), torch.ones(D), n_objs=M, pop_size=100, device="cpu")
        prob = DTLZ2(d=D, m=M, device="cpu")
        wf = StdWorkflow(algo, prob, device="cpu")
        fit = wf.run(wf.init(seed), 100).algo.fitness
        assert bool(torch.isfinite(fit).all())
        assert float(igd(fit, prob.pf())) < 0.15, seed


def test_sort_to_the_cut_keeps_the_full_peels_survivors(monkeypatch):
    """NSGA3 and TDEA sort with ``until=k``; with a full peel in its place
    they keep the same rows, on a merged population of many fronts."""
    rng = np.random.default_rng(5)
    fit = np.concatenate([_front(30, M, rng) + 0.1 * i for i in range(8)])

    def full_peel(f, until=None, return_cut_rank=False):
        rank = non_dominated_sort(f)  # every front
        if not return_cut_rank:
            return rank
        return rank, int(torch.sort(rank).values[until - 1])

    for cls in (NSGA3, TDEA):
        algo = cls(np.zeros(D), np.ones(D), n_objs=M, pop_size=100, device="cpu")
        pop = torch.arange(fit.shape[0], dtype=torch.float32)[:, None]
        cut, _ = algo.select(None, pop, _t(fit))
        module = importlib.import_module(type(algo).__module__)
        monkeypatch.setattr(module, "non_dominated_sort", full_peel)
        full, _ = algo.select(None, pop, _t(fit))
        monkeypatch.undo()
        np.testing.assert_array_equal(cut.numpy(), full.numpy())
