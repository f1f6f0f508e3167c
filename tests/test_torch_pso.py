"""The PSO family and its topologies in the port against the JAX package, on
the CPU, with JAX's draws handed to the port; and the family's convergence
thresholds through the port's EvalMonitor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu.algorithms.so import pso as jpso
from evox_tpu.algorithms.so.pso import topology as jtopo
from evox_tpu_torch import Problem, StdWorkflow, interop
from evox_tpu_torch.algorithms.so import pso as tpso
from evox_tpu_torch.algorithms.so.pso import topology as ttopo
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import Sphere

# Positions and velocities are elementwise float32 arithmetic on the same
# draws, except where a sum over particles enters: SL-PSO's swarm mean and
# FIPS's sum over the neighbourhood, which XLA and PyTorch may add in
# other orders. An ulp of such a sum (|x| <= 10 here: ~1e-6), times the
# coefficients and three generations, stays inside 1e-5.
RTOL, ATOL = 1e-5, 1e-5

DIM = 5
LB, UB = -10.0 * np.ones(DIM, np.float32), 10.0 * np.ones(DIM, np.float32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


# JAX's draws of the call that draws (ask or tell), from the state that
# call receives, in the order of the port's ``_draw``
def _pso_draws(algo, s):
    _, k1, k2 = jax.random.split(s.key, 3)
    shape = s.population.shape
    return _t(jax.random.uniform(k1, shape), jax.random.uniform(k2, shape))


def _clpso_draws(algo, s):
    _, k_learn, k_t1, k_t2, k_r = jax.random.split(s.key, 5)
    n, d = algo.pop_size, algo.dim
    return _t(jax.random.randint(k_t1, (n, d), 0, n), jax.random.randint(k_t2, (n, d), 0, n),
              jax.random.uniform(k_learn, (n, d)) < algo.Pc[:, None],
              jax.random.uniform(k_r, (n, d)))


def _slpso_draws(gaussian):
    def draws(algo, s):
        _, k_d, k1, k2, k3 = jax.random.split(s.key, 5)
        n, d = algo.pop_size, algo.dim
        demo = jax.random.normal(k_d, (n,)) if gaussian else jax.random.uniform(k_d, (n,))
        return _t(demo, *(jax.random.uniform(k, (n, d)) for k in (k1, k2, k3)))
    return draws


def _fips_draws(algo, s):
    _, k_r = jax.random.split(s.key)
    return _t(jax.random.uniform(k_r, (algo.pop_size, algo.neighbours.shape[1], algo.dim)))[0]


def _dms_draws(algo, s):
    _, k1, k2, k3, k_re = jax.random.split(s.key, 5)
    n, d = algo.pop_size, algo.dim
    return _t(jax.random.permutation(k_re, n), *(jax.random.uniform(k, (n, d)) for k in (k1, k2, k3)))


def _fspso_draws(algo, s):
    _, kp, kg, km, kmv = jax.random.split(s.key, 5)
    n, d = algo.pop_size, algo.dim
    return _t(jax.random.uniform(kp, (n, d)), jax.random.uniform(kg, (n, d)),
              jax.random.bernoulli(km, algo.mutate_rate, (n, d)), jax.random.uniform(kmv, (n, d)))


def _swmm_draws(algo, s):
    _, k1, k2 = jax.random.split(s.key, 3)
    shape = (algo.pop_size, algo.dim)
    return _t(jax.random.uniform(k1, shape, maxval=algo.max_phi_1),
              jax.random.uniform(k2, shape, maxval=algo.max_phi_2))


# name: (class, kwargs, the call that draws, its JAX draws)
CASES = {
    "pso": ("PSO", dict(lb=LB, ub=UB, pop_size=12), "tell", _pso_draws),
    "clpso": ("CLPSO", dict(lb=LB, ub=UB, pop_size=12), "ask", _clpso_draws),
    "slpso_gs": ("SLPSOGS", dict(lb=LB, ub=UB, pop_size=12), "ask", _slpso_draws(True)),
    "slpso_us": ("SLPSOUS", dict(lb=LB, ub=UB, pop_size=12), "ask", _slpso_draws(False)),
    "fips_ring": ("FIPS", dict(lb=LB, ub=UB, pop_size=12, topology="ring"), "ask", _fips_draws),
    "fips_square": ("FIPS", dict(lb=LB, ub=UB, pop_size=12, topology="square"), "ask", _fips_draws),
    "fips_full": ("FIPS", dict(lb=LB, ub=UB, pop_size=12, topology="full"), "ask", _fips_draws),
    # regroups at generation 0 and 2; the followed phase from generation 2
    "dms_pso_el": ("DMSPSOEL", dict(lb=LB, ub=UB, pop_size=12, sub_swarm_size=3, regroup_period=2,
                                    max_iteration=3, dynamic_ratio=0.7), "ask", _dms_draws),
    "fspso": ("FSPSO", dict(pop_size=12, dim=DIM, mutate_rate=0.2), "ask", _fspso_draws),
    "swmmpso": ("SwmmPSO", dict(lb=LB, ub=UB, pop_size=12), "tell", _swmm_draws),
    "swmmpso_shortcuts": ("SwmmPSO", dict(lb=LB, ub=UB, pop_size=12, shortcut_p=0.3), "tell",
                          _swmm_draws),
}


def _tied_fitness(cand):
    """Sphere on a coarse grid: ties among particles and against the
    personal bests."""
    return np.round(np.sum(np.asarray(cand) ** 2, axis=1) / 20.0).astype(np.float32)


def _assert_states(tstate, jstate):
    for f in dataclasses.fields(tstate):
        if not hasattr(jstate, f.name):
            continue  # the keys: the port holds seeds
        ours, theirs = getattr(tstate, f.name), np.asarray(getattr(jstate, f.name))
        if isinstance(ours, int):
            assert ours == int(theirs), f.name
        elif ours.dtype.is_floating_point:
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL, atol=ATOL, err_msg=f.name)
        else:  # integer and boolean fields exactly
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f.name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pso_family_generations_match_jax(case):
    name, kwargs, drawing_call, jax_draws = CASES[case]
    jalgo = getattr(jpso, name)(**kwargs)
    talgo = getattr(tpso, name)(**kwargs, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(11))
    tstate = interop.swarm_state(talgo, _numpy_tree(jstate), seed=2)
    _assert_states(tstate, jstate)  # the initial state crossed
    draws_used = 0
    for gen in range(4):
        first = gen == 0 and talgo.has_init_ask  # the first generation draws nothing
        ask = "init_ask" if first else "ask"
        tell = "init_tell" if first else "tell"
        if drawing_call == "ask" and not first:
            draws = jax_draws(jalgo, jstate)
            talgo._draw = lambda seed, draws=draws: draws
            draws_used += 1
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        np.testing.assert_allclose(tcand.numpy(), np.asarray(jcand), rtol=RTOL, atol=ATOL)
        fit = _tied_fitness(jcand)
        if drawing_call == "tell" and not first:
            draws = jax_draws(jalgo, jstate)
            talgo._draw = lambda seed, draws=draws: draws
            draws_used += 1
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        _assert_states(tstate, jstate)
    assert draws_used >= 3


def _sphere_best(algo, steps, seed=5, opt_direction="min", problem=None):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, problem or Sphere(), monitors=[mon], opt_direction=opt_direction,
                     device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


class _NegSphere(Problem):
    def evaluate(self, state, pop):
        return -torch.sum(pop**2, dim=-1), state


T_LB, T_UB = torch.from_numpy(LB), torch.from_numpy(UB)
# tests/test_so_pso.py:33-64 and tests/test_workflows.py:24-30, 46-58
THRESHOLDS = {
    "clpso": (lambda: tpso.CLPSO(T_LB, T_UB, pop_size=50, device="cpu"), 200, 0.5),
    "slpso_gs": (lambda: tpso.SLPSOGS(T_LB, T_UB, pop_size=100, device="cpu"), 200, 0.5),
    "slpso_us": (lambda: tpso.SLPSOUS(T_LB, T_UB, pop_size=100, device="cpu"), 200, 0.5),
    "fips": (lambda: tpso.FIPS(T_LB, T_UB, pop_size=64, topology="ring", device="cpu"), 200, 0.1),
    "dms_pso_el": (lambda: tpso.DMSPSOEL(T_LB, T_UB, pop_size=60, sub_swarm_size=10,
                                         max_iteration=200, device="cpu"), 200, 0.5),
    "swmmpso": (lambda: tpso.SwmmPSO(T_LB, T_UB, pop_size=64, device="cpu"), 200, 0.1),
    "swmmpso_shortcuts": (lambda: tpso.SwmmPSO(T_LB, T_UB, pop_size=64, shortcut_p=0.05,
                                               device="cpu"), 200, 0.5),
    "fspso": (lambda: tpso.FSPSO(pop_size=50, dim=DIM, device="cpu"), 100, 0.5),
    "pso_quickstart": (lambda: tpso.PSO(torch.full((2,), -10.0), torch.full((2,), 10.0), 100,
                                        device="cpu"), 20, 1e-2),
}


@pytest.mark.parametrize("case", sorted(THRESHOLDS))
def test_pso_family_converges_on_sphere(case):
    make, steps, threshold = THRESHOLDS[case]
    assert _sphere_best(make(), steps) < threshold


def test_pso_max_direction():
    algo = tpso.PSO(torch.full((2,), -10.0), torch.full((2,), 10.0), 50, device="cpu")
    best = _sphere_best(algo, 20, seed=42, opt_direction="max", problem=_NegSphere())
    assert -1e-2 < best <= 0.0


def test_topology_constructors_match_jax():
    for n, k in ((5, 1), (12, 2), (7, 3)):
        np.testing.assert_array_equal(ttopo.ring_neighbours(n, k, device="cpu").numpy(),
                                      np.asarray(jtopo.ring_neighbours(n, k)))
        np.testing.assert_array_equal(ttopo.circles_neighbours(n, k, device="cpu").numpy(),
                                      np.asarray(jtopo.circles_neighbours(n, k)))
    for n in (1, 6, 7, 12, 16, 30, 97, 1024):
        np.testing.assert_array_equal(ttopo.square_neighbours(n, device="cpu").numpy(),
                                      np.asarray(jtopo.square_neighbours(n)))
    np.testing.assert_array_equal(ttopo.full_neighbours(6, device="cpu").numpy(),
                                  np.asarray(jtopo.full_neighbours(6)))


def test_knn_adjacency_and_neighbour_lists_match_jax():
    """Integer grid points: every distance is exact in both libraries, and
    many are equal, so the k-th neighbour is a tie broken by index."""
    rng = np.random.default_rng(4)
    pos = rng.integers(-2, 3, size=(30, 2)).astype(np.float32)
    pos[5] = pos[6]  # duplicate points: distance 0 to two rows
    for k in (1, 3, 6):
        want = np.asarray(jtopo.knn_adjacency(jnp.asarray(pos), k))
        got = ttopo.knn_adjacency(torch.from_numpy(pos), k)
        np.testing.assert_array_equal(got.numpy(), want)
        for m in (4, 9, 30):
            idx, mask = ttopo.adjacency_to_neighbour_list(got, m)
            jidx, jmask = jtopo.adjacency_to_neighbour_list(jnp.asarray(want), m)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_neighbour_best_and_shortcuts_match_jax():
    fit = np.array([3.0, 1.0, 2.0, 0.5, 0.5, np.nan, 1.0, 1.0], np.float32)
    for nbrs in (jtopo.ring_neighbours(8, 1), jtopo.ring_neighbours(8, 2), jtopo.full_neighbours(8),
                 jtopo.circles_neighbours(8, 2)):
        nb = np.array(nbrs)
        mask = (np.arange(nb.shape[1])[None, :] + np.arange(8)[:, None]) % 3 != 1
        for m in (None, mask):
            want = jtopo.neighbour_best(jnp.asarray(fit), nbrs, None if m is None else jnp.asarray(m))
            got = ttopo.neighbour_best(torch.from_numpy(fit), torch.from_numpy(nb).long(),
                                       None if m is None else torch.from_numpy(m))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    adj = np.array(jtopo.knn_adjacency(jax.random.normal(jax.random.PRNGKey(0), (10, 3)), 2))
    key = jax.random.PRNGKey(3)
    flips = np.array(jax.random.bernoulli(key, 0.3, (10, 10)))
    want = np.asarray(jtopo.mutate_shortcuts(key, jnp.asarray(adj), 0.3))
    got = ttopo.mutate_shortcuts(0, torch.from_numpy(adj), 0.3, flips=torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = ttopo.mutate_shortcuts(0, torch.from_numpy(adj), 0.3)
    assert torch.equal(drawn, drawn.T)


def test_pso_migrate_matches_jax():
    jalgo = jpso.PSO(LB, UB, 10)
    talgo = tpso.PSO(LB, UB, 10, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(2))
    pop = np.asarray(jstate.population)
    fit = _tied_fitness(pop)
    jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
    tstate = interop.swarm_state(talgo, _numpy_tree(jstate))
    migrants = np.arange(3 * DIM, dtype=np.float32).reshape(3, DIM) / 10
    for mfit in (np.array([0.5, 7.0, -1.0], np.float32), np.array([9e9, 9e9, 9e9], np.float32)):
        jm = jalgo.migrate(jstate, jnp.asarray(migrants), jnp.asarray(mfit))
        tm = talgo.migrate(tstate, torch.from_numpy(migrants), torch.from_numpy(mfit))
        _assert_states(tm, jm)
