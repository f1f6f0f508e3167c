"""CSO and the bound repair of the port against the JAX package, on the CPU,
with JAX's draws handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.pso import CSO as JaxCSO
from evox_tpu.operators.sanitize import sanitize_bounds as jax_sanitize_bounds
from evox_tpu.operators.sanitize import validate_bound_handling as jax_validate
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.pso import CSO
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.operators.sanitize import BOUND_METHODS, sanitize_bounds, validate_bound_handling
from evox_tpu_torch.problems.numerical import Ackley

# CSO's positions and velocities are elementwise float32 arithmetic on the
# same draws, with one exception: the swarm center, a sum over the
# population, which XLA and PyTorch may add in different orders, and which
# only phi > 0 reads. So phi = 0 is held bit for bit; for phi > 0 an ulp of
# the center (|x| <= 4 here: ~5e-7) is scaled by phi * r3 <= 0.1 and
# carried over three generations, well inside 2e-6.
CSO_RTOL, CSO_ATOL = 1e-6, 2e-6


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bound_inputs():
    """Overshoots of many sizes across spans of 0 (a point), 2e-3, 0.3, 2,
    64 and 128, including bounds away from 0, and ±inf, NaN and ±0.0."""
    rng = np.random.default_rng(0)
    lb = np.array([-1, -32, 0, 5, -0.15, -64, 3, -1e-3], np.float32)
    ub = np.array([1, 32, 128, 5, 0.15, 64, 3, 1e-3], np.float32)
    scale = rng.choice([0.5, 1, 10, 100, 1e4, 1e7], size=(400, lb.size))
    x = (rng.normal(size=(400, lb.size)) * scale).astype(np.float32)
    x[0], x[1], x[2], x[3], x[4] = np.inf, -np.inf, np.nan, -0.0, 0.0
    x[5] = lb
    x[6] = ub
    x[7] = 2 * ub - lb  # exactly one span, two spans over
    x[8] = lb - 3 * (ub - lb)
    return x, lb, ub


@pytest.mark.parametrize("method", BOUND_METHODS)
def test_sanitize_bounds_matches_jax(method):
    x, lb, ub = _bound_inputs()
    want = np.asarray(jax_sanitize_bounds(jnp.asarray(x), jnp.asarray(lb), jnp.asarray(ub), method))
    got = sanitize_bounds(torch.from_numpy(x), torch.from_numpy(lb), torch.from_numpy(ub), method)
    np.testing.assert_array_equal(got.numpy(), want)  # NaN where NaN, equal elsewhere
    inside = np.isfinite(x).all(1)
    assert ((got.numpy()[inside] >= lb) & (got.numpy()[inside] <= ub)).all()
    # a span of 0 repairs to the point, never to NaN
    assert not np.isnan(got.numpy()[inside][:, 3]).any()


def test_validate_bound_handling_error_matches_jax():
    assert validate_bound_handling("wrap") == "wrap"
    with pytest.raises(ValueError) as ours:
        validate_bound_handling("bounce")
    with pytest.raises(ValueError) as theirs:
        jax_validate("bounce")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown bound_handling"):
        CSO(np.zeros(3), np.ones(3), 4, bound_handling="bounce", device="cpu")


def _jax_draws(jalgo, pair_key):
    """The permutation and r1, r2, r3 that JAX's ``_pair_pass`` derives
    from ``pair_key`` (cso.py:112-135)."""
    k_pair, k1, k2, k3 = jax.random.split(pair_key, 4)
    half = jalgo.pop_size // 2
    perm = jax.random.permutation(k_pair, jalgo.pop_size)
    rs = [jax.random.uniform(k, (half, jalgo.dim)) for k in (k1, k2, k3)]
    return tuple(torch.as_tensor(np.array(a)) for a in (perm, *rs))


def _tied_fitness(cand):
    """Sphere rounded to a coarse grid: many equal values, so pairs tie and
    the second row of the pair must win."""
    return np.round(np.sum(np.asarray(cand) ** 2, axis=1) / 200.0).astype(np.float32)


def _assert_state(tstate, jstate, rtol, atol):
    for name in ("population", "velocity"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(tstate.fitness.numpy(), np.asarray(jstate.fitness))


@pytest.mark.parametrize("method", BOUND_METHODS)
@pytest.mark.parametrize("phi", [0.0, 0.1])
@pytest.mark.parametrize("gens", [1, 3])
def test_cso_generations_match_jax(gens, phi, method):
    pop, dim = 16, 5
    lb, ub = -np.full(dim, 4.0, np.float32), np.full(dim, 4.0, np.float32)
    rtol, atol = (0.0, 0.0) if phi == 0 else (CSO_RTOL, CSO_ATOL)
    jalgo = JaxCSO(lb, ub, pop, phi=phi, bound_handling=method)
    talgo = CSO(lb, ub, pop, phi=phi, bound_handling=method, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(7))
    tstate = interop.swarm_state(talgo, _numpy_tree(jstate), seed=3)
    # the first generation evaluates everyone
    jcand, jstate = jalgo.init_ask(jstate)
    tcand, tstate = talgo.init_ask(tstate)
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
    fit = _tied_fitness(jcand)
    jstate = jalgo.init_tell(jstate, jnp.asarray(fit))
    tstate = talgo.init_tell(tstate, torch.from_numpy(fit))
    ties = 0
    for _ in range(gens):
        jcand, jstate = jalgo.ask(jstate)
        draws = _jax_draws(jalgo, jstate.pair_key)
        talgo._draw = lambda seed, draws=draws: draws
        pair_f = tstate.fitness[draws[0]].view(2, -1)
        ties += int((pair_f[0] == pair_f[1]).sum())
        tcand, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(tcand.numpy(), np.asarray(jcand), rtol=rtol, atol=atol)
        fit = _tied_fitness(jcand)
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, torch.from_numpy(fit))
        _assert_state(tstate, jstate, rtol, atol)
        assert tstate.pending is None
    assert ties > 0  # tied pairs were exercised


def test_cso_state_crosses_through_interop():
    lb, ub = -np.ones(4, np.float32), np.ones(4, np.float32)
    jalgo = JaxCSO(lb, ub, 10)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    jcand, jstate = jalgo.init_ask(jstate)
    jstate = jalgo.init_tell(jstate, jnp.sum(jcand**2, axis=1))
    talgo = CSO(lb, ub, 10, device="cpu")
    tstate = interop.swarm_state(talgo, _numpy_tree(jstate), seed=5)
    for name in ("population", "fitness", "velocity"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)))
    assert tstate.pending is None and tstate.seed == talgo.init(5).seed
    # and through the workflow's carry-over
    from evox_tpu import StdWorkflow as JaxStdWorkflow
    from evox_tpu.problems.numerical import Ackley as JaxAckley

    jwf = JaxStdWorkflow(jalgo, JaxAckley())
    jws = jwf.step(jwf.step(jwf.init(jax.random.PRNGKey(1))))
    twf = StdWorkflow(talgo, Ackley(), device="cpu")
    tws = interop.std_workflow_state(twf, _numpy_tree(jws))
    assert tws.generation == 2 and tws.first_step is False
    np.testing.assert_array_equal(tws.algo.population.numpy(), np.asarray(jws.algo.population))
    tws = twf.step(tws)  # the carried state steps on
    assert tws.algo.population.shape == (10, 4)


def test_cso_tell_needs_its_ask():
    talgo = CSO(-np.ones(2), np.ones(2), 4, device="cpu")
    state = talgo.init(0)
    with pytest.raises(ValueError, match="CSO.ask"):
        talgo.tell(state, torch.zeros(2))
    with pytest.raises(ValueError, match="even"):
        CSO(-np.ones(2), np.ones(2), 5, device="cpu")


def test_cso_ackley_convergence():
    """tests/test_workflows.py::test_cso_ackley_convergence through the
    port: d 2, pop 20, 100 generations, read through EvalMonitor(topk=2)."""
    algo = CSO(torch.full((2,), -32.0), torch.full((2,), 32.0), 20, device="cpu")
    mon = EvalMonitor(topk=2, device="cpu")
    wf = StdWorkflow(algo, Ackley(), monitors=[mon], device="cpu")
    state = wf.run(wf.init(42), 100)
    best = float(mon.get_best_fitness(state.monitors[0]))
    assert best < 1e-3
    topk = mon.get_topk_fitness(state.monitors[0])
    assert topk.shape == (2,) and topk[0] <= topk[1]
    # the first batch is the whole population, every later one half of it
    assert state.algo.population.shape == (20, 2) and state.generation == 100
