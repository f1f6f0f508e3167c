"""IM-MOEA in the port against the JAX package on the CPU: one ``ask`` on
JAX's draws (the batched inverse-GP fits and samples), one ``tell`` on the
same merged fitness, and the DTLZ2 IGD gate of
``tests/test_mo_algorithms.py`` run on the port."""

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.mo.im_moea import IMMOEA as JaxIMMOEA
from evox_tpu.problems.numerical import DTLZ2 as JaxDTLZ2
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.mo import IMMOEA
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.problems.numerical import DTLZ2

M, DIM = 3, 7  # tests/test_mo_algorithms.py's shape
LB, UB = np.zeros(DIM, np.float32), np.ones(DIM, np.float32)
# The offspring are GP samples: 10 adam steps on each of the K x d inverse
# models' likelihoods (XLA and PyTorch factor and sum in other orders, and
# adam's first steps follow the gradients' signs), then a posterior mean
# and standard deviation, the polynomial mutation and the clip. Measured
# 2.6e-4 at most and 1e-5 on average on [0, 1] variables.
OFFSPRING_ATOL, OFFSPRING_MEAN_ATOL = 2e-3, 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_draws(algo, state):
    """JAX IM-MOEA's ask draws from its state, in the port's ``_draw`` layout
    (as JAX arrays)."""
    _, k_assign, k_sample, k_m = jax.random.split(state.key, 4)
    K, d, S, n = algo.K, algo.dim, algo.S, algo.pop_size

    def per_model(kk):
        k_target, k_post = jax.random.split(kk)
        return jax.random.uniform(k_target, (S,)), jax.random.normal(k_post, (S,))

    u, z = jax.vmap(jax.vmap(per_model))(jax.random.split(k_sample, K * d).reshape(K, d, 2))
    k1, k2 = jax.random.split(k_m)
    return {"obj_pick": jax.random.randint(k_assign, (K, d), 0, algo.n_objs),
            "u_target": u, "z_post": z,
            "site": jax.random.uniform(k1, (n, d)) < 1.0 / d,
            "u_pm": jax.random.uniform(k2, (n, d))}


@pytest.fixture(scope="module")
def jax_generation():
    """A JAX state after the init step, its ask, DTLZ2 on the offspring and
    its tell."""
    algo = JaxIMMOEA(LB, UB, n_objs=M, pop_size=100)
    problem = JaxDTLZ2(d=DIM, m=M)

    @jax.jit
    def generation(key):  # one compiled program for every JAX reference
        state = algo.init(key)
        state = algo.init_tell(state, problem.evaluate(None, state.population)[0])
        off, asked = algo.ask(state)
        off_fit, _ = problem.evaluate(None, off)
        return state, asked, off_fit, algo.tell(asked, off_fit), _jax_draws(algo, state)

    *states, draws = generation(jax.random.PRNGKey(0))
    return algo, jax.tree.map(np.asarray, tuple(states)), {k: _t(v) for k, v in draws.items()}


def test_one_ask_matches_jax_on_its_draws(jax_generation):
    jalgo, (state, asked, _, _), draws = jax_generation
    algo = IMMOEA(LB, UB, n_objs=M, pop_size=100, device="cpu")
    assert (algo.K, algo.S, algo.pop_size) == (jalgo.K, jalgo.S, jalgo.pop_size) == (3, 33, 99)
    np.testing.assert_array_equal(algo.dirs.numpy(), np.asarray(jalgo.dirs))
    algo._draw = lambda seed: draws
    off, new = algo.ask(interop.algorithm_state(algo, state))
    diff = np.abs(off.numpy() - asked.offspring)
    assert diff.max() <= OFFSPRING_ATOL and diff.mean() <= OFFSPRING_MEAN_ATOL
    assert torch.equal(new.offspring, off)
    assert bool(((off >= 0) & (off <= 1)).all())


def test_one_tell_matches_jax_on_the_same_merged_fitness(jax_generation):
    # both tells get JAX's offspring and their fitness: survivors and order equal
    jalgo, (_, asked, off_fit, told), _ = jax_generation
    algo = IMMOEA(LB, UB, n_objs=M, pop_size=100, device="cpu")
    state = interop.algorithm_state(algo, asked)
    new = algo.tell(state, _t(off_fit))
    np.testing.assert_array_equal(new.population.numpy(), told.population)
    np.testing.assert_array_equal(new.fitness.numpy(), told.fitness)


def test_dtlz2_igd_gate():
    # tests/test_mo_algorithms.py::test_immoea_dtlz2_igd on the port
    problem = DTLZ2(d=DIM, m=M, device="cpu")
    wf = StdWorkflow(IMMOEA(LB, UB, n_objs=M, pop_size=100, device="cpu"), problem, device="cpu")
    state = wf.run(wf.init(3), 100)
    fit = state.algo.fitness
    fit = torch.where(torch.isfinite(fit).all(dim=1, keepdim=True), fit, 1e6)
    assert float(igd(fit, problem.pf())) < 0.25


def test_device_defaults_to_cuda_and_mesh_waits():
    if torch.cuda.is_available():
        assert IMMOEA(LB, UB, n_objs=M, pop_size=100).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IMMOEA(LB, UB, n_objs=M, pop_size=100)
    # the mesh is ported: the tell's selection sorts row-sharded, with the
    # same survivors as the unsharded sort's
    from evox_tpu_torch.core.distributed import create_mesh
    from evox_tpu_torch.operators.selection import non_dominate

    algo = IMMOEA(LB, UB, n_objs=M, pop_size=100, mesh=create_mesh(devices=["cpu"] * 4),
                  device="cpu")
    assert algo.mesh.shape == {"pop": 4}
    rng = np.random.default_rng(0)
    pop = torch.from_numpy(rng.random((200, DIM), dtype=np.float32))
    fit = torch.from_numpy(rng.integers(0, 6, (200, M)).astype(np.float32))
    sharded = non_dominate(pop, fit, 100, mesh=algo.mesh)
    plain = non_dominate(pop, fit, 100)
    assert torch.equal(sharded[0], plain[0]) and torch.equal(sharded[1], plain[1])
