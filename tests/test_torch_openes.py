"""OpenES, its optimizers and the fitness utilities of the port against the
JAX package, on the CPU, with JAX's noise handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.utils.common import parse_opt_direction as jax_parse_opt_direction
from evox_tpu.utils.common import rank_based_fitness as jax_rank_based_fitness
from evox_tpu.workflows.common import quarantine_nonfinite as jax_quarantine
from evox_tpu_torch import interop
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.utils import make_optimizer, parse_opt_direction, rank_based_fitness
from evox_tpu_torch.workflows.common import quarantine_nonfinite

# One ask/tell is a (pop/2, dim) x (pop/2,) product and an elementwise
# update in float32; the two libraries sum the product in different orders.
CENTER_RTOL, CENTER_ATOL = 1e-5, 1e-6


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _substitute_noise(algo, halves):
    """Make the port's one draw method return JAX's draws: the n-th new
    noise seed it sees gets the n-th JAX half (ask and tell of a generation
    share a seed)."""
    by_seed = {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.as_tensor(np.array(halves[len(by_seed)]))
        return by_seed[seed]

    algo._draw_noise = draw


@pytest.mark.parametrize("optimizer", [None, "adam"], ids=["sgd", "adam"])
def test_open_es_ask_tell_matches_jax(optimizer):
    pop_size, dim, gens = 16, 7, 3
    rng = np.random.default_rng(0)
    center0 = rng.normal(size=dim).astype(np.float32)
    jalgo = JaxOpenES(center0, pop_size, learning_rate=0.1, noise_stdev=0.05, optimizer=optimizer)
    talgo = OpenES(center0, pop_size, learning_rate=0.1, noise_stdev=0.05, optimizer=optimizer,
                   device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(3))
    tstate = interop.open_es_state(talgo, _numpy_tree(jstate), seed=11)
    np.testing.assert_array_equal(tstate.center.numpy(), center0)

    halves = []
    for _ in range(gens):  # several tells: adam's bias correction counts
        jpop, jstate = jalgo.ask(jstate)
        halves.append(np.asarray(jax.random.normal(jstate.noise_key, (pop_size // 2, dim))))
        fitness = rng.normal(size=pop_size).astype(np.float32)
        jstate = jalgo.tell(jstate, jnp.asarray(fitness))
        _substitute_noise(talgo, halves[-1:])
        tpop, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop), rtol=1e-6, atol=1e-7)
        tstate = talgo.tell(tstate, torch.as_tensor(fitness))
        np.testing.assert_allclose(
            tstate.center.numpy(), np.asarray(jstate.center), rtol=CENTER_RTOL, atol=CENTER_ATOL
        )
    if optimizer == "adam":
        leaf = jstate.opt_state[0]
        assert tstate.opt_state.count == int(leaf.count) == gens
        np.testing.assert_allclose(tstate.opt_state.mu.numpy(), np.asarray(leaf.mu), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tstate.opt_state.nu.numpy(), np.asarray(leaf.nu), rtol=1e-5, atol=1e-9)
        # the adam state crosses through interop as well
        carried = interop.open_es_state(talgo, _numpy_tree(jstate))
        assert carried.opt_state.count == gens
        np.testing.assert_array_equal(carried.opt_state.mu.numpy(), np.asarray(leaf.mu))


def test_open_es_without_mirroring_matches_jax():
    pop_size, dim = 6, 4
    center0 = np.zeros(dim, np.float32)
    jalgo = JaxOpenES(center0, pop_size, noise_stdev=0.1, mirrored_sampling=False)
    talgo = OpenES(center0, pop_size, noise_stdev=0.1, mirrored_sampling=False, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    jpop, jstate = jalgo.ask(jstate)
    noise = np.asarray(jax.random.normal(jstate.noise_key, (pop_size, dim)))
    fitness = np.arange(pop_size, dtype=np.float32)
    jstate = jalgo.tell(jstate, jnp.asarray(fitness))
    _substitute_noise(talgo, [noise])
    tstate = interop.open_es_state(talgo, _numpy_tree(jalgo.init(jax.random.PRNGKey(0))))
    tpop, tstate = talgo.ask(tstate)
    tstate = talgo.tell(tstate, torch.as_tensor(fitness))
    np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstate.center.numpy(), np.asarray(jstate.center),
                               rtol=CENTER_RTOL, atol=CENTER_ATOL)


def test_open_es_regenerates_the_same_noise_in_ask_and_tell():
    """No (pop, dim) buffer is stored: tell rebuilds ask's draw from the
    generation's seed."""
    algo = OpenES(np.zeros(5), 8, noise_stdev=1.0, device="cpu")
    state = algo.init(0)
    pop, state = algo.ask(state)
    half = algo._draw_noise(state.noise_seed)
    torch.testing.assert_close(pop, torch.cat([half, -half]), rtol=0, atol=0)
    pop2, state2 = algo.ask(state)
    assert state2.noise_seed != state.noise_seed and not torch.equal(pop, pop2)


def test_open_es_rejects_bad_arguments():
    with pytest.raises(ValueError, match="even"):
        OpenES(np.zeros(3), 5, device="cpu")
    with pytest.raises(ValueError, match="> 0"):
        OpenES(np.zeros(3), 4, learning_rate=0.0, device="cpu")
    assert type(make_optimizer("rmsprop", 0.1)).__name__ == "RMSProp"
    with pytest.raises(ValueError, match="gradient transformation, not an optimizer"):
        make_optimizer("clip", 0.1)  # refused, with the reason


@pytest.mark.parametrize(
    "values",
    [
        [3.0, 1.0, 2.0, 0.5, 7.0],
        [1.0, 1.0, 0.0, 1.0, 0.0, 2.0],  # ties rank in index order
        [0.0, -0.0, 5.0, 5.0, 5.0, -1.0, np.inf, -np.inf],
    ],
    ids=["distinct", "ties", "signed-zero-inf"],
)
def test_rank_based_fitness_matches_jax_exactly(values):
    x = np.asarray(values, np.float32)
    want = np.asarray(jax_rank_based_fitness(jnp.asarray(x)))
    got = rank_based_fitness(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("direction", ["min", "max", ["min", "max", "max"]])
def test_parse_opt_direction_matches_jax_exactly(direction):
    got = parse_opt_direction(direction)
    want = np.asarray(jax_parse_opt_direction(direction))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_opt_direction_rejects_unknown():
    with pytest.raises(ValueError, match="'min' or 'max'"):
        parse_opt_direction("up")


@pytest.mark.parametrize("shape", [(7,), (6, 2)])
def test_quarantine_nonfinite_matches_jax_exactly(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x.reshape(-1)[[0, 3]] = [np.nan, np.inf]
    if len(shape) == 2:
        x[:, 1] = np.nan  # a column with no finite entry
    want = np.asarray(jax_quarantine(jnp.asarray(x)))
    got = quarantine_nonfinite(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
