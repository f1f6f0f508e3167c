"""LES of the port against the JAX package, on the CPU: its bundled
parameters (the port's copy of ``les_params.npz``, unravelled in
``ravel_pytree``'s order) against ``interop.les_params`` of the JAX
``load_params()``; its two networks against flax's; four generations with
JAX's draws handed to the port (``algo._draw``) and the state carried
across through ``interop.les_state``; the bundled file's copy; and the
JAX package's LES gate (``tests/test_so_es.py::test_les_runs``)."""

import dataclasses
import filecmp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.es import LES as JLES
from evox_tpu.algorithms.so.es import les_meta as jles_meta
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.es import LES
from evox_tpu_torch.algorithms.so.es import les as tles
from evox_tpu_torch.algorithms.so.es import les_meta
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import Sphere

REPO = Path(__file__).resolve().parents[1]
DIM, POP = 7, 16
# A generation's tell is three float32 products over pop 16 (the attention
# logits over 3 features, w @ pop and w @ (pop - mean)^2), two softmaxes, a
# std over the population and the lr network's products over 6 and 16
# inputs; XLA and PyTorch sum them in other orders and take exp, tanh and
# the sigmoid by other routines: a few ulps of each, 2e-6 relative with a
# 1e-6 floor for paths near 0.
RTOL, ATOL = 2e-6, 1e-6


def _leaves(params):
    return [(f"{net}.{layer}.{kind}", params[net][layer][kind])
            for net, layer, _, _ in les_meta.LAYERS for kind in ("bias", "kernel")]


def test_bundled_params_equal_jax_load_params():
    """The port's copy of the file, unravelled by the port, equals the JAX
    package's ``load_params()`` mapped by ``interop.les_params`` exactly:
    the layout of the 214 floats is ravel_pytree's."""
    assert filecmp.cmp(les_meta.PARAMS_PATH, Path(jles_meta.PARAMS_PATH), shallow=False)
    assert les_meta.PARAMS_PATH.resolve().is_relative_to(REPO / "evox_tpu_torch")
    ours = les_meta.load_params(device="cpu")
    theirs = interop.les_params(jax.tree.map(np.asarray, jles_meta.load_params()), device="cpu")
    assert les_meta.N_PARAMS == 214
    for (name, a), (_, b) in zip(_leaves(ours), _leaves(theirs)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    flat = np.load(les_meta.PARAMS_PATH)["flat"]
    np.testing.assert_array_equal(torch.cat([v.reshape(-1) for _, v in _leaves(ours)]).numpy(), flat)
    assert les_meta.load_params(REPO / "no_such_file.npz", device="cpu") is None


def test_networks_match_flax():
    jalgo = JLES(jnp.zeros(DIM), pop_size=POP)
    params = interop.les_params(jax.tree.map(np.asarray, jalgo.params), device="cpu")
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(POP, 3)).astype(np.float32)
    paths = rng.normal(size=(DIM, 6)).astype(np.float32)
    want_w = jalgo.weight_net.apply(jalgo.params["weights"], jnp.asarray(feats))
    want_lr = jalgo.lr_net.apply(jalgo.params["lr"], jnp.asarray(paths))
    got_w = tles.attention_weights(params["weights"], torch.from_numpy(feats))
    got_lr = tles.lr_modulator(params["lr"], torch.from_numpy(paths))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(want_lr), rtol=RTOL, atol=ATOL)


def _tied(pop):
    """A shifted Sphere on a coarse grid: tied fitness among candidates."""
    x = np.asarray(pop, np.float64)
    return np.round(np.sum((x - 0.5) ** 2, axis=1) * 2.0).astype(np.float32)


@pytest.mark.parametrize("params", ["auto", "random"])
def test_les_generations_match_jax(params):
    center = np.linspace(-1.0, 2.0, DIM).astype(np.float32)
    jalgo = JLES(jnp.asarray(center), init_stdev=0.8, pop_size=POP,
                 params="auto" if params == "auto" else None)
    talgo = LES(center, init_stdev=0.8, pop_size=POP, device="cpu",
                params="auto" if params == "auto" else
                interop.les_params(jax.tree.map(np.asarray, jalgo.params), device="cpu"))
    jstate = jalgo.init(jax.random.PRNGKey(4))
    for gen in range(4):
        tstate = interop.les_state(talgo, jax.tree.map(np.asarray, jstate), seed=gen)
        _, k = jax.random.split(jstate.key)
        z = torch.from_numpy(np.array(jax.random.normal(k, (POP, DIM))))
        talgo._draw = lambda seed, z=z: z
        jcand, jstate = jalgo.ask(jstate)
        tcand, tstate = talgo.ask(tstate)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))  # mean + sigma * z
        fit = _tied(jcand)
        jstate = jalgo.tell(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, torch.from_numpy(fit))
        for f in dataclasses.fields(tstate):
            if f.name != "seed":
                np.testing.assert_allclose(getattr(tstate, f.name).numpy(),
                                           np.asarray(getattr(jstate, f.name)),
                                           rtol=RTOL, atol=ATOL, err_msg=f.name)


def _best(algo, steps, seed=17):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, Sphere(), monitors=[mon], device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


def test_les_runs():
    """tests/test_so_es.py's LES gate, untrained parameters: progress, not
    convergence."""
    algo = LES(torch.full((5,), 3.0), init_stdev=1.0, pop_size=32, params=None, device="cpu")
    assert _best(algo, 100) < _best(algo, 1) * 10
    trained = LES(torch.full((5,), 3.0), init_stdev=1.0, pop_size=32, device="cpu")
    assert _best(trained, 100) < _best(trained, 1)


def test_les_entry_points_refuse_a_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LES(np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        les_meta.load_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.les_params(jax.tree.map(np.asarray, jles_meta.load_params()))
    LES(np.zeros(3), device="cpu")
