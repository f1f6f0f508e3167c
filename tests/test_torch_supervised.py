"""The port's supervised problems (``evox_tpu_torch/problems/supervised``)
against the JAX package on the CPU: ``InMemoryDataLoader``'s batches index
for index, ``DatasetProblem``'s losses, stream order and probe batch, and
the validation twin and its metric views, with the JAX package's own
host-problem tests (``tests/test_host_problems.py``) carried over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.problems.supervised import DatasetProblem as JaxDatasetProblem
from evox_tpu.problems.supervised import InMemoryDataLoader as JaxLoader
from evox_tpu_torch import StdWorkflow, member_call
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.supervised import (
    DatasetProblem,
    InMemoryDataLoader,
    TensorflowDataset,
)

# A linear-regression loss is a length-8 dot product and a mean over the
# batch in float32; numpy-fed XLA and PyTorch's CPU kernels sum them in
# different orders, a few ulps apart.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def _linreg_setup(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d,))
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    data = {"x": X, "y": y, "i": np.arange(n, dtype=np.int32)}
    return data, w_true


def _loss(w, batch):
    return torch.mean((batch["x"] @ w - batch["y"]) ** 2)


def _jax_loss(w, batch):
    return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)


def _first_index(w, batch):  # which batch a call saw: its first row's index
    return batch["i"][0].to(torch.float32) + 0.0 * w.sum()


def _jax_first_index(w, batch):
    return batch["i"][0].astype(jnp.float32) + 0.0 * jnp.sum(w)


@pytest.mark.parametrize("batch_size,seed", [(4, 1), (3, 7), (10, 0)])
def test_loader_batches_equal_jax_index_for_index(batch_size, seed):
    data = {"x": np.arange(30, dtype=np.float32).reshape(10, 3), "y": np.arange(10) * 2}
    ours, ref = InMemoryDataLoader(data, batch_size, seed), JaxLoader(data, batch_size, seed)
    for _ in range(9):  # several epochs
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_inmemory_loader_epochs():
    data = {"x": np.arange(10), "y": np.arange(10) * 2}
    loader = InMemoryDataLoader(data, batch_size=4, seed=1)
    seen = []
    for _ in range(5):
        b = next(loader)
        assert b["x"].shape == (4,)
        np.testing.assert_array_equal(b["y"], b["x"] * 2)
        seen.extend(b["x"].tolist())
    assert len(set(seen[:8])) == 8  # no example repeats before the epoch flips
    with pytest.raises(ValueError, match="batch_size"):
        InMemoryDataLoader(data, batch_size=11)


def test_losses_probe_and_stream_order_match_jax():
    """The same loader stream through both problems: the probe batch is
    scored first, then one new batch a call, the score function switched
    call by call (the loss, then which batch was seen)."""
    data, _ = _linreg_setup()
    pop = np.random.default_rng(3).normal(size=(6, 8)).astype(np.float32)
    ours = DatasetProblem(InMemoryDataLoader(data, 32, seed=7), _loss, device="cpu")
    ref = JaxDatasetProblem(JaxLoader(data, 32, seed=7), _jax_loss)
    first = JaxLoader(data, 32, seed=7)
    for call in range(8):  # 8 x 32 = one epoch, then into the next
        expect = next(first)
        if call % 2:
            f, _ = ours.evaluate(None, torch.from_numpy(pop), loss_func=_first_index)
            g, _ = ref.evaluate(None, jnp.asarray(pop), loss_func=_jax_first_index)
            np.testing.assert_array_equal(f.numpy(), np.asarray(g))
            assert f[0].item() == expect["i"][0]
        else:
            f, _ = ours.evaluate(None, torch.from_numpy(pop))
            g, _ = ref.evaluate(None, jnp.asarray(pop))
            assert f.dtype == torch.float32 and f.shape == (6,)
            np.testing.assert_allclose(f.numpy(), np.asarray(g), rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_validation_views_share_the_twin_stream_as_jax():
    data, _ = _linreg_setup(seed=1)
    vdata, _ = _linreg_setup(n=128, seed=5)
    pop = np.random.default_rng(4).normal(size=(4, 8)).astype(np.float32)
    ours = DatasetProblem(InMemoryDataLoader(data, 64, seed=3), _loss,
                          valid_iterator=lambda: InMemoryDataLoader(vdata, 16, seed=4),
                          device="cpu")
    ref = JaxDatasetProblem(JaxLoader(data, 64, seed=3), _jax_loss,
                            valid_iterator=lambda: JaxLoader(vdata, 16, seed=4))
    assert ours.valid() is ours.valid()  # one twin, built once
    views = [(lambda p: p.valid(), None), (lambda p: p.valid(metric=_first_index), _jax_first_index)]
    for step in range(5):
        make, jax_metric = views[step % 2]
        mine = make(ours)
        theirs = ref.valid() if jax_metric is None else ref.valid(metric=jax_metric)
        f, _ = mine.evaluate(mine.init(), torch.from_numpy(pop))
        g, _ = theirs.evaluate(None, jnp.asarray(pop))
        np.testing.assert_allclose(f.numpy(), np.asarray(g), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    # the training stream was not touched by validation: its probe is next
    f, _ = ours.evaluate(None, torch.from_numpy(pop), loss_func=_first_index)
    assert f[0].item() == next(InMemoryDataLoader(data, 64, seed=3))["i"][0]
    with pytest.raises(ValueError, match="valid_iterator"):
        DatasetProblem(InMemoryDataLoader(data, 64), _loss, device="cpu").valid()


def test_dataset_problem_scalar_leaves_match_jax():
    """Loaders may yield Python scalars: they become arrays (and tensors)
    of the declared dtypes."""

    def gen():
        while True:
            yield {"x": np.ones((4, 2), np.float32), "w": 0.5, "k": 3}

    ours = DatasetProblem(gen(), lambda p, b: torch.sum(p) * b["w"] + torch.sum(b["x"]) + b["k"],
                          device="cpu")
    ref = JaxDatasetProblem(gen(), lambda p, b: jnp.sum(p) * b["w"] + jnp.sum(b["x"]) + b["k"])
    f, _ = ours.evaluate(None, torch.ones((3, 2)))
    g, _ = jax.jit(ref.evaluate)(None, jnp.ones((3, 2)))
    assert f.shape == (3,) and f.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy(), np.asarray(g))
    np.testing.assert_array_equal(f.numpy(), np.full((3,), 2 * 0.5 + 8 + 3, np.float32))


def test_x64_coercion():
    data = {"x": np.arange(8, dtype=np.int64), "y": np.ones(8, dtype=np.float64)}
    seen = []

    def loss(w, b):
        seen.append((b["x"].dtype, b["y"].dtype))
        return torch.sum(w) + torch.sum(b["y"])

    prob = DatasetProblem(InMemoryDataLoader(data, batch_size=4), loss, device="cpu")
    f, _ = prob.evaluate(None, torch.zeros((2, 1)))
    assert f.dtype == torch.float32
    assert seen[0] == (torch.int32, torch.float32)


def test_dataset_problem_batch_order_deterministic():
    data, _ = _linreg_setup()
    fits = []
    for _ in range(2):
        prob = DatasetProblem(InMemoryDataLoader(data, batch_size=32, seed=7), _loss, device="cpu")
        pop = torch.ones((4, 8)) * torch.arange(4.0)[:, None]
        f1, state = prob.evaluate(prob.init(), pop)
        f2, _ = prob.evaluate(state, pop)
        fits.append((f1, f2))
    assert torch.equal(fits[0][0], fits[1][0]) and torch.equal(fits[0][1], fits[1][1])
    assert not torch.allclose(fits[0][0], fits[0][1])  # two generations, two batches


def test_dataset_problem_trains_linear_regression():
    data, w_true = _linreg_setup()
    prob = DatasetProblem(InMemoryDataLoader(data, batch_size=64, seed=3), _loss, device="cpu")
    algo = OpenES(torch.zeros(len(w_true)), pop_size=128, learning_rate=0.1, noise_stdev=0.2,
                  device="cpu")
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, prob, monitors=(mon,), device="cpu")
    state = wf.run(wf.init(0), 150)
    best = float(mon.get_best_fitness(state.monitors[0]))
    assert best < 0.5, f"linreg loss {best}"


def test_dataset_problem_validation_mode():
    """``valid()`` scores on the held-out stream through
    ``StdWorkflow.validate`` without advancing training; a custom metric
    goes through ``valid(metric=...)``."""
    data, w_true = _linreg_setup(seed=1)
    vrng = np.random.default_rng(5)
    Xv = vrng.normal(size=(256, len(w_true))).astype(np.float32)
    valid_data = {"x": Xv, "y": (Xv @ w_true).astype(np.float32)}
    prob = DatasetProblem(
        InMemoryDataLoader(data, batch_size=64, seed=3), _loss,
        valid_iterator=InMemoryDataLoader(valid_data, batch_size=128, seed=4), device="cpu",
    )
    algo = OpenES(torch.zeros(len(w_true)), pop_size=64, learning_rate=0.1, noise_stdev=0.2,
                  device="cpu")
    wf = StdWorkflow(algo, prob, device="cpu")
    state = wf.run(wf.init(0), 120)
    train_fit = wf.validate(state)
    val_fit = wf.validate(state, problem=prob.valid())
    assert float(train_fit.mean()) < 2.0 and float(val_fit.mean()) < 2.0
    mae = prob.valid(metric=lambda w, b: torch.mean(torch.abs(b["x"] @ w - b["y"])))
    assert wf.validate(state, problem=mae).shape == val_fit.shape


def test_dataset_problem_refuses_a_stacked_member_call():
    data, _ = _linreg_setup()
    prob = DatasetProblem(InMemoryDataLoader(data, batch_size=8), _loss, device="cpu")
    with pytest.raises(NotImplementedError, match="member"):
        member_call(lambda pop: prob.evaluate(None, pop)[0], torch.zeros((2, 4, 8)))


def test_tensorflow_dataset_refusal():
    with pytest.raises(ImportError, match="tensorflow-datasets"):
        TensorflowDataset("mnist", 32, _loss, device="cpu")
