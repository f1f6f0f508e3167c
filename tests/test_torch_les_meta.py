"""LES's meta-training in the port (``evox_tpu_torch/algorithms/so/es/
les_meta.py``) against the JAX package's, on the CPU: ``task_eval`` on JAX's
own ``sample_task`` output for every family, ``les_score`` with JAX's inner
draws injected (its key flow replayed here), one meta-step at a small size
with JAX's tasks and draws fed in, a port-only meta-training gate, and the
parameters' save/load round trip. The bundled ``data/les_params.npz`` is
never written."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.es import les_meta as jles_meta
from evox_tpu.algorithms.so.es.open_es import OpenES as JaxOpenES
from evox_tpu.utils import rank_based_fitness as jax_rank_based_fitness
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.es import LES, les_meta
from evox_tpu_torch.core.problem import Problem

DIM, POP = 8, 16
# task_eval: a (pop, 8) @ (8, 8) product and sums of 8 and 16 terms, which
# XLA and PyTorch add in other orders (~4e-7 relative); rastrigin's
# 10 * dim + sum(y**2 - 10 cos(2 pi y)) cancels terms, up to 2.9e-6 measured.
EVAL_RTOL = 1e-5
# les_score: each generation's tell sums over 16 candidates and 3 features
# in another order (~1e-7 relative); rastrigin's cos(2 pi y) and the rank
# features magnify that over generations. At 5 generations the log10-gaps
# agree to 2e-5 measured (3 task seeds, every family); the bound is 1e-4.
SCORE_ATOL = 1e-4


def _jax_tasks(seed, n, families=None):
    tasks = jax.vmap(lambda k: jles_meta.sample_task(k, DIM))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    if families is not None:
        tasks["type"] = jnp.asarray(families, dtype=jnp.int32)
    return tasks


def _tensors(tasks):
    return {k: torch.from_numpy(np.array(v)) for k, v in tasks.items()}


def _inner_noise(run_keys, gens, pop=POP):
    """LES's draws in ``les_score``, replayed: ``init(key)`` keeps the key
    and each ask splits it and draws ``(pop, dim)`` normals;
    ``(gens, tasks, pop, dim)``."""
    noise = np.zeros((gens, len(run_keys), pop, DIM), np.float32)
    for t, key in enumerate(run_keys):
        for g in range(gens):
            key, k = jax.random.split(key)
            noise[g, t] = np.asarray(jax.random.normal(k, (pop, DIM)))
    return torch.from_numpy(noise)


@pytest.fixture
def jax_probe_inputs(monkeypatch):
    """The port's probe inputs set to the JAX module's, as this process's
    XLA computed them at import (the suite's XLA optimisation level rounds
    ``jnp.linspace``'s steps otherwise than the default one, by an ulp or
    two), so a comparison holds the arithmetic alone."""
    monkeypatch.setattr(les_meta, "_MLP_INPUTS", np.asarray(jles_meta._MLP_INPUTS))
    les_meta.mlp_inputs.cache_clear()
    yield
    les_meta.mlp_inputs.cache_clear()


def test_probe_inputs_and_port_tasks():
    # the port's constant is XLA's float32 linspace at its default
    # optimisation level; any level agrees to two ulps
    np.testing.assert_allclose(les_meta._MLP_INPUTS, np.asarray(jles_meta._MLP_INPUTS),
                               rtol=0, atol=2.4e-7)
    tasks = les_meta.sample_tasks(3, 6, DIM, device="cpu")
    assert tasks["rot"].shape == (6, DIM, DIM) and tasks["teacher"].shape == (6, 16)
    eye = torch.eye(DIM).expand(6, DIM, DIM)
    torch.testing.assert_close(tasks["rot"] @ tasks["rot"].transpose(1, 2), eye,
                               rtol=0, atol=1e-5)  # a rotation
    assert bool(((tasks["type"] >= 0) & (tasks["type"] < 5)).all())
    assert bool(((tasks["alphas"] >= 1) & (tasks["alphas"] <= 1000)).all())
    one = les_meta.sample_task(3, DIM, device="cpu")
    assert one["shift"].shape == (DIM,) and one["type"].shape == ()


@pytest.mark.parametrize("seed", [0, 1])
def test_task_eval_every_family_matches_jax(seed, jax_probe_inputs):
    tasks = _jax_tasks(seed, 5, families=range(5))
    x = (2.0 * np.random.default_rng(seed).normal(size=(5, POP, DIM))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jles_meta.task_eval))(tasks, jnp.asarray(x)))
    got = torch.func.vmap(les_meta.task_eval)(_tensors(tasks), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=EVAL_RTOL)
    # one task at a time, as the JAX function takes it
    one = {k: v[2] for k, v in _tensors(tasks).items()}
    np.testing.assert_allclose(les_meta.task_eval(one, torch.from_numpy(x[2])).numpy(), want[2],
                               rtol=EVAL_RTOL)


@pytest.mark.parametrize("seed", [7, 8])
def test_les_score_with_jax_draws(seed, jax_probe_inputs):
    tasks = _jax_tasks(seed, 5, families=range(5))
    params = jles_meta.load_params()
    run_keys = jax.random.split(jax.random.PRNGKey(seed + 100), 5)
    gens = 5
    want = np.asarray(jax.jit(jax.vmap(
        lambda t, k: jles_meta.les_score(params, t, k, DIM, POP, gens)))(tasks, run_keys))
    flat = np.asarray(ravel_pytree(params)[0])
    # two candidates: the bundled parameters and a perturbed copy
    flat2 = flat + 0.1 * np.random.default_rng(seed).normal(size=flat.shape).astype(np.float32)
    want2 = np.asarray(jax.jit(jax.vmap(lambda t, k: jles_meta.les_score(
        ravel_pytree(params)[1](jnp.asarray(flat2)), t, k, DIM, POP, gens)))(tasks, run_keys))
    got = les_meta.les_score(les_meta.unravel(np.stack([flat, flat2])), _tensors(tasks),
                             _inner_noise(run_keys, gens)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got[1], want2, rtol=0, atol=SCORE_ATOL)


def test_one_meta_step_matches_jax(jax_probe_inputs):
    """The JAX package's meta-step (``les_meta.py``'s ``meta_step``) at
    outer pop 4, 2 tasks and 3 inner generations, built from its own
    functions, against :meth:`MetaTrainer.step` with JAX's tasks, inner
    draws and outer noise handed to the port's three draw methods."""
    outer_pop, n_tasks, gens = 4, 2, 3
    flat0, _ = ravel_pytree(jles_meta._template_params(POP, DIM))
    outer = JaxOpenES(flat0, outer_pop, learning_rate=jles_meta.OUTER_LR,
                      noise_stdev=jles_meta.OUTER_STD)
    key = jax.random.PRNGKey(5)
    ostate = outer.init(key)
    key, k = jax.random.split(key)
    k_task, k_run = jax.random.split(k)
    tasks = jax.vmap(lambda kk: jles_meta.sample_task(kk, DIM))(jax.random.split(k_task, n_tasks))
    tasks["type"] = jnp.arange(n_tasks, dtype=jnp.int32) % jles_meta.N_FAMILIES
    run_keys = jax.random.split(k_run, n_tasks)
    start = jax.tree.map(np.asarray, ostate)
    cand, ostate = outer.ask(ostate)
    half = np.asarray(jax.random.normal(ostate.noise_key, (outer_pop // 2, flat0.shape[0])))
    params_of = ravel_pytree(jles_meta._template_params(POP, DIM))[1]
    fit = jax.jit(jax.vmap(lambda c: jnp.mean(jax.vmap(lambda t, kk: jles_meta.les_score(
        params_of(c), t, kk, DIM, POP, gens))(tasks, run_keys))))(cand)
    ostate = outer.tell(ostate, jax_rank_based_fitness(fit))

    trainer = les_meta.MetaTrainer(0, outer_pop=outer_pop, tasks_per_gen=n_tasks,
                                   inner_gens=gens, center_init=np.array(flat0), device="cpu")
    tstate = interop.open_es_state(trainer.outer, start)
    trainer._draw_tasks = lambda seed: _tensors(tasks)
    trainer._draw_inner = lambda seed: _inner_noise(run_keys, gens)
    trainer.outer._draw_noise = lambda seed: torch.from_numpy(half)
    tstate, _, tfit = trainer.step(tstate, 0)
    np.testing.assert_allclose(tfit.numpy(), np.asarray(fit), rtol=0, atol=SCORE_ATOL)
    # equal ranks, so the same OpenES step: the center to float32 rounding
    np.testing.assert_array_equal(np.argsort(tfit.numpy()), np.argsort(np.asarray(fit)))
    np.testing.assert_allclose(tstate.center.numpy(), np.asarray(ostate.center),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_meta_training_improves_held_out_gap(seed):
    """Gate: 40 meta-steps at outer pop 16, 5 tasks, 10 inner generations
    lower the center's mean log10-gap on 20 held-out tasks (fixed draws) by
    at least 0.3 (0.62-0.74 measured on seeds 0-2)."""
    trainer = les_meta.MetaTrainer(seed, outer_pop=16, tasks_per_gen=5, inner_gens=10,
                                   device="cpu")
    ostate, step_seed = trainer.init()
    held = les_meta.sample_tasks(1000 + seed, 20, DIM, device="cpu")
    held["type"] = torch.arange(20, dtype=torch.int32) % 5
    noise = torch.randn((10, 20, POP, DIM), generator=torch.Generator().manual_seed(5))
    before = float(trainer.meta_fitness(ostate.center[None], held, noise)[0])
    for _ in range(40):
        ostate, step_seed, fit = trainer.step(ostate, step_seed)
    after = float(trainer.meta_fitness(ostate.center[None], held, noise)[0])
    assert after < before - 0.3, (before, after)
    # the trained center drives LES through a workflow on a held-out task
    task = {k: v[3] for k, v in held.items()}

    class TaskProblem(Problem):
        def evaluate(self, state, pop):
            return les_meta.task_eval(task, pop), state

    algo = LES(torch.zeros(DIM), pop_size=POP, params=les_meta.unravel(ostate.center),
               device="cpu")
    wf = StdWorkflow(algo, TaskProblem(), device="cpu")
    state = wf.run(wf.init(3), 20)
    assert bool(torch.isfinite(state.algo.mean).all())


def test_save_load_round_trip(tmp_path):
    flat = torch.randn(les_meta.N_PARAMS, generator=torch.Generator().manual_seed(1))
    path = tmp_path / "sub" / "les.npz"
    les_meta.save_params(flat, path)
    params = les_meta.load_params(path, device="cpu")
    torch.testing.assert_close(les_meta.ravel(params), flat, rtol=0, atol=0)
    assert np.load(path)["flat"].dtype == np.float32
    batch = torch.stack([flat, -flat])
    torch.testing.assert_close(les_meta.ravel(les_meta.unravel(batch)), batch, rtol=0, atol=0)
    assert les_meta.load_params(tmp_path / "none.npz", device="cpu") is None
    np.savez(tmp_path / "short.npz", flat=np.zeros(5, np.float32))
    assert les_meta.load_params(tmp_path / "short.npz", device="cpu") is None
