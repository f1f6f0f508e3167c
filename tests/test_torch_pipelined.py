"""Host problems in the port: ``StdWorkflow`` with a problem that runs on
the host, ``run_host_pipelined`` through the ``GenerationExecutor``, the
x32 coercion, ``pipeline_ask``/``pipeline_tell``, ``sample`` and
``validate``, against a ``wf.step`` loop and against the JAX package, on
the CPU."""

import threading

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.utils.io import to_x32_if_needed as jax_to_x32
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.utils.io import to_x32_if_needed, x32_func_call
from evox_tpu_torch.workflows import chunked_evaluate, run_host_pipelined

# One OpenES tell is a (pop/2, dim) x (pop/2,) product and an elementwise
# update in float32, which the two libraries sum in different orders
# (tests/test_torch_openes.py holds the same bound).
CENTER_RTOL, CENTER_ATOL = 1e-5, 1e-6


class HostSphere:
    """A duck-typed host problem (numpy in, numpy out) that drives both
    packages unchanged, as ``bench.py``'s ``_HostEvalSphere`` does; it
    scores in float64 (the x32 coercion's case) and records the rows and
    input types it was given."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self):
        self.rows = []
        self.types = set()

    def init(self, key=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        self.types.add(type(pop))
        self.rows.append(pop.shape[0])
        return np.sum(np.asarray(pop, np.float64) ** 2, axis=1), state


def _pso_workflow(problem=None, pop=16, dim=5):
    lb, ub = -5.0 * np.ones(dim, np.float32), 5.0 * np.ones(dim, np.float32)
    return StdWorkflow(PSO(lb, ub, pop, device="cpu"), problem or HostSphere(), device="cpu")


def _leaves(state):
    return [leaf for _, leaf in named_leaves(state) if isinstance(leaf, torch.Tensor)]


def _assert_same(a, b):
    assert a.generation == b.generation
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("eval_chunk", [None, 5, 16], ids=["whole", "ragged", "one_slice"])
def test_run_host_pipelined_equals_a_step_loop(eval_chunk):
    wf = _pso_workflow()
    state = wf.init(13)
    looped = state
    for _ in range(6):
        looped = wf.step(looped)
    seen = []
    piped = run_host_pipelined(wf, state, 6, eval_chunk=eval_chunk,
                               on_generation=lambda g, s, f: seen.append((g, s.generation, f.shape)))
    _assert_same(piped, looped)
    assert seen == [(g, g + 1, (16,)) for g in range(6)]
    if eval_chunk == 5:  # row slices of 5, 5, 5 and the ragged 1
        assert wf.problem.rows[-4:] == [5, 5, 5, 1]
    assert wf.problem.types == {np.ndarray}  # the host sees numpy only
    _assert_same(wf.run(state, 6), looped)  # run() takes the same pipeline


def test_chunked_evaluate_concatenates_like_the_whole_call():
    prob = HostSphere()
    cand = np.random.default_rng(0).normal(size=(11, 3)).astype(np.float32)
    whole, _ = chunked_evaluate(prob, None, cand, None)
    for chunk in (1, 4, 11, 50):
        got, _ = chunked_evaluate(prob, None, cand, chunk)
        np.testing.assert_array_equal(got, whole)
    with pytest.raises(ValueError, match="eval_chunk"):
        chunked_evaluate(prob, None, cand, 0)


X64_CASES = {
    "float64": np.linspace(-1, 1, 7),
    "int64": np.arange(5, dtype=np.int64),
    "float32": np.ones(3, np.float32),
    "int32": np.arange(3, dtype=np.int32),
    "bool": np.array([True, False]),
    "tree": {"a": np.zeros(2), "b": (np.arange(2, dtype=np.int64), np.ones(1, np.float32))},
    "scalar": 3.5,
}


@pytest.mark.parametrize("name", sorted(X64_CASES))
def test_to_x32_if_needed_matches_jax(name):
    value = X64_CASES[name]
    got, want = to_x32_if_needed(value), jax_to_x32(value)
    g_leaves, w_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert x32_func_call(lambda: value)().__class__ is got.__class__


def test_host_fitness_in_float64_is_coerced():
    wf = _pso_workflow()
    state = wf.step(wf.init(1))
    cand = wf.sample(state)
    want = np.sum(cand.numpy().astype(np.float64) ** 2, axis=1).astype(np.float32)
    fit = wf.validate(state)
    assert fit.dtype == torch.float32 and isinstance(fit, torch.Tensor)
    np.testing.assert_array_equal(fit.numpy(), want)
    report = wf.host_link.report()
    assert report["pinned"] is False and report["d2h_bytes"] >= 16 * 5 * 4
    assert report["h2d_bytes"] >= 16 * 4


def test_on_generation_runs_in_order_and_its_error_comes_before_the_next_tell():
    wf = _pso_workflow()
    state = wf.init(2)
    ex = GenerationExecutor()
    order, threads = [], set()

    def hook(g, s, fit):
        threads.add(threading.get_ident())
        order.append(g)
        if g == 2:
            raise RuntimeError("hook failed at 2")

    with pytest.raises(RuntimeError, match="hook failed at 2"):
        run_host_pipelined(wf, state, 8, on_generation=hook, executor=ex)
    assert order == [0, 1, 2]
    # the hook of generation 2 ran beside the evaluation of generation 3,
    # and its error came before tell 3
    assert ex.counters["tells"] == 3 and ex.counters["asks"] == 4
    assert threading.get_ident() not in threads  # on the hook lane


def test_executor_counters_and_report():
    wf = _pso_workflow()
    ex = GenerationExecutor(fetch_monitors_every=2)
    state = run_host_pipelined(wf, wf.init(3), 5, executor=ex)
    state = run_host_pipelined(wf, state, 3, executor=ex)
    c = ex.counters
    assert (c["runs"], c["chunks"], c["asks"], c["tells"], c["generations"]) == (2, 2, 8, 8, 8)
    assert c["bg_hook"] == 0 and c["bg_checkpoint"] == 0
    report = ex.report()
    assert report["max_staleness"] == 0 and report["overlap"]["wall_s"] > 0
    assert report["overlap"]["host_eval_s"] > 0
    spans = ex.trace_spans()
    assert {s["track"] for s in spans} >= {"device", "host_eval"}
    assert sum(s["name"] == "pipeline_tell" for s in spans) == 8
    assert "executor/io_queue_depth" in ex.counter_samples()
    # the persistent lanes
    out = []
    ex.submit_background("journal", lambda: out.append(1), counter="bg_journal")
    ex.drain_lane("journal")
    ex.drain_lane("never used")
    assert out == [1] and ex.counters["bg_journal"] == 1
    ex.submit_background("journal", lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        ex.close()
    ex.close()  # idempotent


def test_refusals():
    jittable = StdWorkflow(PSO(-np.ones(3), np.ones(3), 8, device="cpu"), Sphere(), device="cpu")
    with pytest.raises(ValueError, match="external"):
        run_host_pipelined(jittable, jittable.init(0), 2)
    with pytest.raises(ValueError, match="external"):
        GenerationExecutor().run_host(jittable, jittable.init(0), 2)
    wf = _pso_workflow()
    # stale tells are ported: K > 0 runs (tests/test_torch_stale.py holds
    # them against the JAX loop), and a negative bound is refused
    stale = GenerationExecutor(max_staleness=1)
    assert run_host_pipelined(wf, wf.init(0), 2, executor=stale).generation == 2
    assert stale.report()["max_staleness"] == 1
    with pytest.raises(ValueError, match="max_staleness"):
        GenerationExecutor(max_staleness=-1)
    # the supervisor hook and the pod supervisor's are ported
    # (tests/test_torch_supervisor.py, tests/test_torch_pod_supervisor.py)
    sup = object()
    assert GenerationExecutor(supervisor=sup).supervisor is sup
    assert GenerationExecutor(pod_supervisor=sup).pod_supervisor is sup
    # the voted re-dispatch is ported (tests/test_torch_attest.py): a
    # cadence below 1 is refused
    with pytest.raises(ValueError, match="verify_every"):
        GenerationExecutor().run_fused(jittable, jittable.init(0), 1, verify_every=0)
    # external_problem=True forces the host path for a problem that could
    # run on the device; the host sees numpy
    forced = StdWorkflow(PSO(-np.ones(3), np.ones(3), 8, device="cpu"), HostSphere(),
                         external_problem=True, device="cpu")
    assert forced.external and forced.step(forced.init(0)).generation == 1


def _openes_pair(pop, dim, seed):
    center0 = np.random.default_rng(seed).normal(size=dim).astype(np.float32)
    jwf = JaxStdWorkflow(JaxOpenES(center0, pop, learning_rate=0.1, noise_stdev=0.05), HostSphere())
    talgo = OpenES(center0, pop, learning_rate=0.1, noise_stdev=0.05, device="cpu")
    twf = StdWorkflow(talgo, HostSphere(), device="cpu")
    return jwf, twf, talgo


def _substitute_noise(algo, half):
    """The port's one draw method returns JAX's draw (ask and tell of a
    generation share a seed)."""
    algo._draw_noise = lambda seed: torch.as_tensor(np.array(half))


def test_one_host_generation_matches_jax_pipeline_halves():
    pop, dim = 16, 6
    jwf, twf, talgo = _openes_pair(pop, dim, 0)
    assert jwf.external and twf.external
    jstate = jwf.init(jax.random.PRNGKey(5))
    tstate = interop.std_workflow_state(twf, jax.tree.map(np.asarray, jstate))
    jcand, jctx = jwf.pipeline_ask(jstate)
    _substitute_noise(talgo, jax.random.normal(jctx[0].noise_key, (pop // 2, dim)))
    tcand, tctx = twf.pipeline_ask(tstate)
    np.testing.assert_allclose(tcand.numpy(), np.asarray(jcand), rtol=1e-6, atol=1e-7)
    jfit, _ = jwf.problem.evaluate(None, np.asarray(jcand))
    host, _ = twf.host_link.to_host(tcand)
    tfit, _ = twf.problem.evaluate(None, host)
    jnext = jwf.pipeline_tell(jstate, jctx, jfit, jstate.prob)
    tnext = twf.pipeline_tell(tstate, tctx, tfit, tstate.prob)
    assert tnext.generation == int(jnext.generation) == 1 and tnext.first_step is False
    np.testing.assert_allclose(tnext.algo.center.numpy(), np.asarray(jnext.algo.center),
                               rtol=CENTER_RTOL, atol=CENTER_ATOL)
    # the same generation through the synchronous step
    stepped = twf.step(tstate)
    np.testing.assert_array_equal(stepped.algo.center.numpy(), tnext.algo.center.numpy())


def test_sample_and_validate_match_jax():
    pop, dim = 8, 4
    jwf, twf, talgo = _openes_pair(pop, dim, 1)
    jstate = jwf.init(jax.random.PRNGKey(2))
    tstate = interop.std_workflow_state(twf, jax.tree.map(np.asarray, jstate))
    _, jctx = jwf.pipeline_ask(jstate)
    _substitute_noise(talgo, jax.random.normal(jctx[0].noise_key, (pop // 2, dim)))
    np.testing.assert_allclose(twf.sample(tstate).numpy(), np.asarray(jwf.sample(jstate)),
                               rtol=1e-6, atol=1e-7)
    got, want = twf.validate(tstate), jwf.validate(jstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # a validation problem on the card's side, and the guard on problem_state
    on_device = twf.validate(tstate, problem=Sphere())
    np.testing.assert_allclose(on_device.numpy(), got.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="problem_state"):
        twf.validate(tstate, problem_state=object())
    assert tstate.generation == 0  # nothing advanced
