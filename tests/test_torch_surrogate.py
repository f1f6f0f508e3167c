"""Surrogate-assisted search in the port (``operators/surrogate.py``,
``workflows/surrogate.py`` and the executor's refit hooks) against the JAX
package on the CPU, and the port's own laws mirroring
``tests/test_surrogate.py``: disabled is ``StdWorkflow`` bit for bit, the
pipelined run equals a ``step`` loop, the host's rows equal the ledger, a
lying model trips the fallback and the run still converges, the
uncertainty ceiling trips, a resume in the middle of a refit window equals
the straight run, bf16 storage keeps the right dtypes, deferred arguments
and a missing card raise."""

import tempfile

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import SurrogateWorkflow as JaxSurrogateWorkflow
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.monitors import TelemetryMonitor as JaxTelemetryMonitor
from evox_tpu.operators import surrogate as jsur
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu.workflows.surrogate import masked_worst_finite_fill as jax_fill
from evox_tpu_torch import StdWorkflow, SurrogateWorkflow, interop
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.dtype_policy import BF16_STORAGE
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.monitors import TelemetryMonitor
from evox_tpu_torch.operators.surrogate import (
    EnsembleSurrogate,
    GPCapacityError,
    GPSurrogate,
    SurrogateArchive,
    spearman_correlation,
)
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows import WorkflowCheckpointer, run_host_pipelined
from evox_tpu_torch.workflows.surrogate import (
    FALLBACK_RANK,
    FALLBACK_UNCERTAINTY,
    masked_worst_finite_fill,
)

POP, DIM, CAP = 16, 4, 64
SCREEN = dict(screen_frac=0.25, archive_capacity=CAP, warmup=POP, refit_every=1)

# The GP's kernel scales are sums over the archive, its alpha a Cholesky
# solve with a 1e-4 relative noise floor, which XLA and PyTorch compute in
# other orders: alpha is ill-conditioned (measured 0.2 apart on values up
# to ~1e3) but the posterior mean is not: within 1e-3 relative on a Sphere
# of values up to ~20. The standard deviation is sqrt(amplitude - |v|^2),
# a difference that cancels near the archived points: within 1e-3
# (measured 1.7e-4 on values 0.2-1.7). The lengthscale and amplitude are
# plain sums: 1e-5 relative.
GP_MEAN_RTOL, GP_SD_TOL, GP_SCALE_RTOL = 1e-3, 1e-3, 1e-5
# The ensemble: 30 adam steps of a float32 MLP on the same initial weights
# (measured 7e-6 on the weights at 150 steps of the default size).
ENS_ATOL = 1e-4
# A PSO generation is elementwise float32 on the same draws; Sphere's sum
# over 4 dimensions may round differently; over 5 generations 1e-5.
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------- operators


def test_archive_ring_matches_jax():
    rng = np.random.default_rng(0)
    jarc, arc = jsur.SurrogateArchive(8), SurrogateArchive(8)
    js, ts = jarc.init(2), arc.init(2, device="cpu")
    update = jax.jit(jarc.update)
    for _ in range(5):  # 6 rows a batch, about 4 kept: the ring wraps twice
        x = rng.normal(size=(6, 2)).astype(np.float32)
        y = rng.normal(size=6).astype(np.float32)
        mask = rng.uniform(size=6) < 0.7
        js = update(js, x, y, mask)
        ts = arc.update(ts, _t(x), _t(y), _t(mask))
        np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
        np.testing.assert_array_equal(ts.y.numpy(), np.asarray(js.y))
        assert int(ts.count) == int(js.count) and ts.count.dtype == torch.int32
        np.testing.assert_array_equal(arc.valid_mask(ts).numpy(), np.asarray(jarc.valid_mask(js)))
        assert int(arc.fill(ts)) == int(jarc.fill(js))
    with pytest.raises(ValueError, match="capacity"):
        arc.update(ts, torch.zeros((9, 2)), torch.zeros(9), torch.ones(9, dtype=torch.bool))


INF = np.inf
# eight rows a case (one compiled JAX program for all of them); a 0 in the
# mask leaves a row out
SPEARMAN_CASES = {
    "identity": ([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8], None),
    "reversed": ([1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1], None),
    "masked_outlier": ([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, -1e9, 6, 7, 8],
                       [1, 1, 1, 1, 0, 1, 1, 1]),
    "ties": ([1, 1, 2, 2, 3, 3, 4, 4], [3, 1, 2, 2, 1, 0, 5, 5], None),
    "infinities": ([1, INF, 3, -INF, 5, 6, 2, 0], [2, 1, 4, 3, np.nan, 7, -INF, 9], None),
    "under_three": ([1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1], [1, 1, 0, 0, 0, 0, 0, 0]),
    "noise": (list(np.random.default_rng(3).normal(size=8)),
              list(np.random.default_rng(4).normal(size=8)), [1, 1, 1, 0, 1, 1, 1, 1]),
}
_jax_spearman = jax.jit(jsur.spearman_correlation)


@pytest.mark.parametrize("name", sorted(SPEARMAN_CASES))
def test_spearman_matches_jax(name):
    a, b, mask = SPEARMAN_CASES[name]
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mask = np.ones(8, bool) if mask is None else np.asarray(mask, bool)
    want = float(_jax_spearman(a, b, mask))
    got = spearman_correlation(_t(a), _t(b), _t(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, abs=1e-6)
    if name == "identity":  # mask=None is every row
        assert float(spearman_correlation(_t(a), _t(b))) == 1.0


def test_masked_worst_finite_fill_matches_jax():
    for fit, mask in (([3.0, 1.0, np.nan, 7.0, 9.0], [1, 1, 1, 0, 0]),
                      ([np.nan, np.inf, 2.0, 5.0, -np.inf], [1, 1, 0, 0, 0])):
        fit, mask = np.asarray(fit, np.float32), np.asarray(mask, bool)
        np.testing.assert_array_equal(masked_worst_finite_fill(_t(fit), _t(mask)).numpy(),
                                      np.asarray(jax_fill(fit, mask)))


def _sphere_archive(seed, cap=64, dim=4, live=48):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(cap, dim)).astype(np.float32)
    y = (x**2).sum(1).astype(np.float32)
    y[live:] = np.nan  # a poisoned tail outside the mask
    return x, y, np.arange(cap) < live


def test_ensemble_on_jax_initial_weights_matches_jax():
    x, y, mask = _sphere_archive(5)
    xt = np.random.default_rng(6).normal(size=(16, 4)).astype(np.float32)
    kw = dict(n_members=2, hidden=8, fit_steps=30)
    jens = jsur.EnsembleSurrogate(**kw)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def jax_side(key):
        m = jens.fit(jens.init_model(64, 4), x, y, mask, key)
        return m, jens.predict(m, xt)

    jmodel, (jmean, junc) = jax_side(key)
    # the JAX package's initial weights: split(key, members), then each
    # member's split(k, 3) for w1, w2, w3
    draws = {"w1": [], "w2": [], "w3": []}
    for k in jax.random.split(key, kw["n_members"]):
        k1, k2, k3 = jax.random.split(k, 3)
        draws["w1"].append(jax.random.normal(k1, (4, 8)))
        draws["w2"].append(jax.random.normal(k2, (8, 8)))
        draws["w3"].append(jax.random.normal(k3, (8, 1)))
    ens = EnsembleSurrogate(device="cpu", **kw)
    ens._draw = lambda seed, dim: {k: _t(np.stack(v)) for k, v in draws.items()}
    model = ens.fit(ens.init_model(64, 4), _t(x), _t(y), _t(mask), 0)
    for name, value in model.params.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmodel.params[name]), atol=ENS_ATOL,
                                   err_msg=name)
    mean, unc = ens.predict(model, _t(xt))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=ENS_ATOL * 20)
    np.testing.assert_allclose(unc.numpy(), np.asarray(junc), atol=ENS_ATOL * 20)
    with pytest.raises(ValueError, match="n_members"):
        EnsembleSurrogate(n_members=1, device="cpu")


def _pso(pop=POP, dim=DIM):
    return PSO(-5.0 * np.ones(dim, np.float32), 5.0 * np.ones(dim, np.float32), pop, device="cpu")


def test_capacity_guard_and_refusals():
    with pytest.raises(GPCapacityError, match="EnsembleSurrogate"):
        GPSurrogate(max_capacity=128, device="cpu").check_capacity(256)
    with pytest.raises(GPCapacityError):
        SurrogateWorkflow(_pso(), Sphere(), surrogate=GPSurrogate(max_capacity=32, device="cpu"),
                          screen_frac=0.25, archive_capacity=64, device="cpu")
    with pytest.raises(ValueError, match="screens nothing"):
        SurrogateWorkflow(_pso(pop=8), Sphere(), surrogate=GPSurrogate(device="cpu"),
                          screen_frac=0.9, device="cpu")
    with pytest.raises(ValueError, match="smaller than the widest"):
        SurrogateWorkflow(_pso(), Sphere(), surrogate=GPSurrogate(device="cpu"), screen_frac=0.25,
                          archive_capacity=8, device="cpu")
    # ported: the mesh (StdWorkflow's) and, with screening off, the
    # per-shard evaluation; screening refuses eval_shard_map, as the JAX
    # package does, and the executor takes a supervisor
    from evox_tpu_torch.core.distributed import create_mesh

    mesh = create_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="eval_shard_map"):
        SurrogateWorkflow(_pso(), Sphere(), surrogate=GPSurrogate(device="cpu"),
                          screen_frac=0.25, device="cpu", mesh=mesh, eval_shard_map=True)
    wf = SurrogateWorkflow(_pso(), Sphere(), surrogate=None, device="cpu", mesh=mesh,
                           eval_shard_map=True)
    assert wf.mesh is mesh and wf.run(wf.init(0), 2).generation == 2
    sup = object()
    assert GenerationExecutor(supervisor=sup).supervisor is sup


def test_entry_points_default_to_cuda():
    makers = (GPSurrogate, EnsembleSurrogate,
              lambda: SurrogateWorkflow(_pso(), Sphere(), surrogate=None))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


# ------------------------------------------------- the workflow against JAX


def _pso_draws(jax_algo_state):
    """JAX PSO's tell draws from the state its tell receives."""
    _, k1, k2 = jax.random.split(jax_algo_state.key, 3)
    shape = jax_algo_state.population.shape
    return _t(jax.random.uniform(k1, shape)), _t(jax.random.uniform(k2, shape))


@pytest.fixture(scope="module")
def jax_run():
    """Five JAX generations (the first fully evaluated, the rest screened),
    every state kept with the draws of its tell."""
    lb, ub = -5.0 * np.ones(DIM, np.float32), 5.0 * np.ones(DIM, np.float32)
    jwf = JaxSurrogateWorkflow(JaxPSO(lb, ub, POP), JaxSphere(), surrogate=jsur.GPSurrogate(),
                               monitors=(JaxTelemetryMonitor(capacity=4),), **SCREEN)
    # PSO has no init_ask: the first step is a steady one, one compiled step
    state = jwf.init(jax.random.PRNGKey(0)).replace(first_step=False)
    states, draws = [state], []
    for _ in range(5):
        draws.append(_pso_draws(state.algo))
        state = jwf.step(state)
        states.append(state)
    return jwf, [_np(s) for s in states], draws


def _port_workflow(problem=None, **kw):
    algo = _pso()
    wf = SurrogateWorkflow(algo, problem if problem is not None else Sphere(),
                           surrogate=GPSurrogate(device="cpu"),
                           monitors=(TelemetryMonitor(capacity=4, device="cpu"),), device="cpu",
                           **dict(SCREEN, **kw))
    return wf, algo


LEDGER = ("refits", "last_refit_gen", "fallback_next", "candidates_seen", "true_evals",
          "screened_out", "generations", "screened_gens", "fallback_gens", "warmup_gens",
          "fb_count")


def _assert_like_jax(ts, js):
    assert ts.generation == int(js.generation)
    for name in LEDGER:
        assert int(getattr(ts.sur, name)) == int(getattr(js.sur, name)), name
    assert int(ts.sur.archive.count) == int(js.sur.archive.count)
    np.testing.assert_allclose(ts.sur.archive.x.numpy(), js.sur.archive.x, rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(ts.sur.archive.y.numpy(), js.sur.archive.y, rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    for name in ("population", "velocity", "pbest_position", "pbest_fitness", "gbest_position",
                 "gbest_fitness"):
        np.testing.assert_allclose(getattr(ts.algo, name).numpy(), getattr(js.algo, name),
                                   rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=name)
    for name in ("lengthscale2", "amplitude", "y_mean"):
        np.testing.assert_allclose(getattr(ts.sur.model, name).numpy(),
                                   getattr(js.sur.model, name), rtol=GP_SCALE_RTOL, err_msg=name)
    mon = ts.monitors[0]
    for name in ("generations", "evals", "best_generation", "stagnation", "sur_true_evals"):
        assert int(getattr(mon, name)) == int(getattr(js.monitors[0], name)), name


def test_one_screened_step_matches_jax(jax_run):
    jwf, states, draws = jax_run
    g = 2  # a warm generation: the archive is filled and the model fitted
    wf, algo = _port_workflow()
    start = interop.surrogate_workflow_state(wf, states[g])
    # the screening plan: order and row count equal, predictions within tolerance
    pop = wf.sample(start)
    jplan = jax.jit(jwf._screen_plan)(jax.tree.map(np.asarray, states[g].sur), pop.numpy())
    plan = wf._screen_plan(start.sur, pop)
    assert not bool(plan.full_eval) and int(plan.n_eval) == int(jplan.n_eval) == 4
    np.testing.assert_array_equal(plan.order.numpy(), np.asarray(jplan.order))
    np.testing.assert_allclose(plan.mean_perm.numpy(), np.asarray(jplan.mean_perm),
                               rtol=GP_MEAN_RTOL, atol=1e-3)
    algo._draw = lambda seed: draws[g]
    _assert_like_jax(wf.step(start), states[g + 1])


def test_five_generation_run_matches_jax(jax_run):
    _, states, draws = jax_run
    wf, algo = _port_workflow()
    queue = list(draws)
    algo._draw = lambda seed: queue.pop(0)
    state = wf.run(interop.surrogate_workflow_state(wf, states[0]), 5)
    assert not queue
    _assert_like_jax(state, states[5])
    np.testing.assert_allclose(state.sur.model.alpha.numpy(), states[5].sur.model.alpha,
                               rtol=0.05, atol=0.5)  # ill-conditioned: see GP_MEAN_RTOL
    assert wf.surrogate_report(state)["counters"] == {
        k: int(getattr(states[5].sur, k)) for k in ("candidates_seen", "true_evals", "screened_out",
                                                   "generations", "screened_gens", "fallback_gens",
                                                   "warmup_gens")}


def test_gp_surrogate_matches_jax(jax_run):
    # the JAX run's last archive (32 of 64 slots live) and the model JAX
    # fitted on it
    _, states, _ = jax_run
    jarc, jmodel = states[5].sur.archive, states[5].sur.model
    gp = GPSurrogate(device="cpu")
    live = SurrogateArchive(CAP).valid_mask(interop.surrogate_state(_port_workflow()[0],
                                                                    states[5].sur).archive)
    model = gp.fit(gp.init_model(CAP, DIM), _t(jarc.x), _t(jarc.y), live)
    for name in ("lengthscale2", "amplitude", "y_mean"):
        np.testing.assert_allclose(getattr(model, name).numpy(), getattr(jmodel, name),
                                   rtol=GP_SCALE_RTOL, err_msg=name)
    assert all(getattr(model, f).dtype == torch.float32 for f in ("x", "chol", "alpha"))
    xt = np.random.default_rng(1).uniform(-3, 3, size=(32, DIM)).astype(np.float32)
    jmean, jsd = jsur.GPSurrogate().predict(jmodel, xt)
    mean, sd = gp.predict(model, _t(xt))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=GP_MEAN_RTOL, atol=1e-3)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=GP_SD_TOL, atol=GP_SD_TOL)
    # the two predicted orders agree, and both order unseen Sphere points
    assert float(spearman_correlation(mean, _t(jmean))) > 0.999
    assert float(spearman_correlation(mean, _t((xt**2).sum(1)))) > 0.7
    # a masked fit ignores a poisoned tail, and uncertainty grows away from
    # the data (the fallback's signal)
    x, y, mask = _sphere_archive(0)
    model = gp.fit(gp.init_model(64, 4), _t(x), _t(y), _t(mask))
    mean, sd = gp.predict(model, _t(xt))
    assert torch.isfinite(mean).all()
    far = 25.0 * np.random.default_rng(2).normal(size=(32, 4)).astype(np.float32)
    assert float(gp.predict(model, _t(far))[1].mean()) > 2.0 * float(sd.mean())


# ------------------------------------------------------------ the port's laws


class HostSphere:
    """A host Sphere counting the rows it truly scores."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self):
        self.rows = 0

    def init(self, seed=None):
        return None

    def fit_shape(self, n):
        return (n,)

    def evaluate(self, state, pop):
        pop = np.asarray(pop)
        self.rows += pop.shape[0]
        return np.sum(pop**2, axis=1).astype(np.float32), state


def _tensors(state):
    return [(name, leaf) for name, leaf in named_leaves(state) if isinstance(leaf, torch.Tensor)]


def _assert_equal(a, b):
    la, lb = _tensors(a), _tensors(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("host", [False, True], ids=["device_problem", "host_problem"])
def test_disabled_is_std_workflow_bit_for_bit(host):
    def problem():
        return HostSphere() if host else Sphere()

    mon = lambda: (TelemetryMonitor(capacity=8, device="cpu"),)
    bare = StdWorkflow(_pso(), problem(), monitors=mon(), device="cpu")
    for dis in (SurrogateWorkflow(_pso(), problem(), surrogate=None, monitors=mon(), device="cpu"),
                SurrogateWorkflow(_pso(), problem(), surrogate=GPSurrogate(device="cpu"),
                                  screen_frac=1.0, monitors=mon(), device="cpu")):
        sb, sd = bare.init(3), dis.init(3)
        assert sd.sur is None
        for _ in range(3):
            sb, sd = bare.step(sb), dis.step(sd)
        _assert_equal((sb.algo, sb.monitors), (sd.algo, sd.monitors))
        rb, rd = bare.run(sb, 4), dis.run(sd, 4)
        _assert_equal((rb.algo, rb.monitors), (rd.algo, rd.monitors))
        assert rb.generation == rd.generation == 7


def test_eval_shard_map_matches_jax_and_the_unsharded_run():
    """``SurrogateWorkflow`` with screening off and ``eval_shard_map`` on an
    8-shard mesh: every step equals the unsharded run bit for bit (Sphere
    is row by row), and JAX's ``SurrogateWorkflow(mesh=, eval_shard_map=
    True)`` on its 8 virtual devices on the same PSO draws within the
    workflow tolerance above."""
    from evox_tpu.core.distributed import create_mesh as jax_create_mesh
    from evox_tpu_torch.core.distributed import create_mesh

    lb, ub = -5.0 * np.ones(DIM, np.float32), 5.0 * np.ones(DIM, np.float32)
    jwf = JaxSurrogateWorkflow(JaxPSO(lb, ub, POP), JaxSphere(), surrogate=None,
                               mesh=jax_create_mesh(), eval_shard_map=True)
    jstate = jwf.init(jax.random.PRNGKey(1))
    start = _np(jstate)
    jstates, draws = [], []
    for _ in range(4):
        draws.append(_pso_draws(jstate.algo))
        jstate = jwf.step(jstate)
        jstates.append(_np(jstate))
    sharded, plain = [SurrogateWorkflow(_pso(), Sphere(), surrogate=None, device="cpu", **kw)
                      for kw in (dict(mesh=create_mesh(devices=["cpu"] * 8), eval_shard_map=True),
                                 {})]
    ss, sp = (interop.surrogate_workflow_state(wf, start) for wf in (sharded, plain))
    for d, js in zip(draws, jstates):
        sharded.algorithm._draw = plain.algorithm._draw = lambda seed, d=d: d
        ss, sp = sharded.step(ss), plain.step(sp)
        _assert_equal(ss, sp)
        assert ss.generation == int(js.generation)
        for name in ("population", "velocity", "pbest_position", "pbest_fitness",
                     "gbest_position", "gbest_fitness"):
            np.testing.assert_allclose(getattr(ss.algo, name).numpy(), getattr(js.algo, name),
                                       rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=name)


class FlakyHostSphere(HostSphere):
    """``HostSphere`` whose ``fail_at``-th evaluation raises once, as a
    dropped connection to a simulator would."""

    def __init__(self, fail_at):
        super().__init__()
        self.calls, self.fail_at = 0, fail_at

    def evaluate(self, state, pop):
        self.calls += 1
        if self.calls == self.fail_at:
            raise ConnectionResetError("Connection reset by peer")
        return super().evaluate(state, pop)


def test_supervised_screened_run_retries_bit_for_bit():
    """A screened run under ``RunSupervisor``: a host evaluation that fails
    once is retried from its segment's entry state, and the run ends bit
    for bit with the unsupervised one (the refit schedule included)."""
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    wf, _ = _port_workflow(HostSphere(), refit_every=2)
    clean = run_host_pipelined(wf, wf.init(2), 8)
    flaky, _ = _port_workflow(FlakyHostSphere(fail_at=6), refit_every=2)
    sup = RunSupervisor(backoff_s=0.0)
    got = sup.run_host_pipelined(flaky, flaky.init(2), 8, chunk=4)
    _assert_equal(got, clean)
    assert sup.counters["retries"] == 1 and sup.report()["outcome"] == "recovered"


def test_pipelined_equals_step_loop_and_host_rows_equal_the_ledger():
    wf, _ = _port_workflow(HostSphere(), refit_every=2)
    state = wf.init(2)
    looped = state
    for _ in range(8):
        looped = wf.step(looped)
    rows_looped = wf.problem.rows
    ex = GenerationExecutor()
    piped = run_host_pipelined(wf, state, 8, executor=ex)
    _assert_equal(piped, looped)
    # the executor refit at generations 2, 4, 6, 8
    assert ex.counters["bg_refit"] == int(piped.sur.refits) == 4
    assert int(piped.sur.last_refit_gen) == 8
    # the host saw exactly the ledger's rows, fewer than full evaluation
    assert wf.problem.rows - rows_looped == rows_looped == int(piped.sur.true_evals) < 8 * POP
    assert int(piped.sur.screened_gens) >= 5
    # run() takes the executor's pipeline for a host problem
    _assert_equal(wf.run(state, 8), looped)


class LyingSurrogate:
    """A model whose predicted order is exactly wrong (negated mean) and
    whose uncertainty is overconfident: the rank fallback's trigger."""

    def __init__(self, inner):
        self.inner, self.kind, self.device = inner, inner.kind, inner.device

    def check_capacity(self, capacity):
        self.inner.check_capacity(capacity)

    def init_model(self, capacity, dim):
        return self.inner.init_model(capacity, dim)

    def fit(self, model, x, y, mask, seed=None):
        return self.inner.fit(model, x, y, mask, seed)

    def predict(self, model, x_test):
        mean, unc = self.inner.predict(model, x_test)
        return -mean, unc * 1e-3


def _run_to_threshold(wf, seed, threshold=1e-2, max_gens=160, chunk=2):
    state = wf.init(seed)
    for _ in range(0, max_gens, chunk):
        state = wf.run(state, chunk)
        if float(wf.monitors[0].get_best_fitness(state.monitors[0])) < threshold:
            break
    return state


def test_lying_surrogate_trips_the_fallback_and_still_converges():
    wf = SurrogateWorkflow(_pso(pop=64, dim=8), Sphere(),
                           surrogate=LyingSurrogate(GPSurrogate(device="cpu")), screen_frac=0.125,
                           warmup=64, rank_floor=0.3,
                           monitors=(TelemetryMonitor(capacity=4, device="cpu"),), device="cpu")
    state = _run_to_threshold(wf, 1)
    assert float(wf.monitors[0].get_best_fitness(state.monitors[0])) < 1e-2
    sur = state.sur
    assert int(sur.fallback_gens) >= 1 and int(sur.fallback_gens) >= int(sur.screened_gens)
    events = wf.surrogate_report(state)["fallback_events"]
    assert events and all(ev["reason"] & FALLBACK_RANK for ev in events)
    assert [ev["generation"] for ev in events] == sorted(ev["generation"] for ev in events)
    assert int(sur.true_evals) + int(sur.screened_out) == int(sur.candidates_seen)


def test_uncertainty_ceiling_trips_an_immediate_fallback():
    wf, _ = _port_workflow(unc_ceiling=1e-12)
    state = wf.init(0)
    for _ in range(4):
        state = wf.step(state)
    assert int(state.sur.fallback_gens) >= 1 and int(state.sur.screened_gens) == 0
    assert any(ev["reason"] & FALLBACK_UNCERTAINTY
               for ev in wf.surrogate_report(state)["fallback_events"])


def test_resume_mid_refit_window_equals_the_straight_run():
    def make():
        return _port_workflow(HostSphere(), refit_every=3)[0]

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        wf_a = make()
        straight = wf_a.run(wf_a.init(4), 10, checkpointer=WorkflowCheckpointer(d1, every=2))
        wf_b = make()
        wf_b.run(wf_b.init(4), 7, checkpointer=WorkflowCheckpointer(d2, every=2))
        resumed = make().resume(WorkflowCheckpointer(d2, every=2), 10)
        _assert_equal(resumed, straight)
        assert int(resumed.sur.refits) == 3


def test_bf16_storage_keeps_the_right_dtypes():
    wf, _ = _port_workflow(dtype_policy=BF16_STORAGE)
    state = wf.run(wf.init(0), 6)
    sur = state.sur
    assert sur.archive.x.dtype == torch.bfloat16
    assert sur.archive.y.dtype == torch.float32
    assert sur.model.chol.dtype == sur.model.x.dtype == sur.model.alpha.dtype == torch.float32
    assert state.algo.population.dtype == torch.bfloat16
    assert int(sur.true_evals) < 6 * POP
