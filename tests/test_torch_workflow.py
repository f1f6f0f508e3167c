"""StdWorkflow of the port against the JAX package, and the slice as a
whole: OpenES + fused pendulum rollouts through StdWorkflow, on the CPU,
with JAX's noise and reset draws handed to the port."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.core.monitor import Monitor as JaxMonitor
from evox_tpu.core.problem import Problem as JaxProblemBase
from evox_tpu.kernels import rollout as jkr
from evox_tpu.problems.neuroevolution import PolicyRolloutProblem as JaxRolloutProblem
from evox_tpu.problems.neuroevolution import flat_mlp_policy as jax_flat_mlp_policy
from evox_tpu.utils.common import rank_based_fitness as jax_rank_based_fitness
from evox_tpu_torch import Monitor, Problem, StdWorkflow, interop
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so import pso as tpso
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.core.monitor import HOOK_NAMES
from evox_tpu_torch.kernels import packed_dominance, partial_topk
from evox_tpu_torch.kernels import rollout as tkr
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, flat_mlp_policy
from evox_tpu_torch.problems.numerical import LSMOP1, ZDT1
from evox_tpu_torch.utils import rank_based_fitness

REPO = Path(__file__).resolve().parent.parent


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _substitute_noise(algo, halves):
    """The n-th new noise seed the port sees gets JAX's n-th draw."""
    by_seed = {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.as_tensor(np.array(halves[len(by_seed)]))
        return by_seed[seed]

    algo._draw_noise = draw


def _recorder(base):
    """A monitor class over ``base`` that logs (hook, numbers seen)."""

    class Recorder(base):
        def __init__(self, log):
            self.log = log

        def hooks(self):
            return HOOK_NAMES

    def hook(name):
        def method(self, mstate, *args):
            arrays = [np.asarray(a) for a in args if hasattr(a, "shape")]
            self.log.append((name, arrays))
            return mstate

        return method

    for name in HOOK_NAMES:
        setattr(Recorder, name, hook(name))
    return Recorder


class _JaxSphere(JaxProblemBase):
    def evaluate(self, state, pop):
        return jnp.sum(pop**2, axis=1), state


class _Sphere(Problem):
    def evaluate(self, state, pop):
        return torch.sum(pop**2, dim=1), state


def test_hook_order_and_hook_data_match_jax():
    pop_size, dim, gens = 8, 3, 2
    jlog, tlog = [], []
    jalgo = JaxOpenES(np.ones(dim, np.float32), pop_size, noise_stdev=0.1)
    jwf = JaxStdWorkflow(jalgo, _JaxSphere(), monitors=[_recorder(JaxMonitor)(jlog)],
                         opt_direction="max", fit_transforms=[jax_rank_based_fitness],
                         jit_step=False)
    jstate = jwf.init(jax.random.PRNGKey(0))
    talgo = OpenES(np.ones(dim, np.float32), pop_size, noise_stdev=0.1, device="cpu")
    twf = StdWorkflow(talgo, _Sphere(), monitors=[_recorder(Monitor)(tlog)],
                      opt_direction="max", fit_transforms=[rank_based_fitness], device="cpu")
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    halves = []
    for _ in range(gens):
        jstate = jwf.step(jstate)
        halves.append(np.asarray(jax.random.normal(jstate.algo.noise_key, (pop_size // 2, dim))))
    _substitute_noise(talgo, halves)
    tstate = twf.run(tstate, gens)

    assert [n for n, _ in tlog] == [n for n, _ in jlog] == list(HOOK_NAMES) * gens
    for (name, jarrs), (_, tarrs) in zip(jlog, tlog):
        assert len(jarrs) == len(tarrs), name
        for ja, ta in zip(jarrs, tarrs):
            np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6, err_msg=name)
    # post_eval sees the raw fitness, pre_tell the flipped and shaped one
    post_eval = [a for n, a in tlog if n == "post_eval"][0][1]
    pre_tell = [a for n, a in tlog if n == "pre_tell"][0][0]
    assert (post_eval >= 0).all() and pre_tell.min() == -0.5 and pre_tell.max() == 0.5
    assert tstate.generation == int(jstate.generation) == gens
    np.testing.assert_allclose(tstate.algo.center.numpy(), np.asarray(jstate.algo.center),
                               rtol=1e-5, atol=1e-6)


def test_slice_openes_fused_pendulum_matches_jax_over_three_generations():
    """The slice as a whole, at pop 16, T 20, hidden 8: both packages start
    from the same state (through interop), see the same noise and resets,
    and end with the same center.

    Tolerance: each fitness differs by last-ulp rounding of sin/cos/tanh
    between the two libraries, compounded over 20 steps (the JAX package's
    engine tolerance is 2e-4); the center moves by lr * grad with a grad
    that sums 8 such differences, over 3 generations. Measured: 1.2e-5
    absolute on centers of size 0.6."""
    pop_size, hidden, T, gens = 16, 8, 20, 3
    jsoa, tsoa = jkr.pendulum_soa(T), tkr.pendulum_soa(T)
    japply, dim = jax_flat_mlp_policy(3, hidden, 1)
    tapply, _ = flat_mlp_policy(3, hidden, 1)
    kw = dict(num_episodes=2, stochastic_reset=False, early_exit=False)
    jwf = JaxStdWorkflow(
        JaxOpenES(jnp.zeros(dim), pop_size, learning_rate=0.05, noise_stdev=0.05),
        JaxRolloutProblem(japply, jsoa.base, fused_env=jsoa, fused_interpret=True, **kw),
        opt_direction="max",
    )
    talgo = OpenES(torch.zeros(dim), pop_size, learning_rate=0.05, noise_stdev=0.05, device="cpu")
    tprob = PolicyRolloutProblem(tapply, tsoa.base, fused_env=tsoa, device="cpu", **kw)
    twf = StdWorkflow(talgo, tprob, opt_direction="max", device="cpu")

    jstate = jwf.init(jax.random.PRNGKey(0))
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    # stochastic_reset=False: every generation rolls out from the same resets
    k_eps = jax.random.fold_in(jstate.prob.key, 0)
    resets = np.asarray(jax.vmap(jsoa.base.reset)(jax.random.split(k_eps, 2)))
    tprob._episode_states = lambda seed, env: torch.as_tensor(resets.copy())

    halves = []
    for _ in range(gens):
        jstate = jwf.step(jstate)
        halves.append(np.asarray(jax.random.normal(jstate.algo.noise_key, (pop_size // 2, dim))))
    _substitute_noise(talgo, halves)
    launches = tkr.fused_rollout.launches
    tstate = twf.run(tstate, gens)

    assert tstate.generation == int(jstate.generation) == gens
    assert tkr.fused_rollout.launches == launches  # the CPU route launches nothing
    jcenter = np.asarray(jstate.algo.center)
    assert np.abs(jcenter).max() > 0.1  # the slice moved the center
    np.testing.assert_allclose(tstate.algo.center.numpy(), jcenter, rtol=2e-4, atol=5e-5)


def test_entry_points_refuse_a_missing_cuda(monkeypatch):
    """device=None means cuda: without a card every entry point raises,
    and nothing goes on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    soa = tkr.pendulum_soa()
    apply, dim = flat_mlp_policy(3, 16, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OpenES(torch.zeros(dim), 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyRolloutProblem(apply, soa.base, fused_env=soa)
    algo = OpenES(torch.zeros(dim), 4, device="cpu")
    prob = PolicyRolloutProblem(apply, soa.base, fused_env=soa, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StdWorkflow(algo, prob)
    theta = torch.zeros(2, dim)
    planes = {"th": torch.zeros(2), "thdot": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkr.fused_rollout(theta, planes, 3)
    # asked for the CPU, the same calls run
    assert tkr.fused_rollout(theta, planes, 3, device="cpu").shape == (2,)
    # the NSGA-II slice's entry points
    fitness = torch.rand(40, 3)
    for make in (lambda: NSGA2(torch.zeros(5), torch.ones(5), n_objs=3, pop_size=8),
                 lambda: LSMOP1(d=30, m=3), lambda: ZDT1(n_dim=5),
                 lambda: partial_topk(fitness[:, 0], 4), lambda: packed_dominance(fitness)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert partial_topk(fitness[:, 0], 4, device="cpu")[1].shape == (4,)
    assert packed_dominance(fitness, device="cpu")[0].shape == (2, 40)
    nsga2 = NSGA2(torch.zeros(5), torch.ones(5), n_objs=3, pop_size=8, device="cpu")
    lsmop = LSMOP1(d=5, m=3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StdWorkflow(nsga2, lsmop)
    assert StdWorkflow(nsga2, lsmop, device="cpu").init(0).algo.population.shape == (8, 5)
    # the CSO / PSO-family slice's entry points
    lb, ub = torch.zeros(3), torch.ones(3)
    swarms = {
        "CSO": lambda **kw: tpso.CSO(lb, ub, 8, **kw),
        "PSO": lambda **kw: tpso.PSO(lb, ub, 8, **kw),
        "CLPSO": lambda **kw: tpso.CLPSO(lb, ub, 8, **kw),
        "SLPSOGS": lambda **kw: tpso.SLPSOGS(lb, ub, 8, **kw),
        "SLPSOUS": lambda **kw: tpso.SLPSOUS(lb, ub, 8, **kw),
        "FIPS": lambda **kw: tpso.FIPS(lb, ub, 8, **kw),
        "DMSPSOEL": lambda **kw: tpso.DMSPSOEL(lb, ub, 8, sub_swarm_size=4, **kw),
        "FSPSO": lambda **kw: tpso.FSPSO(8, 3, **kw),
        "SwmmPSO": lambda **kw: tpso.SwmmPSO(lb, ub, 8, shortcut_p=0.1, **kw),
    }
    for name, make in swarms.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").init(0).population.shape == (8, 3), name
    for make in (EvalMonitor, lambda: tpso.topology.ring_neighbours(8),
                 lambda: tpso.topology.square_neighbours(8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    mon = EvalMonitor(device="cpu")
    cso = swarms["CSO"](device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StdWorkflow(cso, ZDT1(n_dim=3, device="cpu"), monitors=[mon])
    assert mon.post_eval(mon.init(), torch.zeros(4, 3), torch.rand(4)).topk_fitness.shape == (1,)
    # the run machinery's entry points: a host problem's workflow, and the
    # placement of a restored snapshot
    from evox_tpu_torch.workflows.checkpoint import restore_layouts

    class HostProblem(Problem):
        jittable = False

        def evaluate(self, state, pop):
            return np.sum(pop**2, axis=1), state

    with pytest.raises(RuntimeError, match="device='cpu'"):
        StdWorkflow(cso, HostProblem())
    snapshot = StdWorkflow(cso, HostProblem(), device="cpu").init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_layouts(snapshot)
    assert restore_layouts(snapshot, "cpu").algo.population.device.type == "cpu"


def _post_eval_fitness(log):
    return [arrays[1] for name, arrays in log if name == "post_eval"]


def test_eval_shard_map_matches_jax_and_the_unsharded_run():
    """``StdWorkflow(mesh=, eval_shard_map=True)``: each of 8 shards scores
    its block of OpenES's candidates on Sphere. The fitness and the state
    equal the port's unsharded run bit for bit (Sphere is row by row), and
    JAX's ``StdWorkflow(mesh=, eval_shard_map=True)`` on its 8 virtual
    devices within the hook test's tolerance (the two libraries' sums)."""
    from evox_tpu.core.distributed import create_mesh as jax_create_mesh
    from evox_tpu_torch.core.distributed import create_mesh

    pop_size, dim, gens = 16, 3, 3
    jlog = []
    jwf = JaxStdWorkflow(JaxOpenES(np.ones(dim, np.float32), pop_size, noise_stdev=0.1),
                         _JaxSphere(), monitors=[_recorder(JaxMonitor)(jlog)],
                         mesh=jax_create_mesh(), eval_shard_map=True, jit_step=False)
    jstate = jwf.init(jax.random.PRNGKey(3))
    halves = []
    for _ in range(gens):
        jstate = jwf.step(jstate)
        halves.append(np.asarray(jax.random.normal(jstate.algo.noise_key, (pop_size // 2, dim))))
    runs = {}
    for sharded in (True, False):
        log = []
        algo = OpenES(np.ones(dim, np.float32), pop_size, noise_stdev=0.1, device="cpu")
        kw = dict(mesh=create_mesh(devices=["cpu"] * 8), eval_shard_map=True) if sharded else {}
        wf = StdWorkflow(algo, _Sphere(), monitors=[_recorder(Monitor)(log)], device="cpu", **kw)
        _substitute_noise(algo, halves)
        state = interop.std_workflow_state(wf, _numpy_tree(jwf.init(jax.random.PRNGKey(3))))
        for _ in range(gens):
            state = wf.step(state)
        runs[sharded] = (state, _post_eval_fitness(log))
    (sharded, fit_sharded), (plain, fit_plain) = runs[True], runs[False]
    assert len(fit_sharded) == len(fit_plain) == gens
    for a, b in zip(fit_sharded, fit_plain):
        np.testing.assert_array_equal(a, b)
    from evox_tpu_torch.core.struct import named_leaves

    for (name, a), (_, b) in zip(named_leaves(sharded.algo), named_leaves(plain.algo)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name
    for a, b in zip(fit_sharded, _post_eval_fitness(jlog)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sharded.algo.center.numpy(), np.asarray(jstate.algo.center),
                               rtol=1e-5, atol=1e-6)
    assert sharded.generation == int(jstate.generation) == gens


def _pso_tell_draws(jax_algo_state):
    """JAX PSO's tell draws from the state its tell receives (its ask
    leaves the state as it was)."""
    _, k1, k2 = jax.random.split(jax_algo_state.key, 3)
    shape = jax_algo_state.population.shape
    return tuple(torch.as_tensor(np.array(jax.random.uniform(k, shape))) for k in (k1, k2))


@pytest.mark.parametrize("direction", ["min", "max"])
def test_migrate_helper_migrates_as_jax_does(direction):
    """``StdWorkflow(migrate_helper=)``: a helper polled once a generation
    that hands PSO three foreign rows on generations 1, 3 and 4. Every
    state field equals JAX's ``migrate_helper`` run on the same draws and
    rows (``tests/test_torch_pso.py``'s tolerance), the foreign fitness
    sign-flipped for ``"max"``, and the migrants reach the personal bests."""
    from evox_tpu.algorithms.so.pso import PSO as JaxPSO

    dim, pop_size, gens = 3, 12, 5
    sign = 1.0 if direction == "min" else -1.0
    lb, ub = np.full(dim, -10.0, np.float32), np.full(dim, 10.0, np.float32)
    foreign = (0.01 * np.random.default_rng(7).standard_normal((3, dim))).astype(np.float32)
    foreign_fit = (sign * np.sum(foreign**2, axis=1)).astype(np.float32)
    schedule = (False, True, False, True, True)

    def helper(to_array):
        polls = []

        def poll():
            on = schedule[len(polls)]
            polls.append(on)
            return to_array(on), to_array(foreign), to_array(foreign_fit)

        return poll, polls

    class JaxSignedSphere(JaxProblemBase):
        def evaluate(self, state, pop):
            return sign * jnp.sum(pop**2, axis=1), state

    class SignedSphere(Problem):
        def evaluate(self, state, pop):
            return sign * torch.sum(pop**2, dim=1), state

    jpoll, jpolls = helper(jnp.asarray)
    jwf = JaxStdWorkflow(JaxPSO(lb, ub, pop_size), JaxSignedSphere(), opt_direction=direction,
                         migrate_helper=jpoll, jit_step=False)
    talgo = tpso.PSO(lb, ub, pop_size, device="cpu")
    tpoll, tpolls = helper(lambda x: torch.as_tensor(np.array(x)))
    twf = StdWorkflow(talgo, SignedSphere(), opt_direction=direction, migrate_helper=tpoll,
                      device="cpu")
    jstate = jwf.init(jax.random.PRNGKey(5))
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    for _ in range(gens):
        draws = _pso_tell_draws(jstate.algo)
        talgo._draw = lambda seed, draws=draws: draws
        jstate, tstate = jwf.step(jstate), twf.step(tstate)
        for name in ("population", "velocity", "pbest_position", "pbest_fitness",
                     "gbest_position", "gbest_fitness"):
            np.testing.assert_allclose(getattr(tstate.algo, name).numpy(),
                                       np.asarray(getattr(jstate.algo, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert tpolls == jpolls == list(schedule)
    # the migrants' fitness, in the internal minimisation, is among the bests
    kept = tstate.algo.pbest_fitness.numpy()
    assert np.isin(np.abs(foreign_fit), kept).sum() >= 1


def test_deferred_arguments_raise():
    soa = tkr.pendulum_soa()
    apply, dim = flat_mlp_policy(3, 16, 1)
    algo = OpenES(torch.zeros(dim), 4, device="cpu")
    prob = PolicyRolloutProblem(apply, soa.base, fused_env=soa, device="cpu")
    # ported since: mesh, eval_shard_map (which needs a mesh), and
    # migrate_helper (which refuses fit_transforms)
    from evox_tpu_torch.core.distributed import create_mesh

    with pytest.raises(ValueError, match="eval_shard_map requires a mesh"):
        StdWorkflow(algo, prob, device="cpu", eval_shard_map=True)
    with pytest.raises(ValueError, match="not divisible"):
        StdWorkflow(algo, prob, device="cpu", mesh=create_mesh(devices=["cpu"] * 3))
    assert StdWorkflow(algo, prob, device="cpu", mesh=create_mesh(devices=["cpu"] * 3),
                       allow_uneven_shards=True).init(0).generation == 0
    with pytest.raises(ValueError, match="migrate_helper"):
        StdWorkflow(algo, prob, device="cpu", migrate_helper=lambda: None,
                    fit_transforms=(rank_based_fitness,))
    wf = StdWorkflow(algo, prob, device="cpu")
    # ported since: external_problem, dtype_policy, donate_carries, and
    # run's checkpointer/resume_from (tests/test_torch_checkpoint.py,
    # test_torch_pipelined.py, test_torch_dtype_policy.py)
    from evox_tpu_torch.core.dtype_policy import BF16_STORAGE

    for kwargs in ({"external_problem": True}, {"dtype_policy": BF16_STORAGE},
                   {"donate_carries": True}):
        assert StdWorkflow(algo, prob, device="cpu", **kwargs).init(0).generation == 0
    with pytest.raises(TypeError, match="DtypePolicy"):
        StdWorkflow(algo, prob, device="cpu", dtype_policy=object())
    # resume(state_sharding=) is ported (tests/test_torch_supervisor.py
    # holds the 8 -> 4 -> 1 resume)
    # ported since: restarts= (IPOP), which needs a GuardedAlgorithm
    from evox_tpu_torch import GuardedAlgorithm, IPOPRestarts

    policy = IPOPRestarts(lambda pop: GuardedAlgorithm(OpenES(torch.zeros(dim), pop, device="cpu")))
    with pytest.raises(TypeError, match="GuardedAlgorithm"):
        wf.run(wf.init(0), 1, restarts=policy)
    # ported since: the problem's helpers and bf16 residency construct, and
    # the refusals the JAX package keeps stay
    from evox_tpu_torch.problems.neuroevolution import CapEpisode, ObsNormalizer

    for kwargs in ({"cap_episode": CapEpisode()}, {"obs_normalizer": ObsNormalizer(3)},
                   {"fused_planes_dtype": torch.bfloat16}):
        PolicyRolloutProblem(apply, soa.base, device="cpu", **kwargs)
        if "fused_planes_dtype" not in kwargs:
            with pytest.raises(ValueError, match="cannot be combined"):
                PolicyRolloutProblem(apply, soa.base, fused_env=soa, device="cpu", **kwargs)
    no_cuda_twin = tkr.SoAEnv(*soa[:-1], cuda_env=None)
    assert no_cuda_twin.cuda_env is None and soa.cuda_env == "pendulum"


def test_interop_carries_populations_and_workflow_state():
    pop = np.random.default_rng(0).normal(size=(6, 81)).astype(np.float32)
    np.testing.assert_array_equal(interop.population(pop, device="cpu").numpy(), pop)
    soa = jkr.pendulum_soa()
    japply, dim = jax_flat_mlp_policy(3, 16, 1)
    jwf = JaxStdWorkflow(JaxOpenES(jnp.arange(dim, dtype=jnp.float32), 4),
                         JaxRolloutProblem(japply, soa.base), opt_direction="max")
    jstate = jwf.step(jwf.init(jax.random.PRNGKey(1)))
    apply, _ = flat_mlp_policy(3, 16, 1)
    twf = StdWorkflow(OpenES(torch.zeros(dim), 4, device="cpu"),
                      PolicyRolloutProblem(apply, tkr.pendulum_soa().base, device="cpu"),
                      device="cpu")
    tstate = interop.std_workflow_state(twf, _numpy_tree(jstate))
    assert tstate.generation == 1 and tstate.first_step is False
    np.testing.assert_array_equal(tstate.algo.center.numpy(), np.asarray(jstate.algo.center))
    assert tstate.algo.opt_state == ()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter: neither
    ``jax`` nor ``evox_tpu`` (exact keys: ``evox_tpu_torch`` starts with
    ``evox_tpu``) may appear in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import evox_tpu_torch\n"
        "for m in pkgutil.walk_packages(evox_tpu_torch.__path__, 'evox_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'evox_tpu')\n"
        "       or k.startswith(('jax.', 'evox_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module)
    return roots


def test_port_and_chip_smoke_sources_name_no_jax_import():
    tools = sorted((REPO / "tools").glob("torch_*.py"))
    files = sorted((REPO / "evox_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] + tools
    assert len(files) > 10 and REPO / "tools" / "torch_topk_sweep.py" in tools
    for path in files:
        for mod in _imported_roots(path):
            assert not (mod in ("jax", "flax", "evox_tpu")
                        or mod.startswith(("jax.", "flax.", "evox_tpu."))), (
                f"{path.relative_to(REPO)} imports {mod}"
            )
    # nor does a port module name a path under the JAX package (its data
    # files: LES's parameters and CEC 2022's constants are the port's copies)
    for path in sorted((REPO / "evox_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not (node.value == "evox_tpu" or node.value.startswith("evox_tpu/")), (
                    f"{path.relative_to(REPO)} names {node.value!r}"
                )
