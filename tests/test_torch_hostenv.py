"""The port's host environment problems against the JAX package on the CPU:
the native C++ engine (the port's own build of its copy of ``vecenv.cpp``)
against the JAX package's build of the same source, bit for bit on all four
envs, and against ``NumpyCartPoleVec``; ``HostEnvProblem``'s returns
against JAX's with the JAX seed injected; the optional adapters (envpool,
brax, evoxbench) with the JAX tests' fake dependencies
(``tests/_fake_optional_deps.py``)."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.problems.neuroevolution import HostEnvProblem as JaxHostEnvProblem
from evox_tpu.problems.neuroevolution import NativeVectorEnv as JaxNativeVectorEnv
from evox_tpu.problems.neuroevolution import NumpyCartPoleVec as JaxCartPoleVec
from evox_tpu.problems.neuroevolution import flat_mlp_policy as jax_flat_mlp_policy
from evox_tpu.problems.neuroevolution.control import envs as jax_envs
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems import evoxbench
from evox_tpu_torch.problems.neuroevolution import (
    HostEnvProblem,
    NativeVectorEnv,
    NumpyCartPoleVec,
    envpool_make,
    flat_mlp_policy,
    mlp_policy,
    native_available,
)
from evox_tpu_torch.problems.neuroevolution import _native
from evox_tpu_torch.utils.common import TreeAndVector
from tests._fake_optional_deps import install_fake_brax, install_fake_envpool

ENVS = {"cartpole": 2, "pendulum": 1, "mountain_car": 1, "acrobot": 3}  # name -> act_dim
# The policy's float32 forward: an 8-term (or 16-term) dot product, tanh
# and another dot product, which XLA and PyTorch's CPU kernels sum in
# different orders and whose tanh may differ in the last ulp.
POLICY_RTOL, POLICY_ATOL = 1e-5, 1e-6
# A continuous action one ulp apart moves a 50-step float32 pendulum return
# by about 1e-7 of itself.
RETURN_RTOL = 1e-5


def _jax_native(name, n, max_steps, threads=1):
    """The JAX package's engine, or a skip where its build cannot run (its
    own tests skip so)."""
    from evox_tpu.problems.neuroevolution import native_available as jax_native_available

    if not jax_native_available():
        pytest.skip("the JAX package's native vecenv does not build here")
    return JaxNativeVectorEnv(name, n, max_steps=max_steps, num_threads=threads)


def test_native_build_is_the_ports_own():
    assert native_available()
    lib = _native.library_path()
    assert lib.exists() and lib.parent == _native.BUILD_DIR
    assert lib.parent.name == "_build" and lib.parent.parent.name == "evox_tpu_torch"
    src = _native.SOURCE
    assert src.read_bytes() == (
        _native.BUILD_DIR.parent.parent / "evox_tpu/problems/neuroevolution/_native/vecenv.cpp"
    ).read_bytes()
    assert not list(src.parent.glob("*.so"))  # nothing written beside the source
    assert _native.CXX_FLAGS == ("-O3", "-ffp-contract=off", "-std=c++14", "-shared", "-fPIC",
                                 "-pthread")


@pytest.mark.parametrize("name", sorted(ENVS))
def test_native_engine_equals_the_jax_packages_bit_for_bit(name):
    n, horizon = 37, 40
    ours, ref = NativeVectorEnv(name, n, max_steps=horizon), _jax_native(name, n, horizon)
    assert (ours.obs_dim, ours.act_dim, ours.state_dim) == (ref.obs_dim, ref.act_dim,
                                                             ref.state_dim)
    np.testing.assert_array_equal(ours.reset(2024), ref.reset(2024))
    rng = np.random.default_rng(5)
    for t in range(horizon + 5):  # crosses the truncation horizon
        a = (2.0 * rng.standard_normal((n, ENVS[name]))).astype(np.float32)
        for x, y in zip(ours.step(a), ref.step(a)):
            np.testing.assert_array_equal(x, y, err_msg=f"{name} step {t}")
        np.testing.assert_array_equal(ours.get_state(), ref.get_state())
    state = np.random.default_rng(6).uniform(-0.3, 0.3, size=(n, ours.state_dim))
    ours.set_state(state)
    ref.set_state(state)
    np.testing.assert_array_equal(ours.get_state(), state)
    a = rng.standard_normal((n, ENVS[name])).astype(np.float32)
    for x, y in zip(ours.step(a), ref.step(a)):
        np.testing.assert_array_equal(x, y)


def test_native_engine_equals_numpy_cartpole():
    """Synced states, then 120 steps: observations, rewards and flags bit
    for bit (both integrate in float64 with the same association and no FP
    contraction)."""
    n = 64
    cxx = NativeVectorEnv("cartpole", n, max_steps=100)
    ref = NumpyCartPoleVec(num_envs=n, max_steps=100)
    ref.reset(123)
    cxx.reset(0)
    cxx.set_state(ref._s.copy())
    rng = np.random.default_rng(7)
    for t in range(120):
        a = rng.standard_normal((n, 2)).astype(np.float32)
        for x, y in zip(ref.step(a), cxx.step(a)):
            np.testing.assert_array_equal(x, y, err_msg=f"step {t}")


def test_numpy_cartpole_equals_the_jax_packages():
    ours, ref = NumpyCartPoleVec(16, max_steps=30), JaxCartPoleVec(16, max_steps=30)
    np.testing.assert_array_equal(ours.reset(9), ref.reset(9))
    rng = np.random.default_rng(2)
    for _ in range(35):
        a = rng.standard_normal((16, 2)).astype(np.float32)
        for x, y in zip(ours.step(a), ref.step(a)):
            np.testing.assert_array_equal(x, y)


def test_native_pendulum_matches_jax_pendulum_env():
    """One step of the C++ pendulum against the JAX package's EnvSpec
    dynamics: the JAX env integrates in float32, the engine in float64
    (the JAX test's own 1e-5)."""
    n = 16
    spec = jax_envs.pendulum(max_steps=50)
    cxx = NativeVectorEnv("pendulum", n, max_steps=50)
    cxx.reset(3)
    state0 = cxx.get_state()
    actions = np.linspace(-2.5, 2.5, n, dtype=np.float32)[:, None]

    def jax_step(s, a):
        new_s, reward, _ = spec.step(jnp.asarray(s, dtype=jnp.float32), a)
        return spec.obs(new_s), reward

    jobs, jrew = jax.vmap(jax_step)(jnp.asarray(state0), jnp.asarray(actions))
    cobs, crew, cterm, _ = cxx.step(actions)
    np.testing.assert_allclose(cobs, np.asarray(jobs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(crew, np.asarray(jrew), rtol=1e-5, atol=1e-5)
    assert not cterm.any()


def test_native_threads_deterministic():
    a = NativeVectorEnv("acrobot", 33, max_steps=60, num_threads=1)
    b = NativeVectorEnv("acrobot", 33, max_steps=60, num_threads=4)
    np.testing.assert_array_equal(a.reset(9), b.reset(9))
    rng = np.random.default_rng(11)
    for _ in range(30):
        act = rng.standard_normal((33, 3)).astype(np.float32)
        for x, y in zip(a.step(act), b.step(act)):
            np.testing.assert_array_equal(x, y)


def test_native_rejects_bad_arguments():
    with pytest.raises(ValueError, match="unknown env"):
        NativeVectorEnv("hopper", 4)
    env = NativeVectorEnv("cartpole", 4)
    with pytest.raises(ValueError, match="actions shape"):
        env.step(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="state shape"):
        env.set_state(np.zeros((3, 4)))


class _Recorder:
    """Wraps a host vector env, keeping each step's actions."""

    def __init__(self, env):
        self.env, self.actions = env, []
        self.num_envs, self.obs_dim = env.num_envs, env.obs_dim

    def reset(self, seed):
        return self.env.reset(seed)

    def step(self, actions):
        self.actions.append(np.array(actions, dtype=np.float32))
        return self.env.step(actions)


class _Replay:
    """A policy that emits recorded actions, one step per call."""

    def __init__(self, actions):
        self.actions, self.t = actions, 0

    def __call__(self, pop, obs):
        a = torch.from_numpy(self.actions[self.t]).to(obs.device)
        self.t += 1
        return a


def _jax_seed(key):
    _, k_seed = jax.random.split(key)
    return int(jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max))


@pytest.mark.parametrize("make_env,act_dim,obs_dim,cap", [
    (lambda n, jx: (JaxCartPoleVec if jx else NumpyCartPoleVec)(n, max_steps=80), 2, 4, 80),
    (lambda n, jx: (_jax_native if jx else NativeVectorEnv)("cartpole", n, 80), 2, 4, None),
    (lambda n, jx: (_jax_native if jx else NativeVectorEnv)("pendulum", n, 60), 1, 3, 50),
], ids=["numpy_cartpole", "native_cartpole", "native_pendulum"])
def test_host_env_returns_match_jax_with_its_seed(make_env, act_dim, obs_dim, cap):
    """JAX's reset seed injected through ``_episode_seed``. Returns are
    equal bit for bit where the actions are equal: the envs whose actions
    are bitwise equal at every step for a continuous action, and whose
    decisions (a[1] > a[0]) agree at every step for a discrete one. The whole population is also
    replayed with JAX's recorded actions, which must give JAX's returns
    bit for bit (the copies, the done mask, the cap and the float32 sum),
    and the port's policy on JAX's observations agrees with JAX's actions
    within the policy tolerance."""
    n = 24
    apply_j, dim = jax_flat_mlp_policy(obs_dim, 8, act_dim)
    apply_t, _ = flat_mlp_policy(obs_dim, 8, act_dim)
    pop = (0.5 * np.random.default_rng(1).standard_normal((n, dim))).astype(np.float32)
    key = jax.random.PRNGKey(7)

    ref_env = _Recorder(make_env(n, True))
    ref = JaxHostEnvProblem(apply_j, ref_env, cap_episode_length=cap)
    f_ref, _ = ref.evaluate(key, jnp.asarray(pop))
    f_ref = np.asarray(f_ref)
    seed = _jax_seed(key)

    env = _Recorder(make_env(n, False))
    ours = HostEnvProblem(apply_t, env, cap_episode_length=cap, device="cpu")
    ours._episode_seed = lambda state: (seed, state)
    f, _ = ours.evaluate(ours.init(), torch.from_numpy(pop))
    assert f.dtype == torch.float32 and f.shape == (n,)

    replay = HostEnvProblem(_Replay(ref_env.actions), make_env(n, False), cap_episode_length=cap,
                            device="cpu")
    replay.batched_policy = replay.policy  # the recorded actions are already batched
    replay._episode_seed = lambda state: (seed, state)
    f_replay, _ = replay.evaluate(0, torch.from_numpy(pop))
    np.testing.assert_array_equal(f_replay.numpy(), f_ref)

    steps = min(len(env.actions), len(ref_env.actions))
    if act_dim == 1:  # equal actions: bitwise equal at every step
        assert len(env.actions) == len(ref_env.actions)
        same = np.all([np.all(env.actions[t] == ref_env.actions[t], axis=1)
                       for t in range(steps)], axis=0)
        np.testing.assert_allclose(f.numpy(), f_ref, rtol=RETURN_RTOL)
    else:  # equal decisions (a[1] > a[0]) at every step
        decide = lambda a: a[:, 1] > a[:, 0]
        same = np.all([decide(env.actions[t]) == decide(ref_env.actions[t])
                       for t in range(steps)], axis=0)
        assert same.mean() >= 0.9  # near-ties are rare
    np.testing.assert_array_equal(f.numpy()[same], f_ref[same])
    # the port's policy on the observations JAX saw at its first step
    obs0 = make_env(n, False).reset(seed)
    np.testing.assert_allclose(apply_t(torch.from_numpy(pop), torch.from_numpy(obs0)).numpy(),
                               ref_env.actions[0], rtol=POLICY_RTOL, atol=POLICY_ATOL)
    assert float(f_ref.max()) != 0.0  # episodes ran


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_host_env_problem_trains_cartpole(native):
    pop_size = 32
    init_params, apply = mlp_policy((4, 8, 2))
    adapter = TreeAndVector(init_params(0, device="cpu"))
    env = NativeVectorEnv("cartpole", pop_size, max_steps=200) if native else \
        NumpyCartPoleVec(num_envs=pop_size, max_steps=200)
    prob = HostEnvProblem(apply, env, cap_episode_length=200, device="cpu")
    algo = PSO(-2.0 * torch.ones(adapter.dim), 2.0 * torch.ones(adapter.dim), pop_size,
               device="cpu")
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, prob, monitors=(mon,), opt_direction="max",
                     pop_transforms=(adapter.batched_to_tree,), device="cpu")
    state = wf.init(1)
    for _ in range(15):
        state = wf.step(state)
    best = float(mon.get_best_fitness(state.monitors[0]))
    assert best > 50.0, f"host cartpole best {best}"


def test_host_env_seed_advances_with_the_state():
    apply, dim = flat_mlp_policy(4, 8, 2)
    prob = HostEnvProblem(apply, NumpyCartPoleVec(4, max_steps=20), device="cpu")
    pop = 0.01 * torch.ones((4, dim))
    s0 = prob.init(3)
    f1, s1 = prob.evaluate(s0, pop)
    f2, s2 = prob.evaluate(s1, pop)
    assert s1 != s0 and s2 != s1
    assert torch.equal(prob.evaluate(s0, pop)[0], f1)  # a pure function of the state
    seeds = {prob._episode_seed(s)[0] for s in (s0, s1, s2)}
    assert len(seeds) == 3 and all(0 <= x < 2**31 - 1 for x in seeds)


def test_host_env_copies_go_through_its_host_link():
    """One observation copy in and one action copy out a step, and the
    return in once an evaluation, all counted by the problem's link."""
    apply, dim = flat_mlp_policy(4, 8, 2)
    env = _Recorder(NumpyCartPoleVec(6, max_steps=15))
    prob = HostEnvProblem(apply, env, cap_episode_length=15, device="cpu")
    prob.evaluate(prob.init(1), 0.1 * torch.ones((6, dim)))
    steps = len(env.actions)
    report = prob.host_link.report()
    assert steps > 0 and not report["pinned"]
    assert (report["d2h"], report["h2d"]) == (steps, steps + 1)
    assert report["d2h_bytes"] == steps * 6 * 2 * 4
    assert report["h2d_bytes"] == steps * 6 * 4 * 4 + 6 * 4


class _IntObsEnv:
    """A host env whose observations are integers of ``dtype``: the state
    counts up from the seed, the reward is the action, and every episode
    ends after three steps."""

    obs_dim = 3

    def __init__(self, num_envs, dtype):
        self.num_envs, self.dtype, self._t, self._s = num_envs, dtype, 0, None

    def reset(self, seed):
        self._t = 0
        base = np.arange(self.num_envs * self.obs_dim).reshape(self.num_envs, self.obs_dim)
        self._s = (base + int(seed) % 7) % 5
        return self._s.astype(self.dtype)

    def step(self, actions):
        self._t += 1
        self._s = (self._s + 1) % 5
        reward = np.asarray(actions, dtype=np.float64).reshape(self.num_envs)
        term = np.full((self.num_envs,), self._t >= 3)
        return self._s.astype(self.dtype), reward, term, np.zeros((self.num_envs,), bool)


@pytest.mark.parametrize("dtype", [np.uint8, np.int64], ids=["uint8", "int64"])
def test_integer_observations_are_cast_to_float32_as_jax_does(dtype):
    """The reference casts a host env's observations to float32 before the
    policy sees them; the port casts on the host too, so a policy ``o @ w``
    over uint8 or int64 observations gives the JAX problem's fitness."""
    n = 4
    pop = np.random.default_rng(5).standard_normal((n, _IntObsEnv.obs_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = JaxHostEnvProblem(lambda w, o: o @ w, _IntObsEnv(n, dtype))
    f_ref, _ = ref.evaluate(key, jnp.asarray(pop))
    ours = HostEnvProblem(lambda w, o: o @ w, _IntObsEnv(n, dtype), device="cpu")
    seed = _jax_seed(key)
    ours._episode_seed = lambda state: (seed, state)
    f, _ = ours.evaluate(ours.init(), torch.from_numpy(pop))
    assert f.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))


# ------------------------------------------------------ optional adapters
def test_envpool_make_matches_numpy_cartpole_golden(monkeypatch):
    """``envpool_make`` adapts the EnvPool gymnasium API (the JAX tests'
    fake, on the same CartPole dynamics) to ``HostVectorEnv`` and equals
    ``HostEnvProblem`` on ``NumpyCartPoleVec`` seeded alike; the seed
    warning fires once."""
    install_fake_envpool(monkeypatch)
    n, seed = 8, 1234
    env_pool = envpool_make("FakeCartPole-v1", num_envs=n,
                            action_transform=lambda a: np.argmax(a, axis=-1),
                            seed=seed, max_steps=60)
    assert env_pool.num_envs == n and env_pool.obs_dim == 4
    apply, dim = flat_mlp_policy(4, 8, 2)
    pop = torch.from_numpy((0.5 * np.random.default_rng(5).standard_normal((n, dim)))
                           .astype(np.float32))
    p_pool = HostEnvProblem(apply, env_pool, cap_episode_length=60, device="cpu")
    with pytest.warns(UserWarning, match="ignores the per-evaluation seed"):
        f_pool, state = p_pool.evaluate(p_pool.init(2), pop)

    class SeededCartPole(NumpyCartPoleVec):
        def reset(self, _seed):
            return super().reset(seed)

    p_gold = HostEnvProblem(apply, SeededCartPole(n, max_steps=60), cap_episode_length=60,
                            device="cpu")
    f_gold, _ = p_gold.evaluate(p_gold.init(2), pop)
    np.testing.assert_array_equal(f_pool.numpy(), f_gold.numpy())
    assert float(f_pool.max()) > 1.0
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p_pool.evaluate(state, pop)  # no second warning


@pytest.mark.skipif(importlib.util.find_spec("envpool") is not None,
                    reason="real envpool installed")
def test_envpool_missing_dep_message():
    with pytest.raises(ImportError, match="envpool is not installed"):
        envpool_make("CartPole-v1", num_envs=4)


@pytest.mark.skipif(importlib.util.find_spec("brax") is not None, reason="real brax installed")
def test_brax_env_missing_dep_message():
    from evox_tpu_torch.problems.neuroevolution.control import brax_env

    with pytest.raises(ImportError, match="brax is not installed"):
        brax_env("whatever")


def test_brax_env_refused_with_brax_present(monkeypatch):
    install_fake_brax(monkeypatch)
    from evox_tpu_torch.problems.neuroevolution.control.brax_adapter import brax_env

    with pytest.raises(NotImplementedError, match="imports no JAX"):
        brax_env("fake_pendulum", max_steps=7)


def test_brax_env_refusal_imports_neither_brax_nor_jax(tmp_path):
    """An installed brax is found without being imported: a fresh process
    with a brax package whose import loads JAX is refused with JAX still
    out of ``sys.modules``."""
    (tmp_path / "brax").mkdir()
    (tmp_path / "brax" / "__init__.py").write_text("import jax\n")
    (tmp_path / "brax" / "envs.py").write_text("import jax\n")
    code = (
        "import sys\n"
        "from evox_tpu_torch.problems.neuroevolution.control.brax_adapter import brax_env\n"
        "try:\n"
        "    brax_env('ant')\n"
        "except NotImplementedError:\n"
        "    print('refused', 'jax' in sys.modules, 'brax' in sys.modules)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), repo]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["refused", "False", "False"]


@pytest.mark.parametrize("suite,bad", [(evoxbench.C10MOP, 10), (evoxbench.CitySegMOP, 16),
                                       (evoxbench.IN1kMOP, 0)])
def test_evoxbench_suites_refused_without_the_package(suite, bad):
    with pytest.raises(ValueError, match="problem_id"):
        suite(bad)
    if importlib.util.find_spec("evoxbench") is None:
        with pytest.raises(ImportError, match="evoxbench"):
            suite(1)


def test_evoxbench_problem_is_a_host_problem_with_a_seed_chain():
    class Bench:  # the duck type EvoXBenchProblem reads
        class evaluator:
            n_objs = 2

        class search_space:
            lb, ub = [0, 0, 0], [3, 3, 3]

        @staticmethod
        def evaluate(x):
            noise = np.random.random((x.shape[0], 2))
            return np.stack([x.sum(1), -x.sum(1)], 1) + noise  # float64, coerced

    prob = evoxbench.EvoXBenchProblem(Bench())
    assert not prob.jittable and prob.fit_shape(5) == (5, 2)
    assert prob.lb.dtype == np.float32 and prob.ub.tolist() == [3, 3, 3]
    pop = np.ones((5, 3), np.float32)
    prob.init(11)
    a, _ = prob.evaluate(None, pop)
    b, _ = prob.evaluate(None, pop)
    assert a.dtype == np.float32 and a.shape == (5, 2) and not np.array_equal(a, b)
    prob.init(11)
    np.testing.assert_array_equal(prob.evaluate(None, pop)[0], a)
