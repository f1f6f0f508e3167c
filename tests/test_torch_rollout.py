"""The port's rollout stack against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``evox_tpu_torch`` (``device="cpu"``, which takes the plain
PyTorch route of ``fused_rollout``). The JAX fused kernel runs in Pallas
interpret mode, as the JAX package's own tests run it on the CPU. The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.kernels import rollout as jkr
from evox_tpu.problems.neuroevolution import PolicyRolloutProblem as JaxProblem
from evox_tpu.problems.neuroevolution import flat_mlp_policy as jax_flat_mlp_policy
from evox_tpu.problems.neuroevolution.control import envs as jenvs
from evox_tpu_torch.kernels import rollout as tkr
from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem
from evox_tpu_torch.problems.neuroevolution import flat_mlp_policy
from evox_tpu_torch.problems.neuroevolution.control import envs as tenvs

# One env step is a handful of float32 ops: the two libraries' sin/cos/tanh
# may differ by an ulp or two, nothing more.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# Whole rollouts: those ulps compound over T steps of the dynamics. JAX's
# own engine-vs-engine tolerance (tests/test_kernels.py:248-250) is 2e-4.
ROLLOUT_RTOL, ROLLOUT_ATOL = 2e-4, 2e-4


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _env_batch(name, n, rng):
    if name == "pendulum":
        s = np.stack([rng.uniform(-4, 4, n), rng.uniform(-8, 8, n)], -1)
        a = rng.normal(0, 2, (n, 1))
    else:
        s = rng.uniform(-0.3, 0.3, (n, 4))
        s[:, 0] *= 8  # cart positions on both sides of the 2.4 limit
        a = rng.normal(0, 1, (n, 2))
    return s.astype(np.float32), a.astype(np.float32)


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_env_obs_step_match_jax(name):
    rng = np.random.default_rng(0)
    s, a = _env_batch(name, 256, rng)
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    assert (tenv.obs_dim, tenv.act_dim, tenv.discrete, tenv.max_steps) == (
        jenv.obs_dim, jenv.act_dim, jenv.discrete, jenv.max_steps
    )
    np.testing.assert_allclose(
        tenv.obs(_t(s)).numpy(), np.asarray(jax.vmap(jenv.obs)(s)),
        rtol=STEP_RTOL, atol=STEP_ATOL,
    )
    js, jr, jd = jax.vmap(jenv.step)(s, a)
    ts, tr, td = tenv.step(_t(s), _t(a))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(
        tr.numpy(), np.broadcast_to(np.asarray(jr), (256,)), rtol=STEP_RTOL, atol=STEP_ATOL
    )
    np.testing.assert_array_equal(td.numpy(), np.broadcast_to(np.asarray(jd), (256,)))
    if name == "cartpole":
        assert 0 < td.sum() < 256  # both sides of the termination test


@pytest.mark.parametrize(
    "name,lo,hi",
    [("pendulum", [-np.pi, -1.0], [np.pi, 1.0]), ("cartpole", [-0.05] * 4, [0.05] * 4)],
)
def test_env_reset_ranges_match_jax(name, lo, hi):
    """Draws differ between threefry and torch.Generator; the ranges and
    shapes are the JAX envs'."""
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    js = np.asarray(jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 512)))
    ts = tenv.reset(torch.Generator().manual_seed(0), 512, torch.device("cpu")).numpy()
    assert ts.shape == js.shape and ts.dtype == js.dtype
    for arr in (js, ts):
        assert (arr >= np.asarray(lo, np.float32)).all() and (arr <= np.asarray(hi, np.float32)).all()
    np.testing.assert_allclose(ts.mean(0), js.mean(0), atol=0.2 * (np.asarray(hi) - np.asarray(lo)).max())


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_soa_env_matches_jax(name):
    rng = np.random.default_rng(1)
    s, a = _env_batch(name, 128, rng)
    jsoa, tsoa = getattr(jkr, f"{name}_soa")(), getattr(tkr, f"{name}_soa")()
    jstate, tstate = jsoa.to_soa(jnp.asarray(s)), tsoa.to_soa(_t(s))
    assert sorted(jstate) == sorted(tstate)
    for jo, to in zip(jsoa.obs_soa(jstate), tsoa.obs_soa(tstate)):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=STEP_RTOL, atol=STEP_ATOL)
    acts = tuple(a[:, i] for i in range(a.shape[1]))
    jn, jr, jd = jsoa.step_soa(jstate, tuple(jnp.asarray(x) for x in acts))
    tn, tr, td = tsoa.step_soa(tstate, tuple(_t(x) for x in acts))
    for k in jn:
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]), rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert jsoa.terminating == tsoa.terminating


@pytest.mark.parametrize("obs_dim,hidden,act_dim", [(3, 16, 1), (4, 8, 2)])
def test_flat_mlp_policy_and_mlp_act_match_jax(obs_dim, hidden, act_dim):
    rng = np.random.default_rng(2)
    japply, jdim = jax_flat_mlp_policy(obs_dim, hidden, act_dim)
    tapply, tdim = flat_mlp_policy(obs_dim, hidden, act_dim)
    assert tdim == jdim
    theta = rng.normal(size=(6, tdim)).astype(np.float32)
    obs = rng.normal(size=(6, 2, obs_dim)).astype(np.float32)
    # (pop, ep) batch: the JAX package vmaps a one-genome policy twice
    want = jax.vmap(jax.vmap(japply, in_axes=(None, 0)), in_axes=(0, 0))(theta, obs)
    got = tapply(_t(theta)[:, None], _t(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the kernels' plane form: transposed genomes, one obs plane per input
    flat_obs = obs[:, 0]
    jacts = jkr._mlp_act(jnp.asarray(theta.T), tuple(jnp.asarray(flat_obs[:, k]) for k in range(obs_dim)),
                         obs_dim, hidden, act_dim)
    tacts = tkr._mlp_act(_t(theta.T).contiguous(), tuple(_t(flat_obs[:, k]) for k in range(obs_dim)),
                         obs_dim, hidden, act_dim)
    for ja, ta in zip(jacts, tacts):
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.stack([ta.numpy() for ta in tacts], -1), got[:, 0].numpy(), rtol=1e-5, atol=1e-6
    )


def _pendulum_inputs(n, episodes, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    dim = 3 * hidden + hidden + hidden + 1
    theta = (0.5 * rng.normal(size=(n, dim))).astype(np.float32)
    s0 = {
        "th": rng.uniform(-np.pi, np.pi, episodes * n).astype(np.float32),
        "thdot": rng.uniform(-1, 1, episodes * n).astype(np.float32),
    }
    return theta, s0


def _both_fused(theta, s0, T, obs_dim, hidden, act_dim, jsoa, tsoa, episodes):
    want = jkr.fused_rollout(
        jnp.asarray(theta), {k: jnp.asarray(v) for k, v in s0.items()}, T=T,
        obs_dim=obs_dim, hidden=hidden, act_dim=act_dim, step_soa=jsoa.step_soa,
        obs_soa=jsoa.obs_soa, episodes=episodes, early_stop=jsoa.terminating,
        interpret=True,
    )
    got = tkr.fused_rollout(
        _t(theta), {k: _t(v) for k, v in s0.items()}, T, obs_dim, hidden, act_dim,
        env=tsoa, episodes=episodes, device="cpu",
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n", [5, 1024, 1500])
def test_fused_rollout_cpu_matches_jax_kernel(n):
    """n=5 is padded to a tile on the TPU side, 1500 leaves a ragged tile;
    the port masks nothing and pads nothing."""
    theta, s0 = _pendulum_inputs(n, 1)
    launches = tkr.fused_rollout.launches
    got, want = _both_fused(theta, s0, 12, 3, 16, 1, jkr.pendulum_soa(), tkr.pendulum_soa(), 1)
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    assert tkr.fused_rollout.launches == launches  # the CPU route launches nothing


def test_fused_rollout_episode_major_layout_matches_jax():
    pop, ep = 20, 3
    theta, s0 = _pendulum_inputs(pop, ep, hidden=8, seed=7)
    got, want = _both_fused(theta, s0, 10, 3, 8, 1, jkr.pendulum_soa(), tkr.pendulum_soa(), ep)
    assert got.shape == (ep * pop,)
    np.testing.assert_allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    # env e*pop + i ran genome i: rolling out the repeated genomes one
    # episode at a time gives the same returns
    tsoa = tkr.pendulum_soa()
    for e in range(ep):
        sl = slice(e * pop, (e + 1) * pop)
        one = tkr.fused_rollout_plain(
            _t(theta), {k: _t(v[sl]) for k, v in s0.items()}, 10, 3, 8, 1, tsoa, 1
        )
        np.testing.assert_array_equal(one.numpy(), got[sl])


def test_fused_rollout_cartpole_termination_accounting():
    """Half the envs start on the brink (cart at x=2.39 moving out): the
    sticky done flag must drop every reward after the terminating step, as
    the JAX kernel's frozen-episode accounting does."""
    n, ep, T, hidden = 64, 2, 30, 16
    rng = np.random.default_rng(3)
    dim = 4 * hidden + hidden + hidden * 2 + 2
    theta = (0.5 * rng.normal(size=(n, dim))).astype(np.float32)
    brink = np.arange(ep * n) % 2 == 0
    s0 = {
        "x": np.where(brink, 2.39, rng.uniform(-0.05, 0.05, ep * n)).astype(np.float32),
        "xd": np.where(brink, 1.0, rng.uniform(-0.05, 0.05, ep * n)).astype(np.float32),
        "th": rng.uniform(-0.05, 0.05, ep * n).astype(np.float32),
        "thd": rng.uniform(-0.05, 0.05, ep * n).astype(np.float32),
    }
    got, want = _both_fused(theta, s0, T, 4, hidden, 2, jkr.cartpole_soa(), tkr.cartpole_soa(), ep)
    np.testing.assert_array_equal(got, want)  # returns are step counts
    assert (got[brink] == 1.0).all()  # the terminating step counts, no later one
    assert (got[~brink] > 1.0).all() and got.max() <= T


def _reset_draws(env, key, episodes):
    """The JAX engines' reset draws for stochastic_reset=False."""
    k_eps = jax.random.fold_in(key, 0)
    return np.asarray(jax.vmap(env.reset)(jax.random.split(k_eps, episodes)))


@pytest.mark.parametrize(
    "name,hidden,T,early_exit",
    [("pendulum", 16, 40, False), ("cartpole", 8, 60, True)],
)
@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_policy_rollout_problem_matches_jax(name, hidden, T, early_exit, fused):
    """Both engines of the port against the JAX engine of the same kind,
    with JAX's reset draws substituted for the port's."""
    jsoa, tsoa = getattr(jkr, f"{name}_soa")(T), getattr(tkr, f"{name}_soa")(T)
    japply, dim = jax_flat_mlp_policy(jsoa.base.obs_dim, hidden, jsoa.base.act_dim)
    tapply, _ = flat_mlp_policy(tsoa.base.obs_dim, hidden, tsoa.base.act_dim)
    kw = dict(num_episodes=2, stochastic_reset=False, early_exit=early_exit)
    jprob = JaxProblem(japply, jsoa.base, fused_env=jsoa if fused else None,
                       fused_interpret=True if fused else None, **kw)
    tprob = PolicyRolloutProblem(tapply, tsoa.base, fused_env=tsoa if fused else None,
                                 device="cpu", **kw)
    key = jax.random.PRNGKey(5)
    resets = _reset_draws(jsoa.base, key, 2)
    tprob._episode_states = lambda seed, env: _t(resets)
    pop = (0.6 * np.random.default_rng(4).normal(size=(12, dim))).astype(np.float32)
    want, _ = jprob.evaluate(jprob.init(key), jnp.asarray(pop))
    got, tstate = tprob.evaluate(tprob.init(0), _t(pop))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    assert tstate.seed == 0  # a fixed evaluation seed is not advanced
    if name == "cartpole":
        assert float(np.min(np.asarray(want))) < T  # episodes genuinely end


def test_fused_engine_matches_scan_engine_with_stochastic_resets():
    """The port's own engines draw the same resets from the same seeds, and
    thread the seed the same way, over two generations."""
    soa = tkr.pendulum_soa(30)
    apply, dim = flat_mlp_policy(3, 16, 1)
    kw = dict(num_episodes=2, stochastic_reset=True, early_exit=False, device="cpu")
    scan = PolicyRolloutProblem(apply, soa.base, **kw)
    fused = PolicyRolloutProblem(apply, soa.base, fused_env=soa, **kw)
    pop = 0.3 * torch.randn(9, dim, generator=torch.Generator().manual_seed(1))
    s_scan, s_fused = scan.init(5), fused.init(5)
    for _ in range(2):
        f_scan, s_scan = scan.evaluate(s_scan, pop)
        f_fused, s_fused = fused.evaluate(s_fused, pop)
        np.testing.assert_allclose(f_fused.numpy(), f_scan.numpy(), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
        assert s_fused.seed == s_scan.seed != 5


def test_fused_engine_refuses_a_foreign_policy_and_genome():
    soa = tkr.pendulum_soa()
    apply, dim = flat_mlp_policy(3, 16, 1)
    prob = PolicyRolloutProblem(apply, soa.base, fused_env=soa, device="cpu")
    with pytest.raises(ValueError, match="flat_mlp_policy"):
        prob.evaluate(prob.init(0), torch.zeros(4, dim + 1))
    wrong = PolicyRolloutProblem(lambda th, o: torch.zeros(1), soa.base, fused_env=soa, device="cpu")
    with pytest.raises(ValueError, match="flat tanh MLP"):
        wrong.evaluate(wrong.init(0), torch.zeros(4, dim))
    with pytest.raises(ValueError, match="disagrees with env"):
        PolicyRolloutProblem(apply, tenvs.cartpole(), fused_env=soa, device="cpu")


def test_fused_rollout_refuses_bad_inputs():
    theta, s0 = _pendulum_inputs(4, 1)
    s0 = {k: _t(v) for k, v in s0.items()}
    with pytest.raises(ValueError, match="flat MLP size"):
        tkr.fused_rollout(_t(theta)[:, :-1], s0, 3, device="cpu")
    with pytest.raises(ValueError, match="episode-major"):
        tkr.fused_rollout(_t(theta), s0, 3, episodes=2, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tkr.fused_rollout(_t(theta).double(), s0, 3, device="cpu")


@pytest.mark.parametrize(
    "env_name,n,episodes,grid,waves",
    [("pendulum", 65536, 2, (512, 2), 1024 / 528), ("pendulum", 1500, 3, (12, 3), 36 / 528),
     ("cartpole", 8192, 2, (64, 2), 128 / 396)],
)
def test_rollout_launch_plan(env_name, n, episodes, grid, waves):
    """One thread per env, (ceil(n / 128), episodes) blocks; the pendulum
    instance is built for four blocks an SM, cartpole's for three (its
    genome takes more registers)."""
    plan = tkr.launch_plan(env_name, n, episodes)
    assert plan["threads"] == 128 and plan["grid"] == grid
    assert plan["waves"] == pytest.approx(waves)


@pytest.mark.parametrize("n,episodes", [(1, 1), (129, 2), (40000, 3), (700, 5)])
def test_rollout_launch_plan_covers_every_env_once(n, episodes):
    """Thread t of block (bx, by) runs genome bx * 128 + t in episode by
    (csrc/rollout.cu): every (genome, episode) once."""
    plan = tkr.launch_plan("pendulum", n, episodes)
    gx, gy = plan["grid"]
    genome = (torch.arange(gx)[:, None] * plan["threads"] + torch.arange(plan["threads"])).reshape(-1)
    g, e = torch.meshgrid(genome, torch.arange(gy), indexing="ij")
    keep = g < n
    env = (e[keep] * n + g[keep]).sort().values
    assert torch.equal(env, torch.arange(n * episodes))


def test_rollout_launch_plan_refuses_an_env_without_a_kernel():
    """Every env of the JAX kernel has instances at hidden 8 and 16; an env
    without a counterpart and another hidden width are refused."""
    with pytest.raises(ValueError, match="no CUDA counterpart"):
        tkr.launch_plan("lunar_lander", 10, 1)
    with pytest.raises(ValueError, match="hidden widths"):
        tkr.launch_plan("acrobot", 10, 1, hidden=32)
    assert tkr.launch_plan("acrobot", 10, 1)["blocks_per_sm"] == 2
    assert set(tkr.REPLACED_LIBDEVICE) == {"sincosf", "tanhf"}
