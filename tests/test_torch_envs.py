"""Mountain car and acrobot in the port against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``evox_tpu_torch``: the batched envs (``obs``/``step``
against JAX's, vmapped), their SoA forms, ``fused_rollout``'s plain route
(``device="cpu"``) against the JAX kernel in Pallas interpret mode, and the
port's fused engine against its scan engine. The CUDA instances themselves
are held against the plain version on the card by ``chip_smoke.py``.

Tolerances, and why: one env step is a few float32 operations and, for
acrobot, six sin/cos; XLA's and PyTorch's CPU trig may differ by an ulp,
and XLA may contract a multiply and an add, so one step agrees to ~1e-6
relative (STEP). Acrobot divides by ``1.25 - d2**2 / d1``, which magnifies
an ulp by up to ~10x (STEP_ACROBOT). Whole rollouts compound those ulps;
JAX's own engine-against-engine tolerance is 2e-4 (tests/test_kernels.py:
248-250). Returns that count steps (acrobot's -1 a step, mountain car's
+100 at the goal) agree exactly unless a done flag flips on an ulp, which
the near-done inputs below do not do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.kernels import rollout as jkr
from evox_tpu.problems.neuroevolution.control import envs as jenvs
from evox_tpu.utils.common import compose as jax_compose
from evox_tpu.utils.common import min_by as jax_min_by
from evox_tpu_torch.kernels import rollout as tkr
from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, flat_mlp_policy
from evox_tpu_torch.problems.neuroevolution import control as tcontrol
from evox_tpu_torch.problems.neuroevolution.control import envs as tenvs
from evox_tpu_torch.utils import compose, min_by

STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
STEP_ACROBOT_RTOL, STEP_ACROBOT_ATOL = 1e-5, 1e-5
ROLLOUT_RTOL, ROLLOUT_ATOL = 2e-4, 2e-4
NEW_ENVS = ("mountain_car", "acrobot")


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _states(name, n, rng):
    """Random states across each env's range, a few on the brink of done."""
    if name == "mountain_car":
        s = np.stack([rng.uniform(-1.2, 0.6, n), rng.uniform(-0.07, 0.07, n)], -1)
        s[:8] = [[-1.19, -0.07]] * 4 + [[0.44, 0.07]] * 4  # the wall, the goal
    else:
        s = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n),
                      rng.uniform(-12, 12, n), rng.uniform(-28, 28, n)], -1)
        s[:8, :2] = [[2.8, 0.1]] * 8  # the tip near the bar
    return s.astype(np.float32)


def _actions(name, n, rng):
    act = 1 if name == "mountain_car" else 3
    a = rng.normal(0, 2, (n, act)).astype(np.float32)
    if name == "acrobot":
        a[:6, 1] = a[:6, 0]  # ties: the first of equal maxima wins
        a[6:12, 2] = a[6:12, 1]
    return a


@pytest.mark.parametrize("name", NEW_ENVS)
def test_env_obs_step_match_jax_over_40_steps(name):
    """One step at a time along JAX's trajectory of 256 envs, with fresh
    random actions each step: obs, next state, reward and done."""
    rng = np.random.default_rng(0)
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    assert (tenv.obs_dim, tenv.act_dim, tenv.discrete, tenv.max_steps) == (
        jenv.obs_dim, jenv.act_dim, jenv.discrete, jenv.max_steps)
    rtol, atol = ((STEP_ACROBOT_RTOL, STEP_ACROBOT_ATOL) if name == "acrobot"
                  else (STEP_RTOL, STEP_ATOL))
    s = _states(name, 256, rng)
    dones = 0
    for _ in range(40):
        a = _actions(name, 256, rng)
        np.testing.assert_allclose(tenv.obs(_t(s)).numpy(), np.asarray(jax.vmap(jenv.obs)(s)),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        js, jr, jd = jax.vmap(jenv.step)(s, a)
        ts, tr, td = tenv.step(_t(s), _t(a))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol, atol=atol)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=rtol, atol=atol)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        dones += int(td.sum())
        s = np.asarray(js)
    assert dones > 0  # the done test is exercised


@pytest.mark.parametrize(
    "name,lo,hi",
    [("mountain_car", [-0.6, 0.0], [-0.4, 0.0]), ("acrobot", [-0.1] * 4, [0.1] * 4)],
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


def test_make_and_envs_registry_match_jax():
    assert set(tenvs.ENVS) == set(jenvs.ENVS)  # chain_walker registered by both packages
    for name in ("cartpole", "pendulum", "mountain_car", "acrobot"):
        spec = tenvs.make(name, max_steps=7)
        assert spec.max_steps == 7 and spec.obs_dim == jenvs.make(name).obs_dim
    assert tcontrol.make("chain_walker").obs_dim == 244
    with pytest.raises(ValueError, match="unknown env"):
        tenvs.make("lunar_lander")


@pytest.mark.parametrize("name", NEW_ENVS)
def test_soa_env_matches_jax_and_the_batched_env(name):
    """The SoA form against JAX's SoA form, and against the port's own
    batched env bit for bit (the same operations in the same order)."""
    rng = np.random.default_rng(1)
    s, a = _states(name, 128, rng), _actions(name, 128, rng)
    jsoa, tsoa = getattr(jkr, f"{name}_soa")(), getattr(tkr, f"{name}_soa")()
    assert jsoa.terminating and tsoa.terminating and tsoa.cuda_env == name
    jstate, tstate = jsoa.to_soa(jnp.asarray(s)), tsoa.to_soa(_t(s))
    assert sorted(jstate) == sorted(tstate)
    for jo, to in zip(jsoa.obs_soa(jstate), tsoa.obs_soa(tstate)):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=STEP_RTOL, atol=STEP_ATOL)
    acts = tuple(a[:, i] for i in range(a.shape[1]))
    jn, jr, jd = jsoa.step_soa(jstate, tuple(jnp.asarray(x) for x in acts))
    tn, tr, td = tsoa.step_soa(tstate, tuple(_t(x) for x in acts))
    for k in jn:
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]), rtol=STEP_ACROBOT_RTOL,
                                   atol=STEP_ACROBOT_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert 0 < td.sum() < 128
    bs, br, bd = tsoa.base.step(_t(s), _t(a))
    np.testing.assert_array_equal(torch.stack(list(tn.values()), -1).numpy(), bs.numpy())
    np.testing.assert_array_equal(tr.numpy(), br.numpy())
    np.testing.assert_array_equal(td.numpy(), bd.numpy())
    if name == "mountain_car":  # the wall's arithmetic select keeps -0.0
        assert (np.signbit(tn["vel"].numpy()) & (tn["vel"].numpy() == 0)).any()


def _near_done(name, n):
    """tests/test_kernels.py:296-317: half the envs on the brink of done."""
    half = np.arange(n) % 2 == 0
    if name == "mountain_car":
        return {"pos": np.where(half, 0.44, -0.5), "vel": np.full(n, 0.07)}
    return {"t1": np.where(half, 2.8, 0.05), "t2": np.full(n, 0.1), "td1": np.full(n, 0.5),
            "td2": np.zeros(n)}


@pytest.mark.parametrize("name", NEW_ENVS)
def test_fused_rollout_plain_matches_jax_kernel_near_done(name):
    """fused_rollout's CPU route against the JAX kernel in interpret mode at
    hidden 8 (2 episodes, n 64, T 12), half the envs starting on the brink:
    the sticky done mask drops every reward after the terminating step."""
    jsoa, tsoa = getattr(jkr, f"{name}_soa")(30), getattr(tkr, f"{name}_soa")(30)
    obs, act, hidden, n, ep, T = tsoa.base.obs_dim, tsoa.base.act_dim, 8, 64, 2, 12
    dim = obs * hidden + hidden + hidden * act + act
    theta = (0.5 * np.random.default_rng(5).normal(size=(n, dim))).astype(np.float32)
    s0 = {k: np.asarray(v, np.float32) for k, v in _near_done(name, ep * n).items()}
    want = jkr.fused_rollout(
        jnp.asarray(theta), {k: jnp.asarray(v) for k, v in s0.items()}, T=T, obs_dim=obs,
        hidden=hidden, act_dim=act, step_soa=jsoa.step_soa, obs_soa=jsoa.obs_soa,
        episodes=ep, early_stop=True, interpret=True)
    launches = tkr.fused_rollout.launches
    got = tkr.fused_rollout(_t(theta), {k: _t(v) for k, v in s0.items()}, T, obs, hidden, act,
                            env=tsoa, episodes=ep, device="cpu")
    assert tkr.fused_rollout.launches == launches  # the CPU route launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    # the mask fired: without it the brink half would collect every step
    state, unmasked = {k: _t(v) for k, v in s0.items()}, torch.zeros(ep * n)
    theta_t = _t(theta).t().repeat(1, ep)
    for _ in range(T):
        a = tkr._mlp_act(theta_t, tsoa.obs_soa(state), obs, hidden, act)
        state, r, _ = tsoa.step_soa(state, a)
        unmasked = unmasked + r
    brink = torch.as_tensor(np.arange(ep * n) % 2 == 0)
    assert (got[brink] != unmasked[brink]).all()
    if name == "acrobot":  # -1 a step until done, then 0
        assert (got[brink] > -T).all() and (got[~brink] == -T).all()


@pytest.mark.parametrize("name", ["cartpole", "mountain_car", "acrobot"])
def test_fused_engine_matches_scan_engine_terminating(name):
    """The port's twin of tests/test_kernels.py's
    test_fused_engine_matches_scan_engine_terminating: hidden 8, T 40, two
    episodes, pop 12; the fused engine's sticky done mask against the scan
    engine's frozen episodes."""
    soa = getattr(tkr, f"{name}_soa")(40)
    apply, dim = flat_mlp_policy(soa.base.obs_dim, 8, soa.base.act_dim)
    kw = dict(num_episodes=2, stochastic_reset=False, device="cpu")
    scan = PolicyRolloutProblem(apply, soa.base, early_exit=True, **kw)
    fused = PolicyRolloutProblem(apply, soa.base, fused_env=soa, **kw)
    pop = 0.6 * torch.randn(12, dim, generator=torch.Generator().manual_seed(2))
    f_scan, s_scan = scan.evaluate(scan.init(6), pop)
    f_fused, s_fused = fused.evaluate(fused.init(6), pop)
    np.testing.assert_allclose(f_fused.numpy(), f_scan.numpy(), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    assert s_scan == s_fused
    if name == "cartpole":
        assert float(f_scan.min()) < 40.0  # episodes genuinely end


@pytest.mark.parametrize(
    "env_name,hidden,n,episodes,grid,per_sm",
    [("mountain_car", 16, 65536, 2, (512, 2), 4), ("acrobot", 16, 65536, 2, (512, 2), 2),
     ("acrobot", 8, 1500, 3, (12, 3), 4), ("cartpole", 8, 1500, 1, (12, 1), 4),
     ("pendulum", 8, 200, 2, (2, 2), 4), ("mountain_car", 8, 1500, 2, (12, 2), 4)],
)
def test_launch_plan_of_the_new_instances(env_name, hidden, n, episodes, grid, per_sm):
    """Every env has an instance at hidden 8 and 16; acrobot's 163-float
    genome at hidden 16 is built for two blocks an SM (255 registers)."""
    plan = tkr.launch_plan(env_name, n, episodes, hidden=hidden)
    assert plan["grid"] == grid and plan["blocks_per_sm"] == per_sm
    assert plan["waves"] == pytest.approx(grid[0] * grid[1] / (per_sm * 132))
    assert set(tkr.BLOCKS_PER_SM) == {(e, h) for e in tkr._CUDA_ENVS for h in tkr.HIDDEN_WIDTHS}


def test_new_entry_points_refuse_a_missing_cuda(monkeypatch):
    """device=None means cuda: without a card the new entry points raise, and
    with device="cpu" each runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tenvs.mountain_car, tenvs.acrobot):
        env = make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            env.reset(torch.Generator().manual_seed(0), 3, None)
        assert env.reset(torch.Generator().manual_seed(0), 3, torch.device("cpu")).shape[0] == 3
    soa = tkr.acrobot_soa(5)
    theta = torch.zeros(2, 6 * 8 + 8 + 8 * 3 + 3)
    s0 = soa.to_soa(torch.zeros(2, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkr.fused_rollout(theta, s0, 5, 6, 8, 3, env=soa)
    assert tkr.fused_rollout(theta, s0, 5, 6, 8, 3, env=soa, device="cpu").shape == (2,)
    apply, _ = flat_mlp_policy(6, 8, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyRolloutProblem(apply, soa.base)


def test_compose_and_min_by_match_jax():
    f = lambda x: x * 2.0
    g = lambda x: x + 3.0
    x = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(compose(f, g)(_t(x)).numpy(),
                                  np.asarray(jax_compose(f, g)(jnp.asarray(x))))
    assert compose()(5) == 5
    rng = np.random.default_rng(3)
    vals = [rng.normal(size=(3, 2)).astype(np.float32), rng.normal(size=(1, 2)).astype(np.float32)]
    keys = [np.array([0.5, -1.0, 2.0], np.float32), np.array([-1.0], np.float32)]
    jv, jk = jax_min_by([jnp.asarray(v) for v in vals], [jnp.asarray(k) for k in keys])
    tv, tk = min_by([_t(v) for v in vals], [_t(k) for k in keys])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))  # the first of the tie wins
    assert float(tk) == float(jk) == -1.0
    # 0-d values and keys count as batches of one
    jv, jk = jax_min_by([jnp.float32(4.0), jnp.float32(7.0)], [jnp.float32(2.0), jnp.float32(1.0)])
    tv, tk = min_by([torch.tensor(4.0), torch.tensor(7.0)], [torch.tensor(2.0), torch.tensor(1.0)])
    assert float(tv) == float(jv) == 7.0 and float(tk) == float(jk) == 1.0
