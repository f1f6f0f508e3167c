"""CapEpisode, ObsNormalizer, the scan engine with both, and visualize, in the
port against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``evox_tpu_torch`` (``device="cpu"``). Whole evaluations start
from one state, JAX's, carried into the port by ``interop.rollout_state``,
with JAX's episode resets handed to the port.

Tolerances, and why: the helpers are a few float32 operations each (1e-6
relative; XLA may contract a multiply and an add). The engine sums the
moments of every live step over (pop, episodes) and steps, in XLA's order
on one side and PyTorch's on the other: the sums agree to ~1e-6 relative,
and ``m2 = s2 - n mean^2`` loses a few digits to cancellation (1e-4
relative). Normalised observations differ by an ulp, so returns get the
rollout tolerance of tests/test_torch_rollout.py (2e-4); the inputs are
chosen so that no termination flips on an ulp (cartpole's returns count
steps and agree exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.problems.neuroevolution import CapEpisode as JaxCapEpisode
from evox_tpu.problems.neuroevolution import ObsNormalizer as JaxObsNormalizer
from evox_tpu.problems.neuroevolution import PolicyRolloutProblem as JaxProblem
from evox_tpu.problems.neuroevolution import flat_mlp_policy as jax_flat_mlp_policy
from evox_tpu.problems.neuroevolution.control import envs as jenvs
from evox_tpu_torch import interop
from evox_tpu_torch.kernels import rollout as tkr
from evox_tpu_torch.kernels import rollout_mlp as tkm
from evox_tpu_torch.problems.neuroevolution import (
    CapEpisode,
    ObsNormalizer,
    PolicyRolloutProblem,
    Trajectory,
    flat_mlp_policy,
)
from evox_tpu_torch.problems.neuroevolution.control import envs as tenvs

OP_RTOL, OP_ATOL = 1e-6, 1e-7
SUM_RTOL = 1e-5
M2_RTOL = 1e-4
ROLLOUT_RTOL, ROLLOUT_ATOL = 2e-4, 2e-4


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_cap_episode_matches_jax():
    jcap, tcap = JaxCapEpisode(37), CapEpisode(37)
    assert int(tcap.init("cpu")) == int(jcap.init()) == 37
    assert tcap.init("cpu").dtype == torch.int32
    rng = np.random.default_rng(0)
    for lengths in (rng.integers(0, 500, (64, 3)), np.zeros((5, 2)), np.full((4, 1), 7),
                    rng.integers(1, 3, (9, 2))):
        lengths = lengths.astype(np.int32)
        want = jcap.update(jcap.init(), jnp.asarray(lengths))
        got = tcap.update(tcap.init("cpu"), torch.as_tensor(lengths))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want)  # exact: integer lengths sum exactly in float32
        assert int(tcap.get(got)) == int(jcap.get(want))


def _moments_close(got, want):
    count, mean, m2 = (x.numpy() for x in got)
    jcount, jmean, jm2 = (np.asarray(x) for x in want)
    np.testing.assert_allclose(count, jcount, rtol=SUM_RTOL)
    np.testing.assert_allclose(mean, jmean, rtol=SUM_RTOL, atol=SUM_RTOL * np.abs(jmean).max())
    np.testing.assert_allclose(m2, jm2, rtol=M2_RTOL, atol=M2_RTOL * np.abs(jm2).max())


def test_obs_normalizer_matches_jax():
    d = 5
    jn, tn = JaxObsNormalizer(d, clip=3.0), ObsNormalizer(d, clip=3.0)
    jstate, tstate = jn.init(), tn.init("cpu")
    for j, t in zip(jstate, tstate):
        assert t.shape == np.asarray(j).shape and t.dtype == torch.float32
    rng = np.random.default_rng(1)
    obs = (rng.normal(size=(7, 3, d)) * [1, 10, 0.1, 100, 1] + [0, 5, -1, 50, 0]).astype(np.float32)
    # count 0 and 1: var is 1 and obs pass unchanged up to the clip
    np.testing.assert_allclose(tn.normalize(tstate, _t(obs)).numpy(),
                               np.asarray(jn.normalize(jstate, jnp.asarray(obs))),
                               rtol=OP_RTOL, atol=OP_ATOL)
    jstate, tstate = jn.update(jstate, jnp.asarray(obs)), tn.update(tstate, _t(obs))
    _moments_close(tstate, jstate)
    more = (rng.normal(size=(40, d)) * 3 + 1).astype(np.float32)
    jstate, tstate = jn.update(jstate, jnp.asarray(more)), tn.update(tstate, _t(more))
    _moments_close(tstate, jstate)
    # merge of raw moments: a count of 0 leaves the state as it was
    cnt, s1, s2 = np.float32(0), np.zeros(d, np.float32), np.zeros(d, np.float32)
    same = tn.merge_moments(tstate, torch.tensor(cnt), _t(s1), _t(s2))
    for a, b in zip(same, tstate):
        assert torch.equal(a, b)
    cnt, s1 = np.float32(12), (rng.normal(size=d) * 12).astype(np.float32)
    s2 = (s1 * s1 / 12 + np.abs(rng.normal(size=d)) * 12).astype(np.float32)
    want = jn.merge_moments(jstate, jnp.asarray(cnt), jnp.asarray(s1), jnp.asarray(s2))
    got = tn.merge_moments(tstate, torch.tensor(cnt), _t(s1), _t(s2))
    _moments_close(got, want)
    wide = (rng.normal(size=(11, d)) * 200).astype(np.float32)  # past the clip
    np.testing.assert_allclose(tn.normalize(got, _t(wide)).numpy(),
                               np.asarray(jn.normalize(want, jnp.asarray(wide))),
                               rtol=1e-5, atol=1e-5)
    assert float(tn.normalize(got, _t(wide)).abs().max()) == 3.0


def _reset_draws(env, key, episodes):
    """The JAX engines' reset draws for stochastic_reset=False."""
    k_eps = jax.random.fold_in(key, 0)
    return np.asarray(jax.vmap(env.reset)(jax.random.split(k_eps, episodes)))


@pytest.mark.parametrize(
    "name,cap,early_exit,T",
    [("cartpole", 25, True, 60), ("pendulum", None, False, 30), ("acrobot", 40, True, 60)],
)
def test_scan_engine_with_cap_and_normalizer_matches_jax(name, cap, early_exit, T):
    """Two evaluations, each from JAX's state carried across by
    interop.rollout_state (the first from a fresh state, whose count of 0
    leaves observations unnormalised; the second from the stats the first
    gathered): fitness, the new cap and the (count, mean, m2) moments."""
    jenv, tenv = getattr(jenvs, name)(T), getattr(tenvs, name)(T)
    japply, dim = jax_flat_mlp_policy(jenv.obs_dim, 8, jenv.act_dim)
    tapply, _ = flat_mlp_policy(tenv.obs_dim, 8, tenv.act_dim)
    kw = dict(num_episodes=2, stochastic_reset=False, early_exit=early_exit)
    jprob = JaxProblem(japply, jenv, cap_episode=JaxCapEpisode(cap) if cap else None,
                       obs_normalizer=JaxObsNormalizer(jenv.obs_dim), **kw)
    tprob = PolicyRolloutProblem(tapply, tenv, cap_episode=CapEpisode(cap) if cap else None,
                                 obs_normalizer=ObsNormalizer(tenv.obs_dim), device="cpu", **kw)
    key = jax.random.PRNGKey(3)
    resets = _reset_draws(jenv, key, 2)
    tprob._episode_states = lambda seed, env: _t(resets)
    pop = (0.6 * np.random.default_rng(4).normal(size=(12, dim))).astype(np.float32)
    jstate, counts = jprob.init(key), []
    for _ in range(2):
        tstate = interop.rollout_state(tprob, _np(jstate), seed=0)
        want, jstate = jprob.evaluate(jstate, jnp.asarray(pop))
        got, tstate = tprob.evaluate(tstate, _t(pop))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL,
                                   atol=ROLLOUT_ATOL)
        _moments_close(tstate.norm, jstate.norm)
        if cap:
            assert tstate.cap.dtype == torch.int32 and int(tstate.cap) == int(jstate.cap)
        else:
            assert tstate.cap is None and jstate.cap is None
        counts.append(float(tstate.norm[0]))
    assert 0 < counts[0] < counts[1]
    if cap:  # the cap bound the first rollout: at most cap live steps an episode
        assert counts[0] <= 12 * 2 * cap < 12 * 2 * T


def test_cap_bounds_the_scan_engine_and_counts_live_steps():
    """A cap of 5 stops every episode at 5 steps; the next cap is twice the
    mean live steps; the normaliser counts only live steps."""
    env = tenvs.cartpole(200)
    apply, dim = flat_mlp_policy(4, 8, 2)
    prob = PolicyRolloutProblem(apply, env, cap_episode=CapEpisode(5), obs_normalizer=ObsNormalizer(4),
                                num_episodes=3, reduce_fn=torch.sum, device="cpu")
    pop = torch.zeros(6, dim)  # a constant policy: the pole falls after ~10 steps
    fit, state = prob.evaluate(prob.init(1), pop)  # fitness: the live steps of 3 episodes
    assert (fit == 15).all() and int(state.cap) == 10 and float(state.norm[0]) == 6 * 3 * 5
    fit, state = prob.evaluate(state, pop)
    assert (fit < 30).all()  # every episode ended before the cap of 10
    live = float(state.norm[0]) - 90  # the live steps of the second rollout, summed
    assert live == float(fit.sum())
    assert int(state.cap) == int(np.float32(2) * (np.float32(live) / np.float32(18)))


def test_visualize_matches_jax():
    """One policy's whole trace, frozen after done, with the observations
    normalised by a carried state (cartpole, T 40: the pole falls inside)."""
    T = 40
    jenv, tenv = jenvs.cartpole(T), tenvs.cartpole(T)
    japply, dim = jax_flat_mlp_policy(4, 8, 2)
    tapply, _ = flat_mlp_policy(4, 8, 2)
    jprob = JaxProblem(japply, jenv, obs_normalizer=JaxObsNormalizer(4))
    key = jax.random.PRNGKey(7)
    s0 = np.asarray(jenv.reset(key))
    tenv = tenv._replace(reset=lambda g, n, device: _t(s0)[None].expand(n, -1))
    tprob = PolicyRolloutProblem(tapply, tenv, obs_normalizer=ObsNormalizer(4), device="cpu")
    params = (0.5 * np.random.default_rng(8).normal(size=dim)).astype(np.float32)
    norm = JaxObsNormalizer(4).update(JaxObsNormalizer(4).init(),
                                      jnp.asarray(np.random.default_rng(9).normal(size=(50, 4)) * 0.1))
    jstate = jprob.init(key)._replace(norm=norm)
    tstate = interop.rollout_state(tprob, _np(jstate))
    want = jprob.visualize(jnp.asarray(params), key, jstate)
    got = tprob.visualize(_t(params), seed=0, state=tstate)
    assert isinstance(got, Trajectory)
    for field in ("states", "obs", "actions", "rewards"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL, err_msg=field)
    np.testing.assert_array_equal(got.dones.numpy(), np.asarray(want.dones))
    assert got.length.dtype == torch.int32 and int(got.length) == int(want.length)
    assert 0 < int(got.length) < T  # the episode ended, and the rest is frozen
    assert (got.rewards[int(got.length):] == 0).all()
    assert (got.states[int(got.length):] == got.states[-1]).all()
    # without a state the raw observations reach the policy, as in JAX
    raw, want_raw = tprob.visualize(_t(params), seed=0), jprob.visualize(jnp.asarray(params), key)
    np.testing.assert_allclose(raw.actions.numpy(), np.asarray(want_raw.actions),
                               rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    assert not torch.allclose(raw.actions[0], got.actions[0])


def test_rollout_state_refusals_and_interop():
    env = tenvs.cartpole(20)
    apply, dim = flat_mlp_policy(4, 8, 2)
    with pytest.raises(ValueError, match="early_exit=False"):
        PolicyRolloutProblem(apply, env, cap_episode=CapEpisode(), early_exit=False, device="cpu")
    soa = tkr.cartpole_soa(20)
    for kw in (dict(cap_episode=CapEpisode()), dict(obs_normalizer=ObsNormalizer(4))):
        with pytest.raises(ValueError, match="cannot be combined"):
            PolicyRolloutProblem(apply, soa.base, fused_env=soa, device="cpu", **kw)
    penv = tkm.chain_walker_planes(max_steps=5)
    with pytest.raises(ValueError, match="cannot be combined"):
        PolicyRolloutProblem(apply, penv.base, fused_planes=penv, obs_normalizer=ObsNormalizer(244),
                             device="cpu")
    plain = PolicyRolloutProblem(apply, env, device="cpu")
    state = interop.rollout_state(plain, _np(JaxProblem(apply, jenvs.cartpole(20)).init()), seed=4)
    assert state.seed == 4 and state.cap is None and state.norm is None
    prob = PolicyRolloutProblem(apply, env, cap_episode=CapEpisode(9), obs_normalizer=ObsNormalizer(4),
                                device="cpu")
    jprob = JaxProblem(apply, jenvs.cartpole(20), cap_episode=JaxCapEpisode(9),
                       obs_normalizer=JaxObsNormalizer(4))
    state = interop.rollout_state(prob, _np(jprob.init()))
    assert int(state.cap) == 9 and state.norm[1].shape == (4,)
    with pytest.raises(ValueError, match="norm mean"):
        interop.rollout_state(prob, _np(jprob.init()._replace(
            norm=(jnp.zeros(()), jnp.zeros(3), jnp.zeros(4)))))
