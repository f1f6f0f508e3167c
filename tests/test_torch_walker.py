"""The port's walker slice against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``evox_tpu_torch`` (``device="cpu"``, which takes the plain
PyTorch route of ``fused_mlp_rollout``): the chain walker in both forms,
``_mlp_planes``, the plain rollout against the JAX kernel in Pallas
interpret mode, ``TreeAndVector``, ``mlp_policy``, the big-policy engine,
and OpenES generations of the slice as a whole. The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.

Tolerances, and why: the two packages do the same float32 operations, but
XLA sums ``jnp.mean``/``jnp.sum`` in its own order and may contract a
multiply and an add into one FMA, where the port's plain version adds in
a fixed order with every operation rounded. One observation or one reward
therefore differs by an ulp or two (measured 2.4e-7); the stiff rod
springs (stiffness 2000) grow state differences over steps (measured
3.2e-5 absolute after 5 steps on positions of ~5). JAX's own tests allow
2e-5 on observations and 2e-4 on rewards (tests/test_kernels_mlp.py:103-136).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.kernels import rollout_mlp as jkm
from evox_tpu.problems.neuroevolution import PolicyRolloutProblem as JaxProblem
from evox_tpu.problems.neuroevolution import mlp_policy as jax_mlp_policy
from evox_tpu.problems.neuroevolution.control import chain_walker as jax_chain_walker
from evox_tpu.utils import TreeAndVector as JaxTreeAndVector
from evox_tpu.utils.common import rank_based_fitness as jax_rank_based_fitness
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.kernels import rollout_mlp as tkm
from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, mlp_policy
from evox_tpu_torch.problems.neuroevolution.control import chain_walker
from evox_tpu_torch.utils import TreeAndVector, rank_based_fitness

OBS_RTOL = OBS_ATOL = 2e-5  # one observation: an ulp or two (JAX's test: 2e-5)
REWARD_RTOL = REWARD_ATOL = 2e-4  # rewards over 5 stiff steps (JAX's test: 2e-4)
STATE_RTOL, STATE_ATOL = 1e-5, 1e-4  # positions and velocities after 5 steps (measured 3.2e-5)
# whole rollouts of the plain version against the JAX kernel: T steps of the
# stiff dynamics through a 244-input MLP (measured 4.8e-7 on returns of ~6)
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-5, 1e-5
ENGINE_TOL = 2e-3  # fused engine vs scan engine, JAX's own (test_kernels_mlp.py:158-160)
SIZES = (244, 16, 8, 17)  # small hiddens: CI speed, the code paths of 244-64-64-17
SMALL = dict(n_masses=7, act_dim=4, obs_dim=64)  # obs truncated: 67 rows -> 64


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _flat(state) -> np.ndarray:
    """A JAX walker state (pos, vel, prev_a, t) batch as the port's flat
    state batch (module docstring of control/walker.py)."""
    pos, vel, pa, t = (np.asarray(x) for x in state)
    n = pos.shape[0]
    return np.concatenate(
        [pos.reshape(n, -1), vel.reshape(n, -1), pa, t[:, None].astype(np.float32)], -1
    ).astype(np.float32)


def _states(cfg, n, seed):
    """n JAX resets, then a few envs pushed to the ends of the episode: one
    fallen (head below the standing height), one exploded (NaN), one moved
    whole beyond the 1e3 bound."""
    env = jax_chain_walker(max_steps=50, **cfg)
    pos, vel, pa, t = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(seed), n))
    pos = np.array(pos)
    pos[1, :, 1] *= 0.3
    pos[2, 3, 0] = np.nan
    pos[3, :, 0] += 2e3
    return env, (jnp.asarray(pos), vel, pa, t)


def _actions(n, act_dim, seed):
    return np.random.default_rng(seed).normal(0, 1.0, (n, act_dim)).astype(np.float32)


@pytest.mark.parametrize("cfg", [{}, SMALL], ids=["humanoid", "small"])
def test_chain_walker_matches_jax(cfg):
    jenv, jstate = _states(cfg, 16, 3)
    tenv = chain_walker(max_steps=50, **cfg)
    assert (tenv.obs_dim, tenv.act_dim, tenv.discrete, tenv.max_steps) == (
        jenv.obs_dim, jenv.act_dim, jenv.discrete, jenv.max_steps)
    tstate = _t(_flat(jstate))
    np.testing.assert_allclose(tenv.obs(tstate).numpy(), np.asarray(jax.vmap(jenv.obs)(jstate)),
                               rtol=OBS_RTOL, atol=OBS_ATOL)
    act = _actions(16, jenv.act_dim, 0)
    live = np.ones(16, bool)  # after an env's done its state no longer counts
    jstep = jax.jit(jax.vmap(jenv.step))  # one compile: eager op-by-op dominated the time
    for step in range(5):
        jstate, jr, jd = jstep(jstate, jnp.asarray(act))
        tstate, tr, td = tenv.step(tstate, _t(act))
        np.testing.assert_allclose(tr.numpy()[live], np.asarray(jr)[live],
                                   rtol=REWARD_RTOL, atol=REWARD_ATOL)
        np.testing.assert_array_equal(td.numpy()[live], np.asarray(jd)[live])
        np.testing.assert_allclose(tstate.numpy()[live], _flat(jstate)[live],
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
        if step == 0:  # fell, exploded, beyond the bound: done at once
            assert td[1:4].all() and not td[4:].any()
        live &= ~np.asarray(jd)


def test_chain_walker_reset_matches_jax():
    """Draws differ between threefry and torch.Generator; the state layout,
    the standing zig-zag and the noise scale are the JAX walker's."""
    jenv = jax_chain_walker()
    js = _flat(jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 512)))
    ts = chain_walker().reset(torch.Generator().manual_seed(0), 512, torch.device("cpu")).numpy()
    assert ts.shape == js.shape == (512, 4 * 25 + 17 + 1) and ts.dtype == js.dtype
    np.testing.assert_allclose(ts.mean(0), js.mean(0), atol=3e-3)
    np.testing.assert_allclose(ts[:, :100].std(0), js[:, :100].std(0), rtol=0.2)
    assert (ts[:, 100:] == 0).all() and (js[:, 100:] == 0).all()  # prev action, t


@pytest.mark.parametrize("cfg", [{}, SMALL], ids=["humanoid", "small"])
def test_chain_walker_planes_match_jax(cfg):
    jenv, jstate = _states(cfg, 16, 4)
    jp, tp = jkm.chain_walker_planes(max_steps=50, **cfg), tkm.chain_walker_planes(max_steps=50, **cfg)
    jpl, tpl = jp.to_planes(jstate), tp.to_planes(_t(_flat(jstate)))
    assert sorted(jpl) == sorted(tpl)
    for k in jpl:
        np.testing.assert_array_equal(tpl[k].numpy(), np.asarray(jpl[k]), err_msg=k)
    jpl.pop("done"), tpl.pop("done")
    np.testing.assert_allclose(tp.obs_planes(tpl).numpy(), np.asarray(jp.obs_planes(jpl)),
                               rtol=OBS_RTOL, atol=OBS_ATOL)
    act = _actions(16, jenv.act_dim, 1).T.copy()
    live = np.ones(16, bool)
    jstep = jax.jit(jp.step_planes)  # one compile: eager op-by-op dominated the time
    for step in range(5):
        jpl, jr, jd = jstep(jpl, jnp.asarray(act))
        tpl, tr, td = tp.step_planes(tpl, _t(act))
        np.testing.assert_allclose(tr.numpy()[0, live], np.asarray(jr)[0, live],
                                   rtol=REWARD_RTOL, atol=REWARD_ATOL)
        np.testing.assert_array_equal(td.numpy()[0, live], np.asarray(jd)[0, live])
        for k in jpl:
            np.testing.assert_allclose(tpl[k].numpy()[:, live], np.asarray(jpl[k])[:, live],
                                       rtol=STATE_RTOL, atol=STATE_ATOL)
        if step == 0:
            assert td[0, 1:4].all() and not td[0, 4:].any()
        live &= ~np.asarray(jd)[0]
    # the plane form is the batched env's physics, row for row
    tenv = chain_walker(max_steps=50, **cfg)
    s = _t(_flat(_states(cfg, 16, 4)[1]))
    planes = tp.to_planes(s)
    np.testing.assert_allclose(tp.obs_planes(planes).T.numpy(), tenv.obs(s).numpy(),
                               rtol=OBS_RTOL, atol=OBS_ATOL)
    assert tp.exploded(planes)[0, 2:4].all() and not tp.exploded(planes)[0, 4:].any()


def _planes_params(seed, n, sizes=SIZES, w_scale=0.2):
    rng = np.random.default_rng(seed)
    weights = [(w_scale * rng.normal(size=(fi, fo, n))).astype(np.float32)
               for fi, fo in zip(sizes[:-1], sizes[1:])]
    biases = [(0.1 * rng.normal(size=(fo, n))).astype(np.float32) for fo in sizes[1:]]
    return weights, biases


@pytest.mark.parametrize("linear", [(), (0,)], ids=["tanh", "low-rank"])
def test_mlp_planes_match_jax(linear):
    sizes = SIZES if not linear else (244, 16, 64, 17)
    weights, biases = _planes_params(5, 7, sizes)
    obs = np.random.default_rng(6).normal(size=(244, 7)).astype(np.float32)
    want = jkm._mlp_planes([jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases],
                           jnp.asarray(obs), sizes, linear)
    got = tkm._mlp_planes([_t(w) for w in weights], [_t(b) for b in biases], _t(obs), sizes, linear)
    assert got.shape == (17, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _emulate_mlp_order(weights, biases, obs, sizes, linear):
    """The dot-product order that csrc/rollout_mlp.cu documents, in numpy
    float32, written from the kernel's header and not from the port's code:
    the Q = ceil(fan_in / 4) quads of inputs cut into S = 4, 2 or 1 slices
    (the most that leaves none empty), slice s taking quads [Q s // S,
    Q (s+1) // S); each slice summed in k order, slice 0 from the bias and
    the others from -0.0; then (s0 + s1) + (s2 + s3). Every multiply and add
    rounds on its own (numpy ufuncs); tanh is torch's, since numpy's may
    round differently."""
    h = obs
    for li, (fi, w, b) in enumerate(zip(sizes[:-1], weights, biases)):
        quads = -(-fi // 4)
        S = max(x for x in (1, 2, 4) if x <= quads)
        parts = []
        for s in range(S):
            k0, k1 = min(4 * (quads * s // S), fi), min(4 * (quads * (s + 1) // S), fi)
            acc = b.copy() if s == 0 else np.full_like(b, -0.0)
            for k in range(k0, k1):
                acc = acc + h[k] * w[k]
            parts.append(acc)
        while len(parts) > 1:
            parts = [parts[q] + parts[q + 1] for q in range(0, len(parts), 2)]
        h = parts[0]
        if li < len(sizes) - 2 and li not in linear:
            h = torch.tanh(torch.from_numpy(h)).numpy()
        assert h.dtype == np.float32
    return h


@pytest.mark.parametrize(
    "sizes,linear",
    [((244, 64, 64, 17), ()), ((244, 37, 23, 17), ()), ((244, 16, 64, 17), (0,)),
     ((64, 8, 2, 4), ())],
    ids=["main", "ragged", "low-rank", "narrow"])
def test_mlp_planes_matches_documented_order(sizes, linear):
    """_mlp_planes (the plain version, and so the kernel held to it bit for
    bit on the card) equals the order the kernel's header documents, bit
    for bit, with -0.0 and NaN inputs among the observations."""
    weights, biases = _planes_params(12, 5, sizes, w_scale=0.3)
    obs = np.random.default_rng(13).normal(size=(sizes[0], 5)).astype(np.float32)
    obs[3, 0] = np.nan
    # env 1: layer 0's sums are -0.0 exactly (a slice that started from +0.0
    # would turn them to +0.0)
    obs[:, 1] = np.abs(obs[:, 1]) + 0.5
    weights[0][:, :, 1] = -0.0
    biases[0][:, 1] = -0.0
    want = _emulate_mlp_order(weights, biases, obs, sizes, linear)
    got = tkm._mlp_planes([_t(w) for w in weights], [_t(b) for b in biases], _t(obs), sizes,
                          linear).numpy()
    assert got.shape == (sizes[-1], 5)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert tkm._slice_bounds(244) == ((0, 60), (60, 120), (120, 180), (180, 244))
    assert tkm._slice_bounds(37) == ((0, 8), (8, 20), (20, 28), (28, 37))


def _walker_planes(n, ep, max_steps, seed=0):
    """JAX resets broadcast over the population, episode-major, as planes of
    both packages."""
    jp = jkm.chain_walker_planes(max_steps=max_steps)
    env0 = jax.vmap(jp.base.reset)(jax.random.split(jax.random.PRNGKey(seed), ep))
    flat = jax.tree.map(
        lambda x: jnp.broadcast_to(x[:, None], (ep, n) + x.shape[1:]).reshape((ep * n,) + x.shape[1:]),
        env0)
    jpl = jp.to_planes(flat)
    return jp, jpl, {k: _t(v) for k, v in jpl.items()}


def _jax_loop_reference(weights, biases, planes0, T, penv, sizes):
    """tests/test_kernels_mlp.py::_loop_reference: the JAX kernel's math
    outside Pallas, compiled once by ``jax.jit`` (eager op-by-op dominated
    the time)."""
    return jax.jit(lambda w, b, p: _jax_loop(w, b, p, T, penv, sizes))(
        tuple(weights), tuple(biases), dict(planes0))


def _jax_loop(weights, biases, planes0, T, penv, sizes):
    state = dict(planes0)
    done = state.pop("done") > 0.5
    total = jnp.zeros_like(done, dtype=jnp.float32)
    for _ in range(T):
        act = jkm._mlp_planes(weights, biases, penv.obs_planes(state), sizes)
        state, reward, step_done = penv.step_planes(state, act)
        total = total + jnp.where(done, 0.0, reward)
        done = done | step_done
    return total.reshape(-1)


def test_fused_mlp_rollout_plain_matches_jax_kernel():
    """n=5, T=6 as the JAX package's tier-1 case: the port's CPU route (the
    plain version) against the Pallas kernel in interpret mode."""
    n, T = 5, 6
    jp, jpl, tpl = _walker_planes(n, 1, T)
    weights, biases = _planes_params(1, n)
    want = jkm.fused_mlp_rollout(
        tuple(jnp.asarray(w) for w in weights), tuple(jnp.asarray(b) for b in biases), jpl,
        T=T, sizes=SIZES, step_planes=jp.step_planes, obs_planes=jp.obs_planes,
        early_stop=False, interpret=True)
    launches = tkm.fused_mlp_rollout.launches
    got = tkm.fused_mlp_rollout([_t(w) for w in weights], [_t(b) for b in biases], tpl, T, SIZES,
                                tkm.chain_walker_planes(max_steps=T), device="cpu")
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    assert tkm.fused_mlp_rollout.launches == launches  # the CPU route launches nothing


def test_fused_mlp_rollout_plain_episode_major_matches_jax_reference():
    """episodes=2: env e*n + i runs individual i (the JAX reference tiles the
    weights episode-major instead)."""
    n, ep, T = 12, 2, 8
    jp, jpl, tpl = _walker_planes(n, ep, T, seed=2)
    weights, biases = _planes_params(2, n)
    want = _jax_loop_reference(
        tuple(jnp.tile(jnp.asarray(w), (1, 1, ep)) for w in weights),
        tuple(jnp.tile(jnp.asarray(b), (1, ep)) for b in biases), jpl, T, jp, SIZES)
    tp = tkm.chain_walker_planes(max_steps=T)
    got = tkm.fused_mlp_rollout_plain([_t(w) for w in weights], [_t(b) for b in biases], tpl, T,
                                      SIZES, tp, episodes=ep)
    assert got.shape == (ep * n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    # weights given through strided views read the same numbers
    strided = [_t(w.transpose(2, 0, 1)).permute(1, 2, 0) for w in weights]
    again = tkm.fused_mlp_rollout_plain(strided, [_t(b.T).T for b in biases], tpl, T, SIZES, tp,
                                        episodes=ep)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_plain_stats_count_live_steps_and_explosions():
    """States pushed to the ends of the episode (_states: fallen, NaN,
    beyond the bound) and large weights: a non-finite return only ever
    comes from an exploded env, and the live steps are the steps whose
    reward counted."""
    n, T = 16, 12
    tp = tkm.chain_walker_planes(max_steps=T)
    tpl = tp.to_planes(_t(_flat(_states({}, n, 3)[1])))
    weights, biases = _planes_params(3, n, w_scale=3.0)
    args = ([_t(w) for w in weights], [_t(b) for b in biases], tpl, T, SIZES, tp)
    totals, steps, exploded = tkm.fused_mlp_rollout_plain(*args, stats=True)
    np.testing.assert_array_equal(totals.numpy(), tkm.fused_mlp_rollout_plain(*args).numpy())
    np.testing.assert_array_equal(steps[1:4].numpy(), [1, 1, 1])
    np.testing.assert_array_equal(exploded[:5].numpy(), [False, False, True, True, False])
    assert (steps[4:] == T).all() and not torch.isfinite(totals[2])
    assert (torch.isfinite(totals) | exploded).all()
    # an env that starts done collects nothing
    tpl2 = dict(tpl, done=torch.ones_like(tpl["done"]))
    zero, steps0, _ = tkm.fused_mlp_rollout_plain(*args[:2], tpl2, *args[3:], stats=True)
    assert (zero == 0).all() and (steps0 == 0).all()


def test_tree_and_vector_matches_ravel_pytree():
    rng = np.random.default_rng(8)
    tree = [{"w": rng.normal(size=(3, 4)), "b": rng.normal(size=(4,))},
            {"w": rng.normal(size=(4, 2)), "b": rng.normal(size=(2,)), "a": rng.normal(size=(1,))}]
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    jflat, _ = ravel_pytree(tree)
    tav = TreeAndVector(tree)
    jtav = JaxTreeAndVector(tree)
    assert tav.dim == jtav.dim == jflat.shape[0]
    vec = tav.to_vector(tree)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jflat))  # b before w, "a" first
    back = tav.to_tree(vec)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(x), y)
    pop = rng.normal(size=(5, tav.dim)).astype(np.float32)
    tpop = _t(pop)
    ttree = tav.batched_to_tree(tpop)
    jtree = jax.vmap(jtav.to_tree)(jnp.asarray(pop))
    for x, y in zip(jax.tree.leaves(ttree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        # a view into the population, not a copy
        assert x.untyped_storage().data_ptr() == tpop.untyped_storage().data_ptr()
    np.testing.assert_array_equal(tav.batched_to_vector(ttree).numpy(), pop)
    with pytest.raises(ValueError, match="genome length"):
        tav.batched_to_tree(tpop[:, 1:])


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"linear_layers": (0,)}, {"use_matmul": True}, {"use_matmul": False}],
    ids=["default", "low-rank", "matmul", "reduce"],
)
def test_mlp_policy_matches_jax(kwargs):
    sizes = (64, 8, 8, 4) if "linear_layers" in kwargs else (64, 64, 64, 4)
    jinit, japply = jax_mlp_policy(sizes, **kwargs)
    tinit, tapply = mlp_policy(sizes, **kwargs)
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))
    tparams = tinit(0, device="cpu")
    assert [tuple(l["w"].shape) for l in tparams] == [l["w"].shape for l in jparams]
    assert all((l["b"] == 0).all() for l in tparams)
    rng = np.random.default_rng(9)
    pop = 0.3 * rng.normal(size=(6, TreeAndVector(tparams).dim)).astype(np.float32)
    obs = rng.normal(size=(6, 2, sizes[0])).astype(np.float32)
    jtree = jax.vmap(JaxTreeAndVector(jparams).to_tree)(jnp.asarray(pop))
    # the JAX engine's double vmap over (population, episodes)
    want = jax.vmap(jax.vmap(japply, in_axes=(None, 0)), in_axes=(0, 0))(jtree, jnp.asarray(obs))
    ttree = TreeAndVector(tparams).batched_to_tree(_t(pop))
    got = tapply([{k: v[:, None] for k, v in l.items()} for l in ttree], _t(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        mlp_policy(sizes, linear_layers=(3,))


def _jax_resets(env, key, episodes):
    """The JAX engines' reset draws for stochastic_reset=False, as the
    port's flat states."""
    k_eps = jax.random.fold_in(key, 0)
    return _flat(jax.vmap(env.reset)(jax.random.split(k_eps, episodes)))


def test_interop_mlp_params_same_actions_and_returns():
    """One policy carried over from the JAX package computes the same
    actions and the same walker returns in both packages; flat genomes
    cross through population() and unflatten to the same trees."""
    sizes = (244, 16, 8, 17)
    jinit, japply = jax_mlp_policy(sizes)
    jparams = jinit(jax.random.PRNGKey(1))
    tparams = interop.mlp_params(jax.tree.map(np.asarray, jparams), device="cpu")
    _, tapply = mlp_policy(sizes)
    obs = np.random.default_rng(10).normal(size=(3, 244)).astype(np.float32)
    np.testing.assert_allclose(tapply(tparams, _t(obs)).numpy(),
                               np.asarray(jax.vmap(japply, in_axes=(None, 0))(jparams, obs)),
                               rtol=1e-5, atol=1e-5)
    jenv, tenv = jax_chain_walker(max_steps=20), chain_walker(max_steps=20)
    key = jax.random.PRNGKey(2)
    kw = dict(num_episodes=2, stochastic_reset=False)
    jbatch = jax.tree.map(lambda x: jnp.stack([x, 0.5 * x]), jparams)
    want, _ = JaxProblem(japply, jenv, **kw).evaluate(JaxProblem(japply, jenv, **kw).init(key), jbatch)
    tprob = PolicyRolloutProblem(tapply, tenv, device="cpu", **kw)
    resets = _jax_resets(jenv, key, 2)
    tprob._episode_states = lambda seed, env: _t(resets)
    tbatch = interop.mlp_params(jax.tree.map(np.asarray, jbatch), device="cpu")
    got, _ = tprob.evaluate(tprob.init(0), tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REWARD_RTOL, atol=REWARD_ATOL)
    # flat genomes: JAX's (pop, dim) -> population() -> batched_to_tree
    jtav = JaxTreeAndVector(jparams)
    genomes = np.asarray(jax.vmap(jtav.to_vector)(jbatch))
    ttree = TreeAndVector(tparams).batched_to_tree(interop.population(genomes, device="cpu"))
    for x, y in zip(jax.tree.leaves(ttree), jax.tree.leaves(jbatch)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError, match="params tree"):
        interop.mlp_params({"w": np.zeros((2, 2))}, device="cpu")


@pytest.mark.parametrize(
    "sizes,linear", [((244, 16, 8, 17), ()), ((244, 8, 16, 17), (0,))], ids=["mlp", "low-rank"])
def test_fused_planes_engine_matches_scan_engine(sizes, linear):
    """The port's big-policy engine against its scan engine, as
    tests/test_kernels_mlp.py:140-160 holds the JAX package's."""
    penv = tkm.chain_walker_planes(max_steps=25)
    init_params, apply = mlp_policy(sizes, linear_layers=linear)
    adapter = TreeAndVector(init_params(0, device="cpu"))
    pop = 0.2 * torch.randn(6, adapter.dim, generator=torch.Generator().manual_seed(4))
    tree = adapter.batched_to_tree(pop)
    kw = dict(num_episodes=2, stochastic_reset=False, device="cpu")
    scan = PolicyRolloutProblem(apply, penv.base, **kw)
    fused = PolicyRolloutProblem(apply, penv.base, fused_planes=penv, fused_planes_linear=linear, **kw)
    f_scan, _ = scan.evaluate(scan.init(9), tree)
    f_fused, _ = fused.evaluate(fused.init(9), tree)
    np.testing.assert_allclose(f_fused.numpy(), f_scan.numpy(), rtol=ENGINE_TOL, atol=ENGINE_TOL)
    if linear:  # the probe refuses a policy whose linear spec differs
        bad = PolicyRolloutProblem(apply, penv.base, fused_planes=penv, **kw)
        with pytest.raises(ValueError, match="disagrees"):
            bad.evaluate(bad.init(9), tree)


def test_fused_planes_rejects_wrong_policy_and_inputs():
    penv = tkm.chain_walker_planes(max_steps=10)
    init_params, apply = mlp_policy(SIZES, activation=torch.relu)
    params = init_params(0, device="cpu")
    tree = [{k: v[None].repeat_interleave(4, 0) for k, v in l.items()} for l in params]
    prob = PolicyRolloutProblem(apply, penv.base, fused_planes=penv, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        prob.evaluate(prob.init(0), tree)
    _, tanh_apply = mlp_policy(SIZES)
    prob = PolicyRolloutProblem(tanh_apply, penv.base, fused_planes=penv, device="cpu")
    with pytest.raises(ValueError, match="params tree"):
        prob.evaluate(prob.init(0), torch.zeros(4, 10))
    with pytest.raises(ValueError, match="do not match env"):
        prob.evaluate(prob.init(0), tree[1:])
    bf16 = PolicyRolloutProblem(tanh_apply, penv.base, fused_planes=penv,
                                fused_planes_dtype=torch.bfloat16, device="cpu")
    assert bf16.fused_planes_inputs(bf16.init(0), tree)["weight_dtype"] == torch.bfloat16
    with pytest.raises(ValueError, match="weight_dtype must be"):
        PolicyRolloutProblem(apply, penv.base, fused_planes=penv, fused_planes_dtype=torch.float16,
                             device="cpu")
    with pytest.raises(ValueError, match="OR"):
        PolicyRolloutProblem(apply, penv.base, fused_planes=penv, fused_env=object(), device="cpu")
    with pytest.raises(ValueError, match="disagrees with env"):
        PolicyRolloutProblem(apply, chain_walker(max_steps=11), fused_planes=penv, device="cpu")


def test_fused_mlp_rollout_refuses_bad_inputs():
    n, T = 4, 3
    _, _, tpl = _walker_planes(n, 1, T)
    weights, biases = [_t(w) for w in _planes_params(0, n)[0]], [_t(b) for b in _planes_params(0, n)[1]]
    tp = tkm.chain_walker_planes(max_steps=T)
    run = lambda **kw: tkm.fused_mlp_rollout(
        kw.pop("w", weights), kw.pop("b", biases), kw.pop("s", tpl), T, SIZES, tp,
        device="cpu", **kw)
    assert run().shape == (n,)
    for bad in ((3,), (-1,), (0, 99)):
        with pytest.raises(ValueError, match="out of range"):
            run(linear=bad)
    assert run(linear=(0,)).shape == (n,)
    assert run(weight_dtype=torch.bfloat16).shape == (n,)
    for bad in (torch.float16, torch.float32, torch.float64):
        with pytest.raises(ValueError, match="weight_dtype must be"):
            run(weight_dtype=bad)
    with pytest.raises(ValueError, match="weights\\[1\\]"):
        run(w=[weights[0], weights[1][:, :-1], weights[2]])
    with pytest.raises(ValueError, match="'done' plane"):
        run(s={k: v for k, v in tpl.items() if k != "done"})
    with pytest.raises(ValueError, match="episode-major"):
        run(episodes=2)


def test_hopper_budget_report():
    """The main path's policy takes the instance built for it: 128 threads
    (64 outputs x 4 slices, two outputs a thread), layer 1 and 12 of layer
    0's 61 quads in registers, 56944 bytes of shared memory a block (layer
    0's other 49 quads and layer 2 as [k/4][j][k%4], biases, activations,
    the reward's 64 terms), 128 registers a thread, four blocks to an SM;
    83780 policy bytes copied in once per episode. The same widths with a
    linear layer take the generic instance, all weights in shared memory,
    256 threads, two blocks; a policy too wide for one block reports
    negative headroom."""
    rep = tkm.fused_rollout_analysis((244, 64, 64, 17))
    assert rep["policy_floats"] == 20945 and rep["policy_bytes"] == 83780
    assert rep["instance"] == "main" and rep["slices"] == (4, 4, 4)
    assert rep["threads_per_block"] == 128
    assert rep["smem_bytes_per_block"] == 4 * (49 * 64 * 4 + 16 * 17 * 4 + (64 + 64 + 20)
                                               + (244 + 64 + 64 + 20) + 64) == 56944
    assert rep["registers_per_thread"] == 128 and rep["blocks_per_sm"] == 4
    assert rep["headroom_bytes"] == 232448 - 56944
    lin = tkm.fused_rollout_analysis((244, 64, 64, 17), linear=(0,))
    assert lin["instance"] == "generic" and lin["threads_per_block"] == 256
    assert lin["smem_bytes_per_block"] == 56944 + 4 * (12 * 64 * 4 + 64 * 64) == 85616
    assert lin["registers_per_thread"] == 128 and lin["blocks_per_sm"] == 2
    # no fan_in a multiple of 4: whole quads, the last one short
    ragged = tkm.fused_rollout_analysis((244, 37, 23, 17))
    assert ragged["instance"] == "generic" and ragged["slices"] == (4, 4, 4)
    floats = 4 * (61 * 37 + 10 * 23 + 6 * 17) + (40 + 24 + 20) + (244 + 40 + 24 + 20) + 64
    assert ragged["threads_per_block"] == 160 and ragged["smem_bytes_per_block"] == 4 * floats
    assert ragged["blocks_per_sm"] == 65536 // (160 * 128)  # registers bind first
    wide = tkm.fused_rollout_analysis((244, 256, 256, 17))
    assert wide["headroom_bytes"] < 0 and wide["blocks_per_sm"] == 0
    small = tkm.fused_rollout_analysis((64, 16, 16, 4), tkm.chain_walker_planes(**SMALL))
    assert small["instance"] == "generic" and small["threads_per_block"] == 64
    assert small["blocks_per_sm"] == 8
    tiny = tkm.fused_rollout_analysis((64, 8, 2, 4), tkm.chain_walker_planes(**SMALL))
    assert tiny["slices"] == (4, 2, 1) and tiny["threads_per_block"] == 32


def test_hopper_budget_report_bf16():
    """bf16 residency: 2 bytes a resident weight and bias, each region still
    16-byte aligned (activations and the reward's terms stay float32). The
    main instance's block needs 29392 bytes, half its weights' share;
    registers still hold it to four blocks an SM. The policy too wide for
    a float32 block fits once its weights take 2 bytes."""
    rep = tkm.fused_rollout_analysis((244, 64, 64, 17), weight_dtype=torch.bfloat16)
    assert rep["weight_dtype"] == "torch.bfloat16" and rep["instance"] == "main"
    assert rep["smem_bytes_per_block"] == 2 * (49 * 64 * 4 + 16 * 17 * 4) + 2 * (64 + 64) + 48 + 4 * (
        (244 + 64 + 64 + 20) + 64) == 29392
    assert rep["blocks_per_sm"] == 4 and rep["policy_bytes"] == 2 * 20945
    f32 = tkm.fused_rollout_analysis((244, 64, 64, 17))
    assert f32["weight_dtype"] == "torch.float32" and f32["policy_bytes"] == 4 * 20945
    plan = tkm._smem_plan((244, 64, 64, 17), (), torch.bfloat16)
    assert all(off % 4 == 0 for off in plan.w_off + plan.b_off + plan.h_off)  # 16-byte aligned
    wide = (244, 200, 200, 17)
    assert tkm.fused_rollout_analysis(wide)["headroom_bytes"] < 0
    assert tkm.fused_rollout_analysis(wide, weight_dtype=torch.bfloat16)["headroom_bytes"] > 0
    with pytest.raises(ValueError, match="weight_dtype must be"):
        tkm.fused_rollout_analysis(wide, weight_dtype=torch.float16)


def test_fused_mlp_rollout_plain_bf16_matches_jax_kernel():
    """bf16 residency at a tiny walker (7 masses, obs 64, act 4; MLP
    64-8-8-4, n 6, T 5): the port's CPU route against the Pallas kernel in
    interpret mode with weight_dtype=jnp.bfloat16. Both round the planes to
    bfloat16 (to nearest even) and compute in float32, so the rollout
    tolerance is the float32 one; the bf16 returns differ from the float32
    ones, so the rounding did happen."""
    n, T, sizes = 6, 5, (64, 8, 8, 4)
    cfg = dict(SMALL, max_steps=T)
    jp, tp = jkm.chain_walker_planes(**cfg), tkm.chain_walker_planes(**cfg)
    env0 = jax.vmap(jp.base.reset)(jax.random.split(jax.random.PRNGKey(4), n))
    jpl = jp.to_planes(env0)
    tpl = {k: _t(v) for k, v in jpl.items()}
    weights, biases = _planes_params(7, n, sizes, w_scale=0.7)
    want = jkm.fused_mlp_rollout(
        tuple(jnp.asarray(w) for w in weights), tuple(jnp.asarray(b) for b in biases), jpl,
        T=T, sizes=sizes, step_planes=jp.step_planes, obs_planes=jp.obs_planes,
        early_stop=False, interpret=True, weight_dtype=jnp.bfloat16)
    tw, tb = [_t(w) for w in weights], [_t(b) for b in biases]
    got = tkm.fused_mlp_rollout(tw, tb, tpl, T, sizes, tp, weight_dtype=torch.bfloat16, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    f32 = tkm.fused_mlp_rollout_plain(tw, tb, tpl, T, sizes, tp)
    assert (f32 != got).any()
    # the plain bf16 route is the float32 route on rounded planes, bit for bit
    rounded = tkm.fused_mlp_rollout_plain([w.bfloat16().float() for w in tw],
                                          [b.bfloat16().float() for b in tb], tpl, T, sizes, tp)
    np.testing.assert_array_equal(got.numpy(), rounded.numpy())
    assert (jnp.asarray(weights[0]).astype(jnp.bfloat16).astype(jnp.float32)
            == jnp.asarray(tw[0].bfloat16().float().numpy())).all()  # both round alike


def test_fused_planes_dtype_engine_matches_jax():
    """PolicyRolloutProblem(fused_planes_dtype=bfloat16) against the JAX
    package's, both on the big-policy engine (the JAX kernel in interpret
    mode), JAX's resets handed to the port: 64-8-8-4 at the small walker,
    pop 4, T 5."""
    cfg = dict(SMALL, max_steps=5)
    jp, tp = jkm.chain_walker_planes(**cfg), tkm.chain_walker_planes(**cfg)
    sizes = (64, 8, 8, 4)
    jinit, japply = jax_mlp_policy(sizes)
    _, tapply = mlp_policy(sizes)
    jparams = jinit(jax.random.PRNGKey(3))
    jbatch = jax.tree.map(lambda x: jnp.stack([x, 0.5 * x, -x, 2.0 * x]), jparams)
    kw = dict(num_episodes=1, stochastic_reset=False)
    jprob = JaxProblem(japply, jp.base, fused_planes=jp, fused_interpret=True,
                       fused_planes_dtype=jnp.bfloat16, **kw)
    key = jax.random.PRNGKey(6)
    want, _ = jprob.evaluate(jprob.init(key), jbatch)
    tprob = PolicyRolloutProblem(tapply, tp.base, fused_planes=tp, fused_planes_dtype=torch.bfloat16,
                                 device="cpu", **kw)
    resets = _jax_resets(jp.base, key, 1)
    tprob._episode_states = lambda seed, env: _t(resets)
    got, _ = tprob.evaluate(tprob.init(0), interop.mlp_params(jax.tree.map(np.asarray, jbatch),
                                                              device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)


def test_walker_entry_points_refuse_a_missing_cuda(monkeypatch):
    """device=None means cuda: without a card every new entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    penv = tkm.chain_walker_planes(max_steps=5)
    init_params, apply = mlp_policy(SIZES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyRolloutProblem(apply, penv.base, fused_planes=penv)
    weights, biases = _planes_params(0, 2)
    _, _, tpl = _walker_planes(2, 1, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkm.fused_mlp_rollout([_t(w) for w in weights], [_t(b) for b in biases], tpl, 5, SIZES, penv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.mlp_params([{"w": np.zeros((2, 2)), "b": np.zeros(2)}])


def _substitute_noise(algo, halves):
    """The n-th new noise seed the port sees gets JAX's n-th draw."""
    by_seed = {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.as_tensor(np.array(halves[len(by_seed)]))
        return by_seed[seed]

    algo._draw_noise = draw


def test_slice_openes_walker_matches_jax_over_two_generations():
    """The slice as a whole, at the small walker (7 masses, obs 64, act 4),
    MLP 64-8-8-4, pop 8, T 20: OpenES with rank-based fitness through
    StdWorkflow and the big-policy engine in both packages (the JAX kernel
    in interpret mode), from the same state, with JAX's noise and resets
    handed to the port. Tolerance: returns agree to ~1e-6 (the rollout
    tolerance above), which leaves every rank the same, so the centers
    differ only by the rounding of the gradient's sum over 8 ranks."""
    pop_size, gens = 8, 2
    cfg = dict(SMALL, max_steps=20)
    jp, tp = jkm.chain_walker_planes(**cfg), tkm.chain_walker_planes(**cfg)
    sizes = (64, 8, 8, 4)
    jinit, japply = jax_mlp_policy(sizes)
    tinit, tapply = mlp_policy(sizes)
    jtav = JaxTreeAndVector(jinit(jax.random.PRNGKey(0)))
    ttav = TreeAndVector(tinit(0, device="cpu"))
    center0 = 0.3 * np.random.default_rng(11).normal(size=(jtav.dim,)).astype(np.float32)
    kw = dict(num_episodes=1, stochastic_reset=False)
    jwf = JaxStdWorkflow(
        JaxOpenES(jnp.asarray(center0), pop_size, learning_rate=0.05, noise_stdev=0.05),
        JaxProblem(japply, jp.base, fused_planes=jp, fused_interpret=True, **kw),
        opt_direction="max", pop_transforms=(jtav.batched_to_tree,),
        fit_transforms=(jax_rank_based_fitness,))
    talgo = OpenES(torch.as_tensor(center0), pop_size, learning_rate=0.05, noise_stdev=0.05,
                   device="cpu")
    tprob = PolicyRolloutProblem(tapply, tp.base, fused_planes=tp, device="cpu", **kw)
    twf = StdWorkflow(talgo, tprob, opt_direction="max", pop_transforms=(ttav.batched_to_tree,),
                      fit_transforms=(rank_based_fitness,), device="cpu")

    jstate = jwf.init(jax.random.PRNGKey(0))
    tstate = interop.std_workflow_state(twf, jax.tree.map(np.asarray, jstate))
    resets = _jax_resets(jp.base, jstate.prob.key, 1)
    tprob._episode_states = lambda seed, env: _t(resets)
    halves = []
    for _ in range(gens):
        jstate = jwf.step(jstate)
        halves.append(np.asarray(jax.random.normal(jstate.algo.noise_key, (pop_size // 2, jtav.dim))))
    _substitute_noise(talgo, halves)
    launches = tkm.fused_mlp_rollout.launches
    tstate = twf.run(tstate, gens)

    assert tstate.generation == int(jstate.generation) == gens
    assert tkm.fused_mlp_rollout.launches == launches  # the CPU route launches nothing
    jcenter = np.asarray(jstate.algo.center)
    assert np.abs(jcenter - center0).max() > 1e-3  # the slice moved the center
    np.testing.assert_allclose(tstate.algo.center.numpy(), jcenter, rtol=1e-5, atol=1e-6)
