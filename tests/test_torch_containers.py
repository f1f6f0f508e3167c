"""The decomposition containers of the port against the JAX package, on the
CPU: ClusteredAlgorithm, RandomMaskAlgorithm, VectorizedCoevolution,
Coevolution and TreeAlgorithm over PSO and CSO members.

The JAX package stacks its member states on a leading axis and vmaps the
members; so does the port (``core.members.member_call``), except the tree
container, a tuple in both. The JAX containers' initial states cross
through ``interop.container_state``; each member's
draws are rebuilt from its JAX key and handed to the port's shared base
algorithm by draw seed (the port's ``_draw(seed)`` receives
``split_seed(member.seed)[1]``, so a table keyed by that seed routes each
member its own draws); RandomMask's active clusters and co-evolution's
permutation cross the same way. Both sides tell the same fitness, made
with numpy from the JAX side's candidates and rounded to a coarse grid
(tied fitness, so the stable orders show). PSO and CSO with phi 0 are
elementwise float32 arithmetic on the same draws, so every comparison is
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu.algorithms import containers as jc
from evox_tpu.algorithms.so.pso import CSO as JaxCSO
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu_torch import interop
from evox_tpu_torch.algorithms import containers as tc
from evox_tpu_torch.algorithms.so.pso import CSO, PSO
from evox_tpu_torch.core.members import n_members, take_state, unstack_states
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.utils.common import split_seed

SUB = 2  # a member's dimension


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def _fitness(cand):
    """A coarse Sphere: ties among candidates and against personal bests."""
    return np.round(np.sum(np.asarray(cand) ** 2, axis=1) / 8.0).astype(np.float32)


def _pso_draws(jmember):
    _, k1, k2 = jax.random.split(jmember.key, 3)
    shape = jmember.population.shape
    return _t(jax.random.uniform(k1, shape), jax.random.uniform(k2, shape))


def _cso_draws(jalgo, jmember):
    _, k_pair = jax.random.split(jmember.key)
    k_perm, k1, k2, k3 = jax.random.split(k_pair, 4)
    half = jalgo.pop_size // 2
    rs = [jax.random.uniform(k, (half, jalgo.dim)) for k in (k1, k2, k3)]
    return _t(jax.random.permutation(k_perm, jalgo.pop_size), *rs)


def _inject(talgo, tmembers, jmembers, make):
    """Route each member its JAX draws: the port's base ``_draw`` gets
    ``split_seed(member.seed)[1]``."""
    table = {split_seed(t.seed)[1]: make(j) for t, j in zip(tmembers, jmembers)}
    talgo._draw = lambda seed: table[seed]


def _assert_member(tstate, jstate, where):
    for f in dataclasses.fields(tstate):
        if not hasattr(jstate, f.name) or getattr(tstate, f.name) is None:
            continue  # keys (the port holds seeds), CSO's pending pass
        ours, theirs = getattr(tstate, f.name), np.asarray(getattr(jstate, f.name))
        if isinstance(ours, int):
            assert ours == int(theirs), (where, f.name)
        else:
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f"{where} {f.name}")


def _members(jstacked, n):
    return [tc.take_state(_np(jstacked), i) for i in range(n)]


def _pso(dim, pop=8):
    lb, ub = -4 * np.ones(dim, np.float32), 4 * np.ones(dim, np.float32)
    return JaxPSO(lb=lb, ub=ub, pop_size=pop), PSO(lb, ub, pop, device="cpu")


def _cso(dim, pop=8):
    lb, ub = -4 * np.ones(dim, np.float32), 4 * np.ones(dim, np.float32)
    return JaxCSO(lb=lb, ub=ub, pop_size=pop), CSO(lb, ub, pop, device="cpu")


def test_take_and_put_state_split_and_join_stacked_states():
    jbase, tbase = _pso(SUB)
    stacked = _np(jax.vmap(jbase.init)(jax.random.split(jax.random.PRNGKey(0), 3)))
    one = tc.take_state(stacked, 1)
    assert one.population.shape == (8, SUB) and one.key.shape == (2,)
    moved = one.replace(population=one.population + 1.0)
    back = tc.put_state(stacked, 1, moved)
    np.testing.assert_array_equal(back.population[1], stacked.population[1] + 1.0)
    np.testing.assert_array_equal(back.population[[0, 2]], stacked.population[[0, 2]])
    np.testing.assert_array_equal(stacked.population[1], one.population)  # not written in place
    # the port's tensors, several members at once
    t_stacked = interop.stacked_members(tbase, stacked, 3)
    assert n_members(t_stacked) == 3 and t_stacked.population.shape == (3, 8, SUB)
    two = tc.take_state(t_stacked, torch.tensor([2, 0]))
    assert torch.equal(two.population, t_stacked.population[[2, 0]])
    assert tuple(two.seed) == (t_stacked.seed[2], t_stacked.seed[0])
    put = tc.put_state(t_stacked, torch.tensor([2, 0]), two.replace(population=two.population * 0))
    assert not put.population[[0, 2]].any()
    assert torch.equal(put.population[1], take_state(t_stacked, 1).population)


def test_clustered_cso_matches_jax():
    """ClusteredAlgorithm(CSO, dim 8, 4 clusters): the first generation
    (every cluster's init_ask, CSO's whole population), then three steady
    generations, each cluster's pairing and draws its own."""
    n, dim = 4, 4 * SUB
    jbase, tbase = _cso(SUB)
    jalgo, talgo = jc.ClusteredAlgorithm(jbase, dim, n), tc.ClusteredAlgorithm(tbase, dim, n)
    jstate = jalgo.init(jax.random.PRNGKey(3))
    tstate = interop.algorithm_state(talgo, _np(jstate), seed=1)
    assert n_members(tstate) == n and tstate.population.shape[0] == n
    for gen in range(4):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        if gen:
            _inject(tbase, unstack_states(tstate), _members(jstate, n),
                    lambda j: _cso_draws(jbase, j))
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        assert tcand.shape == (8 if gen == 0 else 4, dim)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
        fit = _fitness(jcand)
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        for i, (t, j) in enumerate(zip(unstack_states(tstate), _members(jstate, n))):
            _assert_member(t, j, f"generation {gen}, cluster {i}")


def _choice(key, n, k):
    return [int(i) for i in np.asarray(jax.random.choice(key, n, (k,), replace=False))]


@pytest.mark.parametrize("change_every", [1, 2])
def test_random_mask_matches_jax_through_mask_changes(change_every):
    """RandomMaskAlgorithm(PSO, 4 clusters, 2 masked): the init protocol
    (every cluster), the cache-seeding generation (every cluster asks and
    tells), then the masked generations; the mask is re-drawn when the
    count reaches ``change_every`` (every generation, or every second)."""
    n, dim = 4, 4 * SUB
    jbase, tbase = _pso(SUB)
    jalgo = jc.RandomMaskAlgorithm(jbase, dim, n, num_mask=2, change_every=change_every)
    talgo = tc.RandomMaskAlgorithm(tbase, dim, n, num_mask=2, change_every=change_every)
    jstate = jalgo.init(jax.random.PRNGKey(5))
    tstate = interop.algorithm_state(talgo, _np(jstate), seed=2)
    assert tstate.count == -1 and tstate.sub_pops is None and len(tstate.active) == 2
    changes = 0
    for gen in range(7):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        if gen and tstate.count >= change_every:  # this ask re-draws the mask
            k = jax.random.split(jstate.key)[1]
            talgo._draw_active = lambda seed, a=_choice(k, n, 2): a
            changes += 1
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
        assert list(tstate.active) == np.asarray(jstate.active).tolist()
        fit = _fitness(jcand)
        # PSO draws in its tell (init_tell too): every cluster at the init
        # and the seeding generation, then the active ones
        told = range(n) if tstate.count in (-1, -2) else tstate.active
        jm = _members(jstate.sub_states, n)
        _inject(tbase, [take_state(tstate.sub_states, i) for i in told], [jm[i] for i in told],
                _pso_draws)
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        assert tstate.count == int(jstate.count)
        np.testing.assert_array_equal(tstate.sub_pops if tstate.sub_pops is not None
                                      else np.zeros_like(jstate.sub_pops), np.asarray(jstate.sub_pops))
        for i, (t, j) in enumerate(zip(unstack_states(tstate.sub_states),
                                       _members(jstate.sub_states, n))):
            _assert_member(t, j, f"generation {gen}, cluster {i}")
    assert changes == {1: 4, 2: 2}[change_every]


def test_random_mask_schedule_and_refusals():
    """The count after each generation: -1 until the cache is seeded, -2
    for the seeding generation's tell, then 0 after it, a re-draw whenever
    the count reaches change_every (masked clusters keep their state)."""
    _, tbase = _pso(SUB)
    talgo = tc.RandomMaskAlgorithm(tbase, 3 * SUB, 3, num_mask=1, change_every=3)
    redraws = []
    draw = talgo._draw_active
    talgo._draw_active = lambda seed: redraws.append(seed) or draw(seed)
    state = talgo.init(0)
    pop, state = talgo.init_ask(state)
    state = talgo.init_tell(state, pop[:, 0])
    counts = []
    for _ in range(8):
        before = state.sub_states
        pop, state = talgo.ask(state)
        counts.append(state.count)
        state = talgo.tell(state, pop[:, 0])
        masked = set(range(3)) - set(state.active)
        if counts[-1] >= 0:
            for i in masked:
                kept, was = take_state(state.sub_states, i), take_state(before, i)
                for (path, x), (_, y) in zip(named_leaves(kept), named_leaves(was)):
                    assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), path
    assert counts == [-2, 0, 1, 2, 0, 1, 2, 0]
    assert len(redraws) == 3  # the first mask at init, then two changes
    with pytest.raises(ValueError, match="num_mask"):
        tc.RandomMaskAlgorithm(tbase, 3 * SUB, 3, num_mask=3)
    with pytest.raises(ValueError, match="divide evenly"):
        tc.ClusteredAlgorithm(tbase, 7, 3)


@pytest.mark.parametrize("kind", ["vectorized", "round_robin"])
@pytest.mark.parametrize("random_subpop", [False, True])
def test_coevolution_matches_jax(kind, random_subpop):
    """VectorizedCoevolution and Coevolution over PSO members (4 blocks of
    2): each block's candidates spliced into the best-so-far vector,
    un-permuted for evaluation under ``random_subpop`` (JAX's permutation
    crosses with the state), the best-so-far blocks and fitness updated."""
    n, dim = 4, 4 * SUB
    jbase, tbase = _pso(SUB)
    jcls, tcls = {"vectorized": (jc.VectorizedCoevolution, tc.VectorizedCoevolution),
                  "round_robin": (jc.Coevolution, tc.Coevolution)}[kind]
    jalgo = jcls(jbase, dim, n, random_subpop=random_subpop)
    talgo = tcls(tbase, dim, n, random_subpop=random_subpop)
    jstate = jalgo.init(jax.random.PRNGKey(8))
    tstate = interop.algorithm_state(talgo, _np(jstate), seed=3)
    if random_subpop:
        assert torch.equal(tstate.permutation, torch.from_numpy(np.asarray(jstate.permutation,
                                                                           np.int64)))
        assert sorted(tstate.permutation.tolist()) == list(range(dim))
    for gen in range(6):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
        # the batch is the spliced vectors in the problem's layout
        np.testing.assert_array_equal(talgo._permute(tcand, tstate.permutation).numpy(),
                                      tstate.coop_pops.numpy())
        fit = _fitness(jcand)
        # PSO draws in its tell (init_tell too)
        jm = _members(jstate.sub_states, n)
        told = range(n) if gen == 0 or kind == "vectorized" else [tstate.iter_counter % n]
        _inject(tbase, [take_state(tstate.sub_states, i) for i in told], [jm[i] for i in told],
                _pso_draws)
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        for name in ("best_dec", "best_fit", "coop_pops"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        assert tstate.iter_counter == int(jstate.iter_counter)
        for i, (t, j) in enumerate(zip(unstack_states(tstate.sub_states),
                                       _members(jstate.sub_states, n))):
            _assert_member(t, j, f"generation {gen}, block {i}")


def test_tree_algorithm_over_a_dict_matches_jax():
    """TreeAlgorithm(PSO) over {"w": (2, 3), "b": (4,)}: one PSO a leaf, in
    jax.tree.leaves order (keys sorted), candidates reassembled into the
    dict with a leading pop axis."""
    params = {"w": np.zeros((2, 3), np.float32), "b": np.zeros(4, np.float32)}
    lbs = {"w": -np.ones(6, np.float32), "b": -2 * np.ones(4, np.float32)}
    ubs = {"w": np.ones(6, np.float32), "b": 2 * np.ones(4, np.float32)}
    jalgo = jc.TreeAlgorithm(lambda lb, ub: JaxPSO(lb=lb, ub=ub, pop_size=6), params, lbs, ubs)
    talgo = tc.TreeAlgorithm(lambda lb, ub: PSO(lb, ub, 6, device="cpu"),
                             {k: torch.from_numpy(v) for k, v in params.items()},
                             {k: torch.from_numpy(v) for k, v in lbs.items()},
                             {k: torch.from_numpy(v) for k, v in ubs.items()})
    assert [a.dim for a in talgo.inner] == [4, 6]  # "b" before "w"
    jstate = jalgo.init(jax.random.PRNGKey(2))
    tstate = interop.algorithm_state(talgo, _np(jstate), seed=5)
    for gen in range(4):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        jcand, jstate = jit_once(jalgo, ask)(jstate)
        tcand, tstate = getattr(talgo, ask)(tstate)
        assert set(tcand) == {"w", "b"} and tcand["w"].shape == (6, 2, 3)
        for key in tcand:
            np.testing.assert_array_equal(tcand[key].numpy(), np.asarray(jcand[key]))
        fit = _fitness(np.concatenate([np.asarray(jcand["b"]),
                                       np.asarray(jcand["w"]).reshape(6, -1)], axis=1))
        for a, t, j in zip(talgo.inner, tstate, _np(jstate)):  # PSO draws in its tell
            _inject(a, [t], [j], _pso_draws)
        jstate = jit_once(jalgo, tell)(jstate, jnp.asarray(fit))
        tstate = getattr(talgo, tell)(tstate, torch.from_numpy(fit))
        for i, (t, j) in enumerate(zip(tstate, _np(jstate))):
            _assert_member(t, j, f"generation {gen}, leaf {i}")
    with pytest.raises(ValueError, match="structure"):
        tc.TreeAlgorithm(lambda lb, ub: PSO(lb, ub, 6, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         {"w": torch.zeros(6)}, {"w": torch.ones(6)})
