"""The stacked member form of the port (``core/members.py``): member calls
through ``torch.func.vmap`` against the per-member loop, member seeds and
draws, the batched kernels' ``vmap`` rules, and the batched
non-dominated sort and island migration against the JAX package's
``vmap``, on the CPU.

The six algorithms of the stacked main paths (CMA-ES, OpenES, PSO, CSO,
SHADE, NSGA-II) are held bit for bit against their per-member loop. Every
other algorithm class either runs stacked within ``rtol 1e-5, atol 1e-6``
of its loop (a batched matrix product or reduction may round apart from
its unbatched form at the last ulp: ``tests/test_tenancy.py``'s fleet
tolerance), or says it cannot (``stackable = False``), and then its
members run one by one, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
import evox_tpu_torch.algorithms.mo as tmo
import evox_tpu_torch.algorithms.so.de as tde
import evox_tpu_torch.algorithms.so.es as tes
import evox_tpu_torch.algorithms.so.pso as tpso
from evox_tpu import IslandWorkflow as JaxIslandWorkflow
from evox_tpu.algorithms.mo import NSGA2 as JaxNSGA2
from evox_tpu.kernels.dominance import packed_dominance_reference as jax_packed_reference
from evox_tpu.operators.selection.non_dominate import non_dominated_sort as jax_nds
from evox_tpu.problems.numerical import DTLZ2 as JaxDTLZ2
from evox_tpu_torch import IslandWorkflow, interop
from evox_tpu_torch.core.members import (
    MemberSeeds,
    member_call,
    member_draw,
    member_route,
    member_rows,
    n_members,
    put_state,
    stack_states,
    take_state,
    unstack_states,
)
from evox_tpu_torch.core.struct import named_leaves
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.kernels import topk as ttopk
from evox_tpu_torch.operators.selection import non_dominated_sort
from evox_tpu_torch.problems.numerical import DTLZ2, Sphere
from evox_tpu_torch.utils.common import fold_in_seed, generator, split_seed

D = 4
LB, UB = np.zeros(D, np.float32), np.ones(D, np.float32)
CENTER = np.zeros(D, np.float32)
_BOX = dict(lb=LB, ub=UB, pop_size=8)
_ES = dict(center_init=CENTER, init_stdev=1.0, pop_size=8)
_MO = dict(lb=LB, ub=UB, n_objs=2, pop_size=8)

# every algorithm class of the port, at a small size
ALGORITHMS = {
    **{name: (tpso, _BOX) for name in ("PSO", "CSO", "CLPSO", "SLPSOGS", "SLPSOUS", "FIPS",
                                       "SwmmPSO")},
    "DMSPSOEL": (tpso, dict(_BOX, sub_swarm_size=4)),
    "FSPSO": (tpso, dict(pop_size=8, dim=D)),
    **{name: (tes, _ES) for name in ("CMAES", "SepCMAES", "IPOPCMAES", "BIPOPCMAES", "MAES",
                                     "LMMAES", "RMES", "XNES", "SeparableNES", "SNES",
                                     "CR_FM_NES", "DES", "AMaLGaM", "IndependentAMaLGaM", "LES")},
    **{name: (tes, dict(center_init=CENTER, pop_size=8))
       for name in ("OpenES", "PGPE", "ARS", "ASEBO", "GuidedES", "PersistentES", "NoiseReuseES")},
    "ESMC": (tes, dict(center_init=CENTER, pop_size=9)),
    **{name: (tde, _BOX) for name in ("DE", "ODE", "CoDE", "SaDE", "JaDE", "SHADE")},
    **{name: (tmo, _MO) for name in ("NSGA2", "NSGA3", "MOEAD", "MOEADDRA", "MOEADM2M",
                                     "EAGMOEAD", "RVEA", "RVEAa", "LMOCSO", "TDEA", "GDE3",
                                     "IBEA", "SRA", "BCEIBEA", "SPEA2", "HypE", "KnEA", "BiGE",
                                     "IMMOEA")},
}
# the stacked main paths' algorithms: bit for bit against the loop
EXACT = ("CMAES", "OpenES", "PSO", "CSO", "SHADE", "NSGA2")
# the classes that say they cannot run under vmap
LOOPED = {"BCEIBEA", "EAGMOEAD", "IBEA", "IMMOEA", "KnEA", "NSGA3", "SPEA2", "SRA", "TDEA"}


def _fitness(pop, mo):
    if mo:
        return torch.stack([(pop ** 2).sum(-1), ((pop - 1) ** 2).sum(-1)], -1)
    return (pop ** 2).sum(-1)


def _run_both(algo, mo, gens=3, n=3, route=None):
    """``gens`` generations of ``n`` members stacked (one member call each
    for ask and tell) and one by one; returns (stacked, solo states)."""
    route = route or member_route(algo)
    solo = [algo.init(s) for s in split_seed(3, n)]
    stacked = stack_states(solo)
    for g in range(gens):
        use_init = g == 0 and (algo.has_init_ask or algo.has_init_tell)
        ask = algo.init_ask if use_init else algo.ask
        tell = algo.init_tell if use_init else algo.tell
        pop, stacked = member_call(ask, stacked, route=route)
        stacked = member_call(tell, stacked, _fitness(pop, mo), route=route)
        pairs = [ask(s) for s in solo]
        solo = [tell(s, _fitness(p, mo)) for p, s in pairs]
        assert torch.equal(torch.nan_to_num(pop, 7.0),
                           torch.nan_to_num(torch.stack([p for p, _ in pairs]), 7.0)) or (
            algo.__class__.__name__ not in EXACT)
    return stacked, solo


def _assert_members(stacked, solo, rtol=0.0, atol=0.0):
    assert n_members(stacked) == len(solo)
    for i, s in enumerate(solo):
        for (path, x), (p2, y) in zip(named_leaves(s), named_leaves(take_state(stacked, i))):
            assert path == p2
            if isinstance(x, torch.Tensor):
                if rtol == 0.0 and atol == 0.0:
                    assert torch.equal(torch.nan_to_num(x.float(), 7.0),
                                       torch.nan_to_num(y.float(), 7.0)), (i, path)
                else:
                    np.testing.assert_allclose(y.double().numpy(), x.double().numpy(), rtol=rtol,
                                               atol=atol, err_msg=f"member {i} {path}")
            else:
                assert x == y, (i, path, x, y)


@pytest.mark.parametrize("name", EXACT)
def test_member_call_equals_the_member_loop_bit_for_bit(name):
    mod, kwargs = ALGORITHMS[name]
    algo = getattr(mod, name)(**kwargs, device="cpu")
    assert member_route(algo) == "vmap"
    stacked, solo = _run_both(algo, mod is tmo)
    _assert_members(stacked, solo)


@pytest.mark.parametrize("name", sorted(set(ALGORITHMS) - set(EXACT)))
def test_every_algorithm_class_runs_stacked_or_says_it_cannot(name):
    mod, kwargs = ALGORITHMS[name]
    algo = getattr(mod, name)(**kwargs, device="cpu")
    assert (member_route(algo) == "loop") == (name in LOOPED)
    stacked, solo = _run_both(algo, mod is tmo)
    if name in LOOPED:
        _assert_members(stacked, solo)
    else:
        _assert_members(stacked, solo, rtol=1e-5, atol=1e-6)


def test_member_seeds_split_fold_and_refuse_one_generator():
    seeds = MemberSeeds((3, 5, 9))
    a, b = split_seed(seeds)
    assert isinstance(a, MemberSeeds) and list(a) == [split_seed(s)[0] for s in (3, 5, 9)]
    assert list(b) == [split_seed(s)[1] for s in (3, 5, 9)]
    assert list(fold_in_seed(seeds, 7)) == [fold_in_seed(s, 7) for s in (3, 5, 9)]
    with pytest.raises(TypeError, match="member seeds"):
        generator(seeds, torch.device("cpu"))


def test_a_draw_that_bypasses_the_member_seeds_raises():
    """Under ``member_call`` a raw draw (not from the member seeds) would give
    every member the same numbers: it raises."""
    class RawDraw(tpso.PSO):
        def ask(self, state):  # draws past the member seeds
            return torch.rand(8, D), state

    algo = RawDraw(LB, UB, 8, device="cpu")
    stacked = stack_states([algo.init(s) for s in (1, 2)])
    with pytest.raises(RuntimeError, match="random"):
        member_call(algo.ask, stacked)
    with pytest.raises(RuntimeError, match="member_call"):
        member_rows(torch.zeros(2))  # no member index outside a member call


def test_injected_vmapped_draws_reach_each_member():
    """A test hands a stacked run its draws by seed (each member's draw
    method gets its own seed) or through ``member_rows`` (a draw stacked
    over the members, e.g. JAX's vmapped draws)."""
    algo = tpso.PSO(LB, UB, 8, device="cpu")
    members = [algo.init(s) for s in (1, 2, 3)]
    stacked = stack_states(members)
    draws = torch.rand(3, 2, 8, D)
    algo._draw = lambda seed: tuple(member_rows(draws).unbind(0))
    # member_rows is not a per-seed function: the method must see every
    # member's seed once, and hand each its row
    by_rows = member_call(algo.ask, stacked)
    seeds = [split_seed(m.seed)[1] for m in members]
    table = {s: tuple(draws[i].unbind(0)) for i, s in enumerate(seeds)}
    algo._draw = lambda seed: table[seed]
    by_seed = member_call(algo.ask, stacked)
    solo = [algo.ask(m) for m in members]
    assert torch.equal(by_seed[0], torch.stack([p for p, _ in solo]))
    assert torch.equal(by_rows[0], by_seed[0])
    assert member_draw.calls > 0


def test_stack_take_put_and_grouped_host_values():
    """Host values that differ between members (a counter) are held per
    member; ``member_call`` runs each group of equal values as one vmap,
    equal to the loop."""
    algo = tes.CMAES(CENTER, 1.0, pop_size=8, device="cpu")
    a, b, c = (algo.init(s) for s in (1, 2, 3))
    pop, b1 = algo.ask(b)
    b1 = algo.tell(b1, _fitness(pop, False))  # one generation ahead
    stacked = stack_states([a, b1, c])
    assert type(stacked.iteration).__name__ == "MemberValues"
    assert isinstance(stacked.seed, MemberSeeds)
    pop, out = member_call(algo.ask, stacked)
    want = [algo.ask(s) for s in (a, b1, c)]
    assert torch.equal(pop, torch.stack([p for p, _ in want]))
    _assert_members(out, [s for _, s in want])
    two = take_state(stacked, [2, 0])
    assert list(two.seed) == [c.seed, a.seed]
    back = put_state(stacked, [2, 0], two)
    _assert_members(back, [a, b1, c])
    assert [m.iteration for m in unstack_states(stacked)] == [0, 1, 0]


def test_packed_dominance_batched_equals_jax_vmap():
    rng = np.random.default_rng(0)
    fit = np.round(rng.random((5, 70, 3)) * 6) / 6
    fit[1, 3] = np.nan
    fit[2, 5] = np.inf
    fit[3, 7] = -0.0
    fit = fit.astype(np.float32)
    words, counts = jax.vmap(jax_packed_reference)(jnp.asarray(fit))
    got = tdom.packed_dominance_batched(torch.from_numpy(fit), device="cpu")
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(words))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(counts))
    # the vmap rule: one batched call equal to per-member calls
    tfit = torch.from_numpy(fit)
    vm = torch.func.vmap(lambda f: tdom.packed_dominance(f, device="cpu"))(tfit)
    for i in range(5):
        one = tdom.packed_dominance(tfit[i], device="cpu")
        assert torch.equal(vm[0][i], one[0]) and torch.equal(vm[1][i], one[1])


def test_partial_topk_vmap_rule_equals_per_member_calls():
    v = torch.round(torch.rand(4, 3, 50, generator=torch.Generator().manual_seed(1)) * 5)
    v[0, 0, 3] = float("nan")
    got = torch.func.vmap(lambda x: ttopk.partial_topk(x, 7, device="cpu"))(v)
    for i in range(4):
        want = ttopk.partial_topk(v[i], 7, device="cpu")
        assert torch.equal(got[0][i], want[0]) and torch.equal(got[1][i], want[1])


@pytest.mark.parametrize("until", [None, 9])
def test_non_dominated_sort_under_member_call_equals_jax_vmap(until):
    rng = np.random.default_rng(3)
    fit = (np.round(rng.random((4, 40, 3)) * 4) / 4).astype(np.float32)
    fit[0, :5] = fit[0, 5]
    want = jax.vmap(lambda f: jax_nds(f, until=until))(jnp.asarray(fit))
    tfit = torch.from_numpy(fit)
    rank, cut = torch.func.vmap(
        lambda f: non_dominated_sort(f, until=until, return_cut_rank=True))(tfit)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want))
    for i in range(4):
        r, c = non_dominated_sort(tfit[i], until=until, return_cut_rank=True)
        assert torch.equal(rank[i], r) and int(cut[i]) == c


def test_mo_island_migration_matches_jax():
    """4 NSGA-II islands of 12 on tied objectives: the elites (one batched
    sort for all islands) and the ingesting ``migrate`` under one member
    call, against the JAX package's vmapped ``_migrate``, every island leaf
    exactly."""
    n, pop = 4, 12
    jprob = JaxDTLZ2(d=5, m=3)
    jwf = JaxIslandWorkflow(JaxNSGA2(np.zeros(5), np.ones(5), n_objs=3, pop_size=pop), jprob,
                            n_islands=n, migrate_every=1, migrate_k=3, num_objectives=3)
    twf = IslandWorkflow(tmo.NSGA2(np.zeros(5), np.ones(5), n_objs=3, pop_size=pop, device="cpu"),
                         DTLZ2(d=5, m=3, device="cpu"), n_islands=n, migrate_every=1, migrate_k=3,
                         num_objectives=3, device="cpu")
    jstate = jwf.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    cand = rng.random((n, pop, 5)).astype(np.float32)
    fit = (np.round(rng.random((n, pop, 3)) * 3) / 3).astype(np.float32)
    jalgo = jax.tree.map(np.asarray, jstate.algo)
    talgo = interop.stacked_members(twf.algorithm, jalgo, n)
    jout = jax.tree.map(np.asarray, jwf._migrate(jstate.algo, jnp.asarray(cand), jnp.asarray(fit)))
    tout = twf._migrate(talgo, torch.from_numpy(cand), torch.from_numpy(fit))
    for name in ("population", "fitness", "rank"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), getattr(jout, name),
                                      err_msg=name)
    np.testing.assert_allclose(tout.crowd.numpy(), jout.crowd, rtol=1e-6)


def test_tuple_form_snapshot_is_refused_by_name(tmp_path):
    """A snapshot of the older tuple-of-islands form is refused with an
    error that names the layout, not misread as a stacked state."""
    from evox_tpu_torch.workflows.checkpoint import CheckpointConfigError, WorkflowCheckpointer

    wf = IslandWorkflow(tpso.PSO(LB, UB, 8, device="cpu"), Sphere(), n_islands=2, device="cpu")
    state = wf.init(0)
    old = state.replace(algo=tuple(unstack_states(state.algo)))
    WorkflowCheckpointer(str(tmp_path), every=1).save(old)
    with pytest.raises(CheckpointConfigError, match="tuple"):
        wf.run(state, 2, resume_from=str(tmp_path))
