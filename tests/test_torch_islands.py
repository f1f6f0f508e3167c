"""IslandWorkflow and the default ``Algorithm.migrate`` of the port against
the JAX package, on the CPU.

The JAX workflow runs its elites through the Pallas partial top-k in
interpret mode (``use_topk_kernel=True, topk_interpret=True``), vmapped
over the islands, as the port's batched ``partial_topk`` runs them. Its
state crosses through ``interop.island_workflow_state`` (the island-stacked
states, stacked in the port too); each island's PSO draws are rebuilt
from its JAX key and routed to it by draw seed. The problem is a Sphere
rounded to a coarse grid on both sides (ties among candidates, so the
elites' tie law shows); PSO is elementwise float32 arithmetic on the same
draws, so the islands are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import IslandWorkflow as JaxIslandWorkflow
from evox_tpu.algorithms.so.de import DE as JaxDE
from evox_tpu.algorithms.so.pso import PSO as JaxPSO
from evox_tpu.core.problem import Problem as JaxProblem
from evox_tpu.operators.selection.non_dominate import crowding_distance as jax_crowding
from evox_tpu.operators.selection.non_dominate import non_dominated_sort as jax_nds
from evox_tpu_torch import IslandWorkflow, Problem, interop
from evox_tpu_torch.algorithms.mo import NSGA2
from evox_tpu_torch.algorithms.so.de import DE
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.dtype_policy import BF16_STORAGE, apply_storage
from evox_tpu_torch.core.members import n_members, unstack_states
from evox_tpu_torch.problems.numerical import ZDT1, Sphere
from evox_tpu_torch.utils.common import split_seed
from evox_tpu_torch.workflows.islands import mo_elites

DIM = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


class _JaxTiedSphere(JaxProblem):
    def evaluate(self, state, pop):
        return jnp.round(jnp.sum(pop**2, axis=1) / 4.0), state


class _TiedSphere(Problem):
    def evaluate(self, state, pop):
        return torch.round(torch.sum(pop**2, dim=1) / 4.0), state


def _assert_islands(tstate, jstate, where):
    assert tstate.generation == int(jstate.generation)
    for i, t in enumerate(unstack_states(tstate.algo)):
        for f in dataclasses.fields(t):
            if not hasattr(jstate.algo, f.name):
                continue  # the keys: the port holds seeds
            theirs = np.asarray(getattr(jstate.algo, f.name))[i]
            np.testing.assert_array_equal(getattr(t, f.name).numpy(), theirs,
                                          err_msg=f"{where}, island {i}, {f.name}")


def test_migrating_generations_match_jax():
    """4 PSO islands of 8, ``migrate_every=2``, ``migrate_k=2``: the first
    generation (no migration), the second (each island's two best of the
    generation move one island around the ring and replace the worst
    personal bests) and the third, each against the JAX package's
    ``IslandWorkflow``, every island state exactly."""
    lb, ub = -4 * np.ones(DIM, np.float32), 4 * np.ones(DIM, np.float32)
    jwf = JaxIslandWorkflow(JaxPSO(lb=lb, ub=ub, pop_size=8), _JaxTiedSphere(), n_islands=4,
                            migrate_every=2, migrate_k=2, use_topk_kernel=True,
                            topk_interpret=True)
    twf = IslandWorkflow(PSO(lb, ub, 8, device="cpu"), _TiedSphere(), n_islands=4,
                         migrate_every=2, migrate_k=2, device="cpu")
    jstate = jwf.init(jax.random.PRNGKey(6))
    tstate = interop.island_workflow_state(twf, _np(jstate), seed=1)
    assert n_members(tstate.algo) == 4 and tstate.first_step
    _assert_islands(tstate, jstate, "init")
    for gen in range(3):
        table = {}
        for i, t in enumerate(unstack_states(tstate.algo)):
            _, k1, k2 = jax.random.split(jstate.algo.key[i], 3)
            table[split_seed(t.seed)[1]] = (_t(jax.random.uniform(k1, (8, DIM))),
                                            _t(jax.random.uniform(k2, (8, DIM))))
        twf.algorithm._draw = lambda seed: table[seed]
        scored = tstate.algo.population[0].numpy()
        jstate, tstate = jwf.step(jstate), twf.step(tstate)
        _assert_islands(tstate, jstate, f"generation {gen + 1}")
        if gen == 1:  # the migration moved rows: island 0's best of the
            # generation is now a personal best (and a particle) of island 1
            elite = scored[np.argsort(np.round(np.sum(scored**2, axis=1) / 4.0), kind="stable")[0]]
            assert (tstate.algo.pbest_position[1].numpy() == elite).all(axis=1).any()
            assert (tstate.algo.population[1].numpy() == elite).all(axis=1).any()


def test_default_migrate_elitist_acceptance_matches_jax():
    """The base ``migrate`` on a DE state with fitness 0..7: migrants offered
    to the worst rows, each accepted only if it beats the row it would
    displace (a worse migrant is dropped)."""
    lb, ub = np.zeros(2, np.float32), np.ones(2, np.float32)
    jalgo, talgo = JaxDE(lb=lb, ub=ub, pop_size=8), DE(lb, ub, 8, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(fitness=jnp.arange(8.0))
    tstate = interop.de_state(talgo, _np(jstate), seed=1)
    migrants = np.full((2, 2), 0.5, np.float32)
    for fit in ([-1.0, -2.0], [100.0, -2.0], [7.0, 6.5]):
        jnew = jalgo.migrate(jstate, jnp.asarray(migrants), jnp.asarray(fit))
        tnew = talgo.migrate(tstate, torch.from_numpy(migrants), torch.tensor(fit))
        for name in ("population", "fitness"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)), err_msg=name)
    assert float(tnew.fitness.max()) == 7.0  # 7.0 does not beat row 7's 7.0
    with pytest.raises(NotImplementedError, match="migrate"):
        OpenES(np.zeros(3), 8, device="cpu").migrate(
            OpenES(np.zeros(3), 8, device="cpu").init(0), torch.zeros(1, 3), torch.zeros(1))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m", [2, 3])
def test_mo_elites_match_jax_with_ties_and_infinite_crowding(seed, m):
    """``jnp.lexsort((-crowd, rank))[:k]`` (the JAX package's multi-objective
    elites) on integer-grid fitness: duplicate rows (equal rank and
    crowding), boundary points with +inf crowding, several of them per
    front, and fronts of one row."""
    rng = np.random.default_rng(seed)
    fit = rng.integers(0, 4, size=(40, m)).astype(np.float32)
    fit[5] = fit[6] = fit[7]  # duplicates
    k = 12
    rank = jax_nds(jnp.asarray(fit))
    crowd = jax_crowding(jnp.asarray(fit))
    want = np.asarray(jnp.lexsort((-crowd, rank))[:k])
    assert np.isinf(np.asarray(crowd)).sum() > 2
    got = mo_elites(torch.from_numpy(fit), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mo_islands_migrate_by_rank_and_crowding():
    """NSGA-II islands on ZDT1: each island's elites (rank, then crowding)
    of the migrating generation land in the next island's population."""
    prob = ZDT1(n_dim=6, device="cpu")
    algo = NSGA2(np.zeros(6), np.ones(6), n_objs=2, pop_size=12, device="cpu")
    wf = IslandWorkflow(algo, prob, n_islands=3, migrate_every=2, migrate_k=3, num_objectives=2,
                        device="cpu")
    state = wf.run(wf.init(0), 1)
    caught = {}
    elites = wf.elites
    wf.elites = lambda fit: caught.setdefault("idx", elites(fit))
    state = wf.step(state)
    assert caught["idx"].shape == (3, 3)
    per_island, ideal = wf.best(state)
    assert per_island.shape == (3, 2) and ideal.shape == (2,)
    assert bool(torch.isfinite(per_island).all())


def test_best_is_in_the_users_convention():
    class NegSphere(Problem):
        def evaluate(self, state, pop):
            return -torch.sum(pop**2, dim=1), state

    algo = PSO(-5 * np.ones(DIM), 5 * np.ones(DIM), 16, device="cpu")
    wf = IslandWorkflow(algo, NegSphere(), n_islands=2, migrate_every=5, opt_direction="max",
                        device="cpu")
    state = wf.run(wf.init(9), 20)
    per_island, best = wf.best(state)
    assert float(best) <= 1e-6 and bool((per_island <= 1e-6).all())
    assert float(best) > -1.0  # converged toward 0 from below


def test_constructor_refusals_and_deferred_arguments():
    """The refusals stand; the JAX package's ``mesh`` (the island axis
    over the ``"pop"`` axis, checked for divisibility, equal to the run
    without it), ``external_problem``, ``dtype_policy``, ``donate_carries``
    and ``run(checkpointer=, resume_from=)`` are ported and run."""
    algo = PSO(np.zeros(2), np.ones(2), 8, device="cpu")
    for kwargs, match in (({"n_islands": 1}, "islands"), ({"num_objectives": 0}, "num_objectives"),
                          ({"migrate_every": 0}, "migrate_every"),
                          ({"fit_transforms": (lambda f: f,)}, "fit_transforms")):
        with pytest.raises(ValueError, match=match):
            IslandWorkflow(algo, Sphere(), **{"n_islands": 4, **kwargs}, device="cpu")
    from evox_tpu_torch.core.distributed import create_mesh

    with pytest.raises(ValueError, match="not divisible"):
        IslandWorkflow(algo, Sphere(), n_islands=2, device="cpu",
                       mesh=create_mesh(devices=["cpu"] * 4))
    meshed = IslandWorkflow(algo, Sphere(), n_islands=4, migrate_every=2, device="cpu",
                            mesh=create_mesh(devices=["cpu"] * 2))
    plain = IslandWorkflow(algo, Sphere(), n_islands=4, migrate_every=2, device="cpu")
    a, b = meshed.run(meshed.init(1), 5).algo, plain.run(plain.init(1), 5).algo
    assert torch.equal(a.population, b.population) and torch.equal(a.velocity, b.velocity)
    for name, value in (("external_problem", True), ("dtype_policy", BF16_STORAGE),
                        ("donate_carries", True)):
        problem = _HostTiedSphere() if name == "external_problem" else Sphere()
        wf = IslandWorkflow(algo, problem, n_islands=2, migrate_every=1, device="cpu",
                            **{name: value})
        assert wf.run(wf.init(0), 3).generation == 3, name
    host = IslandWorkflow(algo, _HostTiedSphere(), n_islands=2, device="cpu")
    assert host.external and host.analysis_targets(host.init(0)) == {}
    wf = IslandWorkflow(algo, Sphere(), n_islands=2, migrate_k=9, migrate_every=1, device="cpu")
    state = wf.init(0)
    # analysis_targets is ported: the steady step and run at one generation
    assert set(wf.analysis_targets(state)) == {"step", "run"}
    with pytest.raises(ValueError, match="migrate_k=9"):
        wf.step(state)  # 9 migrants from a batch of 8
    if not torch.cuda.is_available():  # device=None means cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IslandWorkflow(algo, Sphere(), n_islands=2)


class _HostTiedSphere:
    """The tied Sphere on the host (numpy in, numpy out), for both packages."""

    jittable = False
    fit_dtype = "float32"

    def init(self, key=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        return np.round(np.sum(np.asarray(pop) ** 2, axis=1) / 4.0).astype(np.float32), state


class _JaxHostTiedSphere(_HostTiedSphere, JaxProblem):
    pass


def _bits(x):
    """A leaf as comparable numpy: bfloat16 as its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _route_pso_draws(twf, tstate, jstate, pop):
    table = {}
    for i, t in enumerate(unstack_states(tstate.algo)):
        _, k1, k2 = jax.random.split(jstate.algo.key[i], 3)
        table[split_seed(t.seed)[1]] = (_t(jax.random.uniform(k1, (pop, DIM))),
                                        _t(jax.random.uniform(k2, (pop, DIM))))
    twf.algorithm._draw = lambda seed: table[seed]


@pytest.mark.parametrize("kwargs", [{"external_problem": True},
                                    {"dtype_policy": "bf16", "donate_carries": True}],
                         ids=["host_problem", "bf16_donated"])
def test_a5_arguments_match_jax(kwargs):
    """4 PSO islands of 8 with migration every 2 through three generations,
    against the JAX package's ``IslandWorkflow`` with the same arguments,
    every island leaf exactly: a host problem evaluated over the flattened
    batch (the JAX package through ``pure_callback``), and bf16 storage
    with donated carries (the leaves compared as bfloat16 bit patterns)."""
    from evox_tpu.core.dtype_policy import BF16_STORAGE as JAX_BF16

    lb, ub = -4 * np.ones(DIM, np.float32), 4 * np.ones(DIM, np.float32)
    bf16 = kwargs.get("dtype_policy") == "bf16"
    jkw = dict(kwargs, dtype_policy=JAX_BF16) if bf16 else dict(kwargs)
    tkw = dict(kwargs, dtype_policy=BF16_STORAGE) if bf16 else dict(kwargs)
    host = "external_problem" in kwargs
    common = dict(n_islands=4, migrate_every=2, migrate_k=2)
    jwf = JaxIslandWorkflow(JaxPSO(lb=lb, ub=ub, pop_size=8),
                            _JaxHostTiedSphere() if host else _JaxTiedSphere(),
                            use_topk_kernel=True, topk_interpret=True, **common, **jkw)
    twf = IslandWorkflow(PSO(lb, ub, 8, device="cpu"),
                         _HostTiedSphere() if host else _TiedSphere(), device="cpu",
                         **common, **tkw)
    key = jax.random.PRNGKey(6)
    jstate = jwf.init(key)
    # the port starts from JAX's float32 init, cast to storage by its own policy
    plain = JaxIslandWorkflow(JaxPSO(lb=lb, ub=ub, pop_size=8), _JaxTiedSphere(), **common)
    tstate = apply_storage(interop.island_workflow_state(twf, _np(plain.init(key)), seed=1),
                           twf.dtype_policy)
    for gen in range(3):
        _route_pso_draws(twf, tstate, jstate, 8)
        jstate, tstate = jwf.step(jstate), twf.step(tstate)
        assert tstate.generation == int(jstate.generation)
        for i, t in enumerate(unstack_states(tstate.algo)):
            for f in dataclasses.fields(t):
                if hasattr(jstate.algo, f.name):
                    want = _bits(np.asarray(getattr(jstate.algo, f.name))[i])
                    np.testing.assert_array_equal(_bits(getattr(t, f.name)), want,
                                                  err_msg=f"generation {gen + 1}, {f.name}")
    if bf16:
        assert tstate.algo.population.dtype == torch.bfloat16
    else:
        assert twf.host_link.counts["d2h"] == 3  # one flattened batch a generation


def test_checkpointed_island_run_resumes_bit_for_bit(tmp_path):
    """``run(checkpointer=WorkflowCheckpointer(every=4, keep=3))`` for 16
    generations equals the straight run; after a crash at generation 12 (the
    newest snapshot dropped) a fresh workflow's ``run(resume_from=)`` to the
    same total restores generation 8 and finishes bit for bit; a snapshot of
    another island count is refused by the config guard."""
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    def make(n_islands=3):
        return IslandWorkflow(PSO(-4 * np.ones(DIM), 4 * np.ones(DIM), 8, device="cpu"),
                              _TiedSphere(), n_islands=n_islands, migrate_every=3, migrate_k=2,
                              device="cpu")

    wf = make()
    straight = wf.run(wf.init(5), 16)
    ckpt = WorkflowCheckpointer(str(tmp_path / "isl"), every=4, keep=3)
    saved = wf.run(wf.init(5), 16, checkpointer=ckpt)
    _assert_same_islands(saved, straight)
    assert [p.name for p in ckpt.snapshots()] == [f"ckpt_{g:08d}.pkl" for g in (8, 12, 16)]
    for path in tmp_path.joinpath("isl").glob("ckpt_00000012*"):
        path.unlink()
    for path in tmp_path.joinpath("isl").glob("ckpt_00000016*"):
        path.unlink()
    fresh = make()
    resumed = fresh.run(fresh.init(5), 16, resume_from=str(tmp_path / "isl"))
    _assert_same_islands(resumed, straight)
    with pytest.raises(Exception, match="config|island|shape|mismatch"):
        other = make(4)
        other.run(other.init(5), 16, resume_from=str(tmp_path / "isl"))


def _assert_same_islands(a, b):
    assert a.generation == b.generation and n_members(a.algo) == n_members(b.algo)
    for x, y in zip(unstack_states(a.algo), unstack_states(b.algo)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, torch.Tensor):
                assert torch.equal(u, v), f.name
            else:
                assert u == v, f.name


def test_islands_converge_on_sphere():
    algo = PSO(-10 * np.ones(4), 10 * np.ones(4), 24, device="cpu")
    wf = IslandWorkflow(algo, Sphere(), n_islands=4, migrate_every=5, migrate_k=2, device="cpu")
    state = wf.run(wf.init(0), 60)
    per_island, best = wf.best(state)
    assert per_island.shape == (4,)
    assert float(best) < 1e-2, float(best)
