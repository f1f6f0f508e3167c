"""The port's bf16 storage policy (``core/dtype_policy.py``, the storage
annotations of every state, ``StdWorkflow(dtype_policy=,
donate_carries=)``) against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
import evox_tpu.algorithms.mo as jmo
import evox_tpu.algorithms.so.de as jde
import evox_tpu.algorithms.so.es as jes
import evox_tpu.algorithms.so.pso as jpso
import evox_tpu_torch.algorithms.mo as tmo
import evox_tpu_torch.algorithms.so.de as tde
import evox_tpu_torch.algorithms.so.es as tes
import evox_tpu_torch.algorithms.so.pso as tpso
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.core.dtype_policy import BF16_STORAGE as JAX_BF16
from evox_tpu.core.dtype_policy import apply_compute as jax_apply_compute
from evox_tpu.core.dtype_policy import apply_storage as jax_apply_storage
from evox_tpu.core.dtype_policy import storage_eligible_fields as jax_eligible
from evox_tpu.core.guardrail import GuardedAlgorithm as JaxGuarded
from evox_tpu.problems.numerical import Ackley as JaxAckley
from evox_tpu_torch import GuardedAlgorithm, StdWorkflow, interop
from evox_tpu_torch.core.dtype_policy import (
    BF16_STORAGE,
    DtypePolicy,
    apply_compute,
    apply_storage,
    policy_report,
    storage_eligible_fields,
)
from evox_tpu_torch.core.struct import map_tensors, named_leaves
from evox_tpu_torch.metrics import igd
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import ZDT1, Ackley, Sphere

D = 4
LB, UB = np.zeros(D, np.float32), np.ones(D, np.float32)
CENTER = np.zeros(D, np.float32)
_BOX = dict(lb=LB, ub=UB, pop_size=8)
_ES = dict(center_init=CENTER, init_stdev=1.0, pop_size=8)
_MO = dict(lb=LB, ub=UB, n_objs=2, pop_size=8)

# every algorithm ported in both packages (the ES names without
# init_stdev take the rest of _ES), with the arguments both constructors take
ALGORITHMS = {
    **{name: (jpso, tpso, _BOX) for name in ("PSO", "CSO", "CLPSO", "SLPSOGS", "SLPSOUS", "FIPS",
                                             "SwmmPSO")},
    "DMSPSOEL": (jpso, tpso, dict(_BOX, sub_swarm_size=4)),
    "FSPSO": (jpso, tpso, dict(pop_size=8, dim=D)),
    **{name: (jes, tes, _ES) for name in ("CMAES", "SepCMAES", "IPOPCMAES", "BIPOPCMAES", "MAES",
                                          "LMMAES", "RMES", "XNES", "SeparableNES", "SNES",
                                          "CR_FM_NES", "DES", "AMaLGaM", "IndependentAMaLGaM",
                                          "LES")},
    **{name: (jes, tes, dict(center_init=CENTER, pop_size=8))
       for name in ("OpenES", "PGPE", "ARS", "ASEBO", "GuidedES", "PersistentES", "NoiseReuseES")},
    "ESMC": (jes, tes, dict(center_init=CENTER, pop_size=9)),
    **{name: (jde, tde, _BOX) for name in ("DE", "ODE", "CoDE", "SaDE", "JaDE", "SHADE")},
    **{name: (jmo, tmo, _MO) for name in ("NSGA2", "NSGA3", "MOEAD", "MOEADDRA", "MOEADM2M",
                                          "EAGMOEAD", "RVEA", "RVEAa", "LMOCSO", "TDEA", "GDE3",
                                          "IBEA", "SRA", "BCEIBEA", "SPEA2", "HypE", "KnEA",
                                          "BiGE")},
}


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_storage_annotations_match_jax(name):
    jmod, tmod, kwargs = ALGORITHMS[name]
    want = jax_eligible(getattr(jmod, name)(**kwargs).init(jax.random.PRNGKey(0)))
    got = storage_eligible_fields(getattr(tmod, name)(**kwargs, device="cpu").init(0))
    assert got == want


def test_guarded_state_annotations_match_jax():
    want = jax_eligible(JaxGuarded(jes.CMAES(**_ES)).init(jax.random.PRNGKey(0)))
    got = storage_eligible_fields(GuardedAlgorithm(tes.CMAES(**_ES, device="cpu")).init(0))
    assert got == want and got["pop"] is True and got["inner.z"] is True


def _special_values(shape, seed):
    """float32 values that exercise the cast to bfloat16: ties at the
    halfway point (round to nearest even both ways), just off a tie,
    float32 and bfloat16 subnormals, ±0, ±inf, NaN, and random values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0).astype(np.float32)
    bits = np.array([
        0x3F808000,  # 1 + 2^-8: halfway, rounds down to 1.0 (even)
        0x3F818000,  # 1 + 3 * 2^-8: halfway, rounds up to the even 1 + 2^-6
        0x3F808001,  # just above the tie: up
        0x3F807FFF,  # just below the tie: down
        0xBF818000,  # the negative tie
        0x00000001,  # the smallest float32 subnormal
        0x00400000,  # a float32 subnormal
        0x00018000,  # a bfloat16 subnormal tie
        0x007FFFFF,  # the largest subnormal: rounds to the smallest normal
        0x7F7FFFFF,  # the largest float32: rounds to inf
        0x00000000, 0x80000000,  # +0, -0
        0x7F800000, 0xFF800000,  # +inf, -inf
        0x7FC00000, 0xFFC00000,  # NaN, -NaN
        0x7F800001,  # a signalling NaN: quiet NaN, not inf
    ], dtype=np.uint32).view(np.float32)
    flat = x.reshape(-1)
    flat[: bits.size] = bits
    return x


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def test_apply_storage_and_compute_match_jax_bit_for_bit():
    pop, dim = 24, 4
    jalgo = jpso.CSO(-np.ones(dim), np.ones(dim), pop)
    talgo = tpso.CSO(-np.ones(dim), np.ones(dim), pop, device="cpu")
    values = {"population": _special_values((pop, dim), 0), "fitness": _special_values((pop,), 1),
              "velocity": _special_values((pop, dim), 2)}
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(
        **{k: jnp.asarray(v) for k, v in values.items()})
    tstate = talgo.init(0).replace(**{k: torch.from_numpy(v.copy()) for k, v in values.items()})
    jnarrow = jax_apply_storage(jstate, JAX_BF16)
    tnarrow = apply_storage(tstate, BF16_STORAGE)
    for name in values:
        got = getattr(tnarrow, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(interop.numpy_fields(got)),
                                      _bits(np.asarray(getattr(jnarrow, name))), err_msg=name)
        # and back to float32: exact on both sides
        jwide, twide = jax_apply_compute(jnarrow, JAX_BF16), apply_compute(tnarrow, BF16_STORAGE)
        np.testing.assert_array_equal(_bits(getattr(twide, name)),
                                      _bits(np.asarray(getattr(jwide, name))), err_msg=name)
    assert tnarrow.seed == tstate.seed  # the seed is never cast


def test_integer_bool_and_seed_leaves_are_never_cast():
    algo = tmo.KnEA(**_MO, device="cpu")  # knee (bool) and rank (int32) are annotated
    state = apply_storage(algo.init(0), BF16_STORAGE)
    assert state.knee.dtype == torch.bool and state.rank.dtype == torch.int32
    assert state.population.dtype == torch.bfloat16 and isinstance(state.seed, int)
    nsga2 = apply_storage(tmo.NSGA2(**_MO, device="cpu").init(0), BF16_STORAGE)
    assert nsga2.rank.dtype == torch.int32 and nsga2.crowd.dtype == torch.bfloat16
    dms = apply_storage(tpso.DMSPSOEL(**_BOX, sub_swarm_size=4, device="cpu").init(0), BF16_STORAGE)
    assert dms.swarm_of.dtype in (torch.int32, torch.int64) and dms.pbest.dtype == torch.bfloat16
    # an unannotated float leaf stays float32, and storage=False opts out
    de = apply_storage(tde.DE(**_BOX, device="cpu").init(0), BF16_STORAGE)
    assert de.attrib.improvement.dtype == torch.float32 and de.trials.dtype == torch.bfloat16


def test_policy_none_returns_the_same_object():
    state = tpso.CSO(-np.ones(3), np.ones(3), 4, device="cpu").init(0)
    assert apply_storage(state, None) is state and apply_compute(state, None) is state
    noop = DtypePolicy(torch.float32, torch.float32)
    assert noop.is_noop and apply_storage(state, noop) is state
    sentinel = object()  # no walk: not even an unwalkable object is looked at
    assert apply_storage(sentinel, None) is sentinel
    wf = StdWorkflow(tpso.CSO(-np.ones(3), np.ones(3), 4, device="cpu"), Sphere(), device="cpu")
    assert policy_report(wf) == {"storage": "float32", "compute": "float32", "active": False}
    assert BF16_STORAGE.report() == {"storage": "bfloat16", "compute": "float32", "active": True}
    with pytest.raises(ValueError, match="floating"):
        DtypePolicy(torch.int32, torch.float32)


def _ulps(a, b):
    """bfloat16 distance in units in the last place (same-sign values)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return (ia - ib).abs()


def test_bf16_cso_step_matches_jax():
    """One bf16 CSO generation from one bf16 state, JAX's pairing and
    uniforms handed to the port. Positions and velocities are elementwise
    float32 arithmetic on the same inputs; the fitness is Ackley's, whose
    sums the two libraries add in different orders, and the cast of a
    float32 that differs by an ulp can land on either side of a bf16
    rounding boundary: every bf16 leaf within 1 bf16 ulp."""
    pop, dim = 16, 6
    lb, ub = -np.full(dim, 32.0, np.float32), np.full(dim, 32.0, np.float32)
    jalgo = jpso.CSO(lb, ub, pop)
    jwf = JaxStdWorkflow(jalgo, JaxAckley(), dtype_policy=JAX_BF16)
    js1 = jwf.step(jwf.init(jax.random.PRNGKey(4)))
    assert js1.algo.population.dtype == jnp.bfloat16
    _, asked = jalgo.ask(jax_apply_compute(js1, JAX_BF16).algo)
    k_pair, k1, k2, k3 = jax.random.split(asked.pair_key, 4)
    draws = (jax.random.permutation(k_pair, pop),
             *(jax.random.uniform(k, (pop // 2, dim)) for k in (k1, k2, k3)))
    js2 = jwf.step(js1)

    talgo = tpso.CSO(lb, ub, pop, device="cpu")
    twf = StdWorkflow(talgo, Ackley(), device="cpu", dtype_policy=BF16_STORAGE)
    ts1 = interop.std_workflow_state(twf, jax.tree.map(np.asarray, js1))
    for name in ("population", "fitness", "velocity"):  # crossed bit for bit
        np.testing.assert_array_equal(_bits(interop.numpy_fields(getattr(ts1.algo, name))),
                                      _bits(np.asarray(getattr(js1.algo, name))))
    talgo._draw = lambda seed: tuple(torch.as_tensor(np.array(a)) for a in draws)
    ts2 = twf.step(ts1)
    assert ts2.generation == int(js2.generation) == 2
    for name in ("population", "fitness", "velocity"):
        got = getattr(ts2.algo, name)
        assert got.dtype == torch.bfloat16, name
        want = torch.from_numpy(np.array(getattr(js2.algo, name)).view(np.int16)).view(torch.bfloat16)
        assert int(_ulps(got, want).max()) <= 1, name


def _best_after(algo, steps, seed=17):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, Sphere(), monitors=(mon,), dtype_policy=BF16_STORAGE, device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


def test_bf16_cmaes_sphere_convergence():
    algo = tes.CMAES(center_init=np.full(5, -3.0), init_stdev=1.0, pop_size=32, device="cpu")
    assert _best_after(algo, 200) < 0.01


def test_bf16_cso_sphere_convergence():
    algo = tpso.CSO(lb=-5.0 * np.ones(10), ub=5.0 * np.ones(10), pop_size=64, device="cpu")
    assert _best_after(algo, 200) < 0.1


def test_bf16_nsga2_zdt1_igd():
    d = 12
    wf = StdWorkflow(tmo.NSGA2(np.zeros(d), np.ones(d), n_objs=2, pop_size=100, device="cpu"),
                     ZDT1(n_dim=d, device="cpu"), dtype_policy=BF16_STORAGE, device="cpu")
    state = wf.run(wf.init(3), 100)
    assert state.algo.fitness.dtype == torch.bfloat16
    fit = state.algo.fitness.float()
    fit = torch.where(torch.isfinite(fit).all(1, keepdim=True), fit, torch.full_like(fit, 1e6))
    # the JAX package's gate: twice the float32 suite's 0.1, since bf16
    # storage quantizes the carried objectives
    assert float(igd(fit, ZDT1(n_dim=d, device="cpu").pf())) < 0.2


def test_cmaes_strategy_parameters_stay_float32():
    wf = StdWorkflow(tes.CMAES(np.full(6, 1.0), 1.0, pop_size=8, device="cpu"), Sphere(),
                     dtype_policy=BF16_STORAGE, device="cpu")
    state = wf.run(wf.init(0), 3)
    s = state.algo
    assert s.z.dtype == torch.bfloat16
    for name in ("mean", "C", "B", "D", "pc", "ps"):
        assert getattr(s, name).dtype == torch.float32, name
    assert torch.is_tensor(s.sigma) is False or s.sigma.dtype == torch.float32


def _snapshot(state):
    return map_tensors(lambda t: t.clone(), state)


def _assert_bits_equal(a, b):
    ta, tb = ([leaf for _, leaf in named_leaves(s) if isinstance(leaf, torch.Tensor)] for s in (a, b))
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x.view(-1).view(torch.uint8) if x.numel() else x,
                                                  y.view(-1).view(torch.uint8) if y.numel() else y)


@pytest.mark.parametrize("policy", [None, BF16_STORAGE], ids=["f32", "bf16"])
def test_donate_carries_changes_nothing(policy):
    """``donate_carries`` is accepted and changes nothing: the same states
    bit for bit with and without it, and ``run`` never writes into the
    caller's state."""
    def make(donate):
        algo = tpso.CSO(-5 * np.ones(6), 5 * np.ones(6), 16, device="cpu")
        return StdWorkflow(algo, Ackley(), dtype_policy=policy, donate_carries=donate, device="cpu")

    plain, donating = make(False), make(True)
    assert donating.donate_carries and not plain.donate_carries
    start = plain.step(plain.init(5))
    before = _snapshot(start)
    a = plain.run(start, 6)
    b = donating.run(start, 6)
    _assert_bits_equal(a, b)
    _assert_bits_equal(start, before)  # the caller's state is untouched
