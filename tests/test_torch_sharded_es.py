"""The POP-sharded low-memory ES (``ShardedES``, ``core/distributed.py``)
and its protocol on ``SepCMAES``, ``LMMAES`` and ``RMES``, on an 8-shard
CPU mesh, against the JAX package's ``ShardedES`` on its 8 virtual
devices; and OpenES's ``lr_scale``.

The laws are ``tests/test_large_pop.py:154-201``'s: the sharded run
equals its replicated twin (``mesh=None, n_shards=8``: the same samples
bit for bit, the states within rtol 1e-4, atol 1e-4, the JAX package's
sharded-against-replicated tolerance: the two tells sum in different
orders), a run equals the step loop, and without a mesh at one shard the
wrapper is the bare algorithm bit for bit. Against JAX the sharded port
takes JAX's per-shard draws through the one ``_draw`` (in shard order) and
is held at the same tolerance: the port's psum adds the shards in mesh
order, XLA in its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu import ShardedES as JaxShardedES
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu import create_mesh as jax_create_mesh
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.algorithms.so.es import SepCMAES as JaxSepCMAES
from evox_tpu.algorithms.so.es.common import weights_at_ranks as jax_weights_at_ranks
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.es import LMMAES, RMES, OpenES, SepCMAES
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core.distributed import ShardedES, ShardedTensor, create_mesh, global_ranks
from evox_tpu_torch.problems.numerical import Sphere

N_DEV, DIM, POP = 8, 16, 512
RTOL = ATOL = 1e-4


def _port_wf(cls, mesh, n_shards=None, dim=DIM, pop=POP):
    algo = ShardedES(cls(torch.full((dim,), 2.0), 1.0, pop_size=pop, device="cpu"), mesh=mesh,
                     n_shards=n_shards)
    return StdWorkflow(algo, Sphere(), device="cpu")


def _whole(x):
    """A resident leaf gathered (the samples of a sharded run live on their
    shards); any other leaf as it is."""
    return x.gather() if isinstance(x, ShardedTensor) else x


def _close(a, b, fields=("mean", "sigma", "C")):
    for f in fields:
        np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_sharded_trajectory_matches_replicated():
    sh = _port_wf(SepCMAES, create_mesh(devices=["cpu"] * N_DEV))
    rp = _port_wf(SepCMAES, None, n_shards=N_DEV)
    a, b = sh.init(2), rp.init(2)
    for _ in range(10):
        a, b = sh.step(a), rp.step(b)
        assert torch.equal(_whole(a.algo.z), b.algo.z)  # the same sampling law
    _close(a.algo, b.algo)


@pytest.mark.parametrize("cls", [LMMAES, RMES])
def test_protocol_of_lmmaes_and_rmes(cls):
    """One generation of each, sharded against replicated: the same first
    samples, the states within the tolerance."""
    sh = _port_wf(cls, create_mesh(devices=["cpu"] * 4), dim=8, pop=64)
    rp = _port_wf(cls, None, n_shards=4, dim=8, pop=64)
    a, b = sh.step(sh.init(1)), rp.step(rp.init(1))
    assert torch.equal(_whole(a.algo.z), b.algo.z)
    _close(a.algo, b.algo, fields=("mean", "sigma", "ps" if cls is LMMAES else "pc"))


def test_sharded_fused_run_matches_step_loop():
    wf = _port_wf(SepCMAES, create_mesh(devices=["cpu"] * N_DEV), dim=8, pop=64)
    s_loop = wf.init(3)
    for _ in range(6):
        s_loop = wf.step(s_loop)
    s_run = wf.run(wf.init(3), 6)
    for f in ("mean", "sigma", "C", "ps", "pc", "z"):
        assert torch.equal(_whole(getattr(s_loop.algo, f)), _whole(getattr(s_run.algo, f))), f


def test_sharded_wrapper_identity_without_mesh():
    algo = RMES(torch.full((6,), 1.0), 0.7, pop_size=16, device="cpu")
    wrapped = ShardedES(algo, mesh=None, n_shards=1)
    s1, s2 = algo.init(9), wrapped.init(9)
    p1, s1 = algo.ask(s1)
    p2, s2 = wrapped.ask(s2)
    assert torch.equal(p1, p2)
    f = (p1 ** 2).sum(1)
    s1, s2 = algo.tell(s1, f), wrapped.tell(s2, f)
    for name in ("mean", "sigma", "pc", "P", "z"):
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name


def test_sharded_rejects_unsupported():
    with pytest.raises(TypeError, match="protocol"):
        ShardedES(PSO(-torch.ones(4), torch.ones(4), pop_size=8, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        ShardedES(SepCMAES(torch.zeros(4), 1.0, pop_size=10, device="cpu"), mesh=None,
                  n_shards=8)
    with pytest.raises(ValueError, match="multiple"):
        ShardedES(SepCMAES(torch.zeros(4), 1.0, pop_size=24, device="cpu"),
                  mesh=create_mesh(devices=["cpu"] * 4), n_shards=6)


def test_ranks_and_rank_weights_match_jax():
    rng = np.random.default_rng(5)
    fit = np.round(rng.random(64) * 10).astype(np.float32)  # ties: ranks break by index
    order, ranks = global_ranks(torch.from_numpy(fit))
    j_order = np.asarray(jnp.argsort(jnp.asarray(fit), stable=True))
    np.testing.assert_array_equal(order.numpy(), j_order)
    algo = SepCMAES(torch.zeros(4), 1.0, pop_size=64, device="cpu")
    jalgo = JaxSepCMAES(jnp.zeros(4), 1.0, pop_size=64)
    w = algo.rank_weights(ranks)
    # the lookup is exact: the sorted candidates carry the weight table
    assert torch.equal(w[order[:algo.mu]], algo.weights)
    assert torch.equal(w[order[algo.mu:]], torch.zeros(64 - algo.mu))
    # JAX's table differs in the last bits of some weights (its log1p form)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jax_weights_at_ranks(jalgo.weights, jnp.asarray(ranks.numpy()),
                                                   jalgo.mu)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("sharded", [True, False], ids=["mesh", "replicated"])
def test_matches_jax_sharded_es(sharded):
    """10 generations of the JAX package's ``ShardedES(SepCMAES)`` on its
    8-device mesh (or ``mesh=None, n_shards=8``) and the port's, JAX's
    draws handed to the port shard by shard: the samples bit for bit and
    the strategy within rtol 1e-4, atol 1e-4 every generation."""
    jmesh = jax_create_mesh(devices=jax.devices()[:N_DEV]) if sharded else None
    jalgo = JaxShardedES(JaxSepCMAES(center_init=jnp.full(DIM, 2.0), init_stdev=1.0,
                                     pop_size=POP), mesh=jmesh, n_shards=N_DEV)
    jwf = JaxStdWorkflow(jalgo, JaxSphere(), mesh=jmesh)
    wf = _port_wf(SepCMAES, create_mesh(devices=["cpu"] * N_DEV) if sharded else None,
                  n_shards=N_DEV)
    blocks = []
    wf.algorithm.algorithm._draw = lambda seed, rows=None: blocks.pop(0)
    js, ts = jwf.init(jax.random.PRNGKey(7)), wf.init(7)
    for _ in range(10):
        js = jwf.step(js)
        z = np.asarray(js.algo.z)
        blocks.extend(torch.from_numpy(b.copy()) for b in np.split(z, N_DEV))
        ts = wf.step(ts)
        assert not blocks
        np.testing.assert_array_equal(_whole(ts.algo.z).numpy(), z)
        _close(ts.algo, js.algo, fields=("mean", "sigma", "C", "ps", "pc"))


def test_openes_lr_scale_matches_jax():
    """``lr_scale`` multiplies the optimizer's updates, as in the JAX
    package (JAX's noise handed to the port); at 1.0 the update is the
    unscaled one bit for bit."""
    dim, pop = 6, 8
    jalgo = JaxOpenES(jnp.zeros(dim), pop)
    jalgo.lr_scale = 0.5
    jstate = jalgo.init(jax.random.PRNGKey(3))
    jpop, jstate = jalgo.ask(jstate)
    fit = jnp.sum(jpop ** 2, axis=1)
    jnext = jalgo.tell(jstate, fit)
    half = np.asarray(jax.random.normal(jstate.noise_key, (pop // 2, dim)))
    algo = OpenES(torch.zeros(dim), pop, device="cpu")
    algo._draw_noise = lambda seed: torch.from_numpy(half.copy())
    state = algo.init(3)
    fitness = torch.from_numpy(np.array(fit))
    base = algo.tell(state, fitness)
    algo.lr_scale = 0.5
    scaled = algo.tell(state, fitness)
    np.testing.assert_allclose(scaled.center.numpy(), np.asarray(jnext.center), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(scaled.center, base.center * 0.5)  # the center starts at zero
