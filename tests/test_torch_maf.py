"""The port's MaF suite and simple crossovers against the JAX package, on
the CPU.

MaF1-15 objectives at m 3 and 5 (each at its default d, on points of its
own box with both corners), their bounds and true fronts (at a small
``ref_num``: the WFG members fit a 10001-point grid to every reference
direction on the host), the WFG transformations and the polygon helpers;
one-point and uniform crossover on JAX's draws. Tolerances are stated at
each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.operators.crossover import simple as jsimple
from evox_tpu.problems.numerical import maf as jmaf
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.operators import crossover as tcross
from evox_tpu_torch.problems import numerical as tnum
from evox_tpu_torch.problems.numerical import maf as tmaf

NAMES = [f"MaF{i}" for i in range(1, 16)]
# objectives: cos/sin cascades near their zeros (relative error grows where
# a factor vanishes), MaF5's x^100, the WFG members' chains of x^0.02 and
# MaF3/4's g (100 x a sum of cosines), each library with its own
# transcendental functions and sum orders: up to ~3e-5 relative measured
OBJ_RTOL, OBJ_ATOL = 1e-4, 1e-5
# fronts: Das-Dennis points normalised, powers of sqrt(2), float64 fronts
# rounded to float32: a few ulps
PF_RTOL, PF_ATOL = 1e-6, 2e-6
REF_NUM = 30


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(name, m):
    return (getattr(jmaf, name)(m=m, ref_num=REF_NUM),
            getattr(tnum, name)(m=m, ref_num=REF_NUM, device="cpu"))


@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_maf_objectives_and_bounds_match_jax(name, m):
    jp, tp = _pair(name, m)
    assert tp.d == jp.d and tp.fit_shape(7) == (7, tp.m) and tp.m == jp.m
    lb, ub = (_np(b) for b in jp.bounds())
    for got, want in zip(tp.bounds(), (lb, ub)):
        np.testing.assert_array_equal(got.numpy(), want)
    pop = (np.random.default_rng(m).random((64, jp.d)) * (ub - lb) + lb).astype(np.float32)
    pop[0], pop[1] = lb, ub
    want, _ = jp.evaluate(None, jnp.asarray(pop))
    got, state = tp.evaluate("state", _t(pop))
    assert state == "state" and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=OBJ_RTOL, atol=OBJ_ATOL)


@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_maf_fronts_match_jax(name, m):
    """The true fronts: the same points (MaF11's non-dominated filter
    through the dominance kernel's plain version on the CPU: no launch)."""
    jp, tp = _pair(name, m)
    launches = tdom.packed_dominance.launches
    got, want = tp.pf().numpy(), _np(jp.pf())
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=PF_RTOL, atol=PF_ATOL)
    assert tdom.packed_dominance.launches == launches


def test_wfg_transformations_and_polygon_helpers_match_jax():
    """``b_flat`` exactly (floor, products and a rounding to 1e-4 on the same
    float32 steps), the rest within 1e-6; ray casting and the polygon test
    exactly, vertices and edges included."""
    rng = np.random.default_rng(0)
    y = rng.random((50, 6)).astype(np.float32)
    y[0, :3] = [0.75, 0.85, 0.35]
    np.testing.assert_array_equal(tmaf.b_flat(_t(y), 0.8, 0.75, 0.85).numpy(),
                                  _np(jmaf.b_flat(jnp.asarray(y), 0.8, 0.75, 0.85)))
    for t_fn, j_fn, args in ((tmaf.s_linear, jmaf.s_linear, (0.35,)),
                             (tmaf.s_decept, jmaf.s_decept, (0.35, 0.001, 0.05)),
                             (tmaf.s_multi, jmaf.s_multi, (30, 95, 0.35)),
                             (tmaf.r_nonsep, jmaf.r_nonsep, (3,))):
        np.testing.assert_allclose(t_fn(_t(y), *args).numpy(), _np(j_fn(jnp.asarray(y), *args)),
                                   rtol=1e-6, atol=1e-6)
    w = np.arange(1, 7, dtype=np.float32)
    np.testing.assert_allclose(tmaf.r_sum(_t(y), _t(w)).numpy(), _np(jmaf.r_sum(jnp.asarray(y), w)),
                               rtol=1e-6)
    poly = _np(jmaf._polygon_vertices(5))
    pts = np.concatenate([rng.random((200, 2)) * 2.4 - 1.2, poly, (poly[:2] + poly[1:3]) / 2])
    pts = pts.astype(np.float32)
    want = _np(jax.vmap(jmaf.point_in_polygon, in_axes=(None, 0))(jnp.asarray(poly), jnp.asarray(pts)))
    got = tmaf.point_in_polygon(_t(poly), _t(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    seg = (jnp.asarray([0.0, -1.0]), jnp.asarray([0.5, 1.0]))
    for p in pts[:20]:
        assert bool(tmaf.ray_intersect_segment(_t(p), _t(seg[0]), _t(seg[1]))) == bool(
            jmaf.ray_intersect_segment(jnp.asarray(p), *seg))


def test_maf_entry_points_on_the_default_device(monkeypatch):
    """``device=None`` means cuda: without a card each member refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in NAMES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tnum, name)(m=3)


@pytest.mark.parametrize("n", [8, 9])
def test_simple_crossovers_match_jax(n):
    """One-point and uniform crossover over consecutive pairs (an odd last
    row passes through) on JAX's draws: exact (selections only)."""
    pop = np.random.default_rng(n).random((n, 6)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    point = jax.random.randint(key, (n // 2, 1), 1, 6)
    np.testing.assert_array_equal(tcross.one_point(0, _t(pop), point=_t(point)).numpy(),
                                  _np(jsimple.one_point(key, jnp.asarray(pop))))
    mask = jax.random.bernoulli(key, 0.5, (n // 2, 6))
    np.testing.assert_array_equal(tcross.uniform_rand_cross(0, _t(pop), mask=_t(mask)).numpy(),
                                  _np(jsimple.uniform_rand_cross(key, jnp.asarray(pop))))
    for op in (tcross.OnePoint(), tcross.UniformRand()):
        out = op(3, _t(pop))
        assert out.shape == pop.shape
        # every child gene comes from one of its two parents, at the same column
        half = n // 2
        pairs = torch.stack([_t(pop[0:2 * half:2]), _t(pop[1:2 * half:2])])
        assert bool(((out[0:2 * half:2] == pairs[0]) | (out[0:2 * half:2] == pairs[1])).all())
        if n % 2:
            assert torch.equal(out[-1], _t(pop[-1]))
