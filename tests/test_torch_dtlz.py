"""The port's DTLZ suite and samplers against the JAX package, on the CPU.

DTLZ1-7 objectives and true fronts, grid and Latin hypercube sampling:
the same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``evox_tpu_torch`` (``device="cpu"``), with the
tolerance stated at each test. JAX's draws are handed to
``latin_hypercube``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.operators.sampling import GridSampling as JaxGridSampling
from evox_tpu.operators.sampling import latin_hypercube as jax_latin_hypercube
from evox_tpu.problems import numerical as jnum
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.operators.sampling import GridSampling, LatinHypercubeSampling, latin_hypercube
from evox_tpu_torch.problems import numerical as tnum

NAMES = [f"DTLZ{i}" for i in range(1, 8)]
# objectives: float32 cascades of cos/sin (DTLZ2-6), DTLZ1's and DTLZ3's g
# (100 x a sum of cosines of 20 pi x), powers and means, each library with
# its own transcendental functions and sum orders: ~1e-6 relative
OBJ_RTOL, OBJ_ATOL = 1e-5, 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("m", [2, 3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_dtlz_objectives_match_jax(name, m):
    """Each problem at its default d for m objectives, on 64 points of the
    unit box with the corners and the centre among them."""
    jp, tp = getattr(jnum, name)(m=m), getattr(tnum, name)(m=m, device="cpu")
    assert tp.d == jp.d
    pop = np.random.default_rng(m).random((64, tp.d)).astype(np.float32)
    pop[0], pop[1], pop[2] = 0.0, 1.0, 0.5
    want, _ = jp.evaluate(None, jnp.asarray(pop))
    got, state = tp.evaluate("state", _t(pop))
    assert state == "state" and got.shape == (64, m) == tp.fit_shape(64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=OBJ_RTOL, atol=OBJ_ATOL)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_dtlz_fronts_match_jax(name, m):
    """The true fronts: Das-Dennis weights scaled (DTLZ1) or normalised
    (DTLZ2-4) to 1e-6 relative; DTLZ5-6's lifted curve from linspace to one
    ulp; DTLZ7's non-dominated grid points: the same points (the sort
    through the dominance kernel's plain version on the CPU, no launch)."""
    jp, tp = getattr(jnum, name)(m=m), getattr(tnum, name)(m=m, device="cpu")
    launches = tdom.packed_dominance.launches
    got, want = tp.pf().numpy(), _np(jp.pf())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tdom.packed_dominance.launches == launches


def test_dtlz4_alpha_and_dtlz7_default_width():
    jp, tp = jnum.DTLZ4(m=3, alpha=2.0), tnum.DTLZ4(m=3, alpha=2.0, device="cpu")
    pop = np.random.default_rng(4).random((16, 7)).astype(np.float32)
    np.testing.assert_allclose(tp.evaluate(None, _t(pop))[0].numpy(),
                               _np(jp.evaluate(None, jnp.asarray(pop))[0]), rtol=OBJ_RTOL, atol=OBJ_ATOL)
    assert tnum.DTLZ7(m=3, device="cpu").d == jnum.DTLZ7(m=3).d == 22
    assert tnum.DTLZ2(m=3, device="cpu").d == 7


@pytest.mark.parametrize("n,d", [(5, 2), (3, 3), (4, 1)])
def test_grid_sampling_matches_jax(n, d):
    """The grid's points in the same order, to one ulp of the linspace."""
    np.testing.assert_allclose(GridSampling(n, d, device="cpu")().numpy(),
                               _np(JaxGridSampling(n, d)()), rtol=0, atol=6e-8)


@pytest.mark.parametrize("smooth", [True, False])
def test_latin_hypercube_with_jax_draws(smooth):
    """With JAX's permutations and offsets handed over: exact (one add and
    one division of the same numbers). Drawn by the port: one point in
    every stratum of every axis."""
    key = jax.random.PRNGKey(3)
    n, d = 20, 4
    k1, k2 = jax.random.split(key)
    perms = _np(jax.vmap(lambda k: jax.random.permutation(k, n))(jax.random.split(k1, d)).T)
    offset = _np(jax.random.uniform(k2, (n, d)))
    want = _np(jax_latin_hypercube(key, n, d, smooth))
    got = latin_hypercube(0, n, d, smooth, device="cpu", perms=_t(perms), offset=_t(offset))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = LatinHypercubeSampling(n, d, smooth, device="cpu")(7)
    assert drawn.shape == (n, d)
    strata = torch.floor(drawn * n).to(torch.int64)
    for j in range(d):
        assert sorted(strata[:, j].tolist()) == list(range(n))
