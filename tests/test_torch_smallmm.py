"""Kernel M1 (``evox_tpu_torch/kernels/smallmm.py``), the batch-invariant
float32 product that CMA-ES's products go through on the card, on the CPU
through its plain version: against ``jnp.matmul`` on the same numpy inputs
(M1 sums each element over ``k`` in one fixed order, XLA in its own; held
at rtol 1e-5, atol 1e-5: an element near 0 after cancellation differs by a
few 1e-6 absolute), every transpose form, a member of a batch of 64 equal
bit for bit to the same member in a batch of 1, and the custom op's vmap
rule equal to the stacked calls. The kernel itself is held against this
plain version, bit for bit, by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu_torch.algorithms.so.es.cma_es import _norm, _product
from evox_tpu_torch.kernels import smallmm as km

# two float32 summation orders of up to 33 products of unit normals: an
# element near 0 after cancellation differs by a few 1e-6 absolute
RTOL, ATOL = 1e-5, 1e-5


def _operands(b, p, k, q, trans_a, trans_b, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b,) + ((k, p) if trans_a else (p, k))).astype(np.float32)
    bb = rng.standard_normal((b,) + ((q, k) if trans_b else (k, q))).astype(np.float32)
    return a, bb


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_plain_matches_jax_matmul(trans_a, trans_b):
    a, b = _operands(3, 17, 33, 5, trans_a, trans_b)
    want = jnp.matmul(jnp.swapaxes(a, -1, -2) if trans_a else a,
                      jnp.swapaxes(b, -1, -2) if trans_b else b)
    got = km.smallmm(torch.from_numpy(a), torch.from_numpy(b), trans_a, trans_b, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    two_d = km.smallmm(torch.from_numpy(a[1]), torch.from_numpy(b[1]), trans_a, trans_b,
                       device="cpu")
    assert torch.equal(two_d, got[1])


@pytest.mark.parametrize("shape", [(64, 256, 16, 16, False, True), (64, 128, 16, 16, False, True),
                                   (64, 1, 128, 16, False, False), (64, 16, 16, 1, False, False),
                                   (64, 16, 128, 16, True, False), (64, 1, 16, 1, False, False)],
                         ids=["ask", "mu_rows", "w_y", "B_zw", "rank_mu", "ps_dot"])
def test_a_member_of_64_equals_it_in_a_batch_of_one(shape):
    """Every call shape of CMA-ES's products on path 28 (the weighted sums
    and ``|ps|``'s dot product have one row, a partial tile): the
    batch-count law M1 exists for."""
    b, p, k, q, ta, tb = shape
    a, bb = (torch.from_numpy(x) for x in _operands(b, p, k, q, ta, tb, seed=1))
    full = km.smallmm(a, bb, ta, tb, device="cpu")
    for i in range(b):
        assert torch.equal(full[i], km.smallmm(a[i:i + 1], bb[i:i + 1], ta, tb, device="cpu")[0])


def test_plain_order_is_the_fixed_loop():
    """Each element is ``acc = acc + a[i, t] * b[t, j]`` for t in order,
    every multiply and add rounded on its own."""
    a, b = (torch.from_numpy(x[0]) for x in _operands(1, 4, 9, 3, False, False, seed=2))
    got = km.smallmm_plain(a, b)
    want = torch.zeros(4, 3)
    for t in range(9):
        want = want + a[:, t:t + 1] * b[t:t + 1, :]
    assert torch.equal(got, want)


def test_vmap_rule_makes_one_batched_call():
    a, b = (torch.from_numpy(x) for x in _operands(6, 8, 12, 4, False, True, seed=3))
    f = lambda x, y: km.smallmm(x, y, False, True, device="cpu")  # noqa: E731
    assert torch.equal(torch.func.vmap(f)(a, b), km.smallmm(a, b, False, True, device="cpu"))
    # one operand unbatched (the weights of CMA-ES's weighted sums)
    w = b[0]
    got = torch.func.vmap(f, in_dims=(0, None))(a, w)
    assert torch.equal(got, torch.stack([f(a[i], w) for i in range(6)]))


def test_cmaes_products_on_the_cpu_stay_einsum():
    """CMA-ES's ``_product`` keeps ``einsum`` on the CPU (the JAX tests'
    tolerances unchanged); M1's plain version agrees within rtol 1e-5."""
    rng = np.random.default_rng(4)
    zd, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((24, 16),
                                                                                  (16, 16)))
    w = torch.from_numpy(rng.random(24).astype(np.float32))
    for eq, args, m1 in (
        ("pd,ed->pe", (zd, B), km.smallmm_plain(zd, B, False, True)),
        ("m,md->d", (w, zd), km.smallmm_plain(w[None], zd)[0]),
        ("de,e->d", (B, zd[0]), km.smallmm_plain(B, zd[0][:, None])[:, 0]),
        ("md,me->de", (zd, zd), km.smallmm_plain(zd, zd, True, False)),
    ):
        got = _product(eq, *args)
        assert torch.equal(got, torch.einsum(eq, *args))
        np.testing.assert_allclose(got.numpy(), m1.numpy(), rtol=RTOL, atol=1e-5)
    assert torch.equal(_norm(zd[0]), torch.linalg.vector_norm(zd[0]))


def test_checks_and_work():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="float32"):
        km.smallmm(a.double(), a.T.double(), device="cpu")
    with pytest.raises(ValueError, match="after the transposes"):
        km.smallmm(a, a, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            km.smallmm(a, a.T)
    before = km.smallmm.launches
    km.smallmm(a, a.T, device="cpu")
    assert km.smallmm.launches == before  # the plain version counts no launch
    assert km.smallmm_work(64, 256, 16, 16) == (4 * 64 * (256 * 16 + 16 * 16 + 256 * 16),
                                                2 * 64 * 256 * 16 * 16)
