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


# ----------------------------------------------- grouped launches and the plan


def _tell_groups(batch, mu, d, seed):
    """CMA-ES's two tell groups on numpy-seeded operands of its shapes, as
    ``smallmm_group`` products: ``{(z D) B^T, w z}`` and ``{w y, B z_w,
    y^T diag(w) y}`` with ``w`` the rank-mu product's row scale. A batch of
    1 is the solo call's 2-D form, a larger batch the vmap rule's 3-D one."""
    rng = np.random.default_rng(seed)
    zd, z, y = (torch.from_numpy(rng.standard_normal((batch, mu, d)).astype(np.float32))
                for _ in range(3))
    B = torch.from_numpy(rng.standard_normal((batch, d, d)).astype(np.float32))
    zw = torch.from_numpy(rng.standard_normal((batch, d, 1)).astype(np.float32))
    w = torch.from_numpy((rng.random(mu) + 0.1).astype(np.float32))
    if batch == 1:
        zd, z, y, B, zw = (x[0] for x in (zd, z, y, B, zw))
        wrow, wscale = w[None, :], w
    else:
        wrow = w[None, None, :].expand(batch, 1, mu).contiguous()
        wscale = w[None, :].expand(batch, mu).contiguous()
    return ([(zd, B, False, True), (wrow, z, False, False)],
            [(wrow, y, False, False), (B, zw, False, False), (y, y, True, False, wscale)])


@pytest.mark.parametrize("batch,mu,d", [(1, 12, 1000), (64, 128, 16)], ids=["path5", "path28"])
def test_group_plain_equals_each_products_plain_version(batch, mu, d):
    """At path 5's and path 28's tell groups, the grouped plain version is
    each product's ``smallmm_plain``, bit for bit; the folded row scale
    equals ``rn(y * w)`` (the separate multiply CMA-ES made) followed by
    the plain product."""
    for prods in _tell_groups(batch, mu, d, seed=5):
        got = km.smallmm_group(prods, device="cpu")
        assert len(got) == len(prods)
        for out, prod in zip(got, prods):
            a, b, ta, tb = prod[:4]
            if len(prod) == 5:
                w = prod[4]
                a = a * (w[:, None] if a.ndim == 2 else w[:, :, None])
            assert torch.equal(out, km.smallmm_plain(a, b, ta, tb))


def test_group_vmap_rule_makes_one_batched_call(monkeypatch):
    """Under ``torch.func.vmap`` the grouped op's rule makes one batched
    call for all members (the weights unbatched), equal to each member's
    own group."""
    prods = _tell_groups(6, 8, 5, seed=6)[1]
    y, B, zw, w = prods[0][1], prods[1][0], prods[1][1], prods[2][4][0]
    calls = []
    plain = km.smallmm_group_plain

    def counted(p):
        calls.append([tuple(x.shape) for x in p[0][:2]])
        return plain(p)

    monkeypatch.setattr(km, "smallmm_group_plain", counted)

    def tell(y, B, zw):
        return km.smallmm_group([(w[None, :], y, False, False), (B, zw, False, False),
                                 (y, y, True, False, w)], device="cpu")

    got = torch.func.vmap(tell)(y, B, zw)
    assert len(calls) == 1 and calls[0][0] == (6, 1, 8)
    want = [torch.stack(parts) for parts in zip(*(plain([(w[None, :], y[i], False, False),
                                                        (B[i], zw[i], False, False),
                                                        (y[i], y[i], True, False, w)])
                                                  for i in range(6)))]
    assert all(torch.equal(g, h) for g, h in zip(got, want))


def test_cmaes_tell_makes_grouped_products_of_the_same_numbers():
    """CMA-ES's ``_products`` on the CPU is each product's ``einsum``, the
    rank-mu one on ``y * w[:, None]`` as before; M1's grouped plain version
    agrees within rtol 1e-5."""
    from evox_tpu_torch.algorithms.so.es.cma_es import _products

    rng = np.random.default_rng(7)
    y, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((12, 16),
                                                                                 (16, 16)))
    w = torch.from_numpy(rng.random(12).astype(np.float32))
    zw = y[0]
    y_w, Bz_w, rank_mu = _products(("m,md->d", w, y), ("de,e->d", B, zw),
                                   ("md,me->de", y, y, w))
    assert torch.equal(y_w, torch.einsum("m,md->d", w, y))
    assert torch.equal(Bz_w, torch.einsum("de,e->d", B, zw))
    assert torch.equal(rank_mu, torch.einsum("md,me->de", y * w[:, None], y))
    m1 = km.smallmm_group_plain([(w[None], y, False, False), (B, zw[:, None], False, False),
                                 (y, y, True, False, w)])
    for got, want in zip((y_w, Bz_w, rank_mu), (m1[0][0], m1[1][:, 0], m1[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def _written(plan, p, q, batch):
    """``(batch, p, q)``: how many (block, thread, register) of the plan
    write each output, with ``csrc/smallmm.cu``'s index arithmetic: block x
    is tile ``(x // tiles_n, x % tiles_n)``, thread ``tid < wm * wn`` is
    ``(tid // wn, tid % wn)`` and writes rows ``i0 + ty * tm + ii`` and
    columns ``j0 + tx * tn + jj`` inside ``(p, q)``."""
    hits = np.zeros((batch, p, q), np.int64)
    tiles = plan["tiles_m"] * plan["tiles_n"]
    tid = np.arange(plan["wm"] * plan["wn"])
    ty, tx = tid // plan["wn"], tid % plan["wn"]
    for x in range(tiles):
        ti, tj = divmod(x, plan["tiles_n"])
        for ii in range(plan["tm"]):
            for jj in range(plan["tn"]):
                i = ti * plan["bm"] + ty * plan["tm"] + ii
                j = tj * plan["bn"] + tx * plan["tn"] + jj
                keep = (i < p) & (j < q)
                np.add.at(hits, (slice(None), i[keep], j[keep]), 1)
    return hits


def _shapes():
    import chip_smoke

    return [s[1:] for s in chip_smoke.SMALLMM_SHAPES]


@pytest.mark.parametrize("shape", _shapes(), ids=[s[0] for s in
                                                  __import__("chip_smoke").SMALLMM_SHAPES])
def test_launch_plan_covers_every_output_once(shape):
    """At each of the 13 ``SMALLMM_SHAPES``, every output element is written
    by exactly one thread of the plan; the tiles fit the kernel (at most 64
    rows and columns a tile, 256 threads a block)."""
    batch, p, k, q, ta, tb = shape
    plan = km.launch_plan(batch, p, k, q, ta, tb)
    assert plan["bm"] <= km.MAX_TILE and plan["bn"] <= km.MAX_TILE
    assert plan["wm"] * plan["wn"] <= plan["threads"] <= 256
    assert 1 <= plan["ring"] <= 8 and plan["smem_bytes"] <= km.MAX_SMEM
    assert plan["lda"] % 4 == 0 and plan["ldb"] % 4 == 0
    assert plan["lda"] >= (plan["kslice"] if plan["kc_a"] else plan["bm"]) + 4
    assert plan["kslice"] == (128 if k >= 256 and plan["variant"] != "square" else 32)
    assert plan["blocks"] == plan["tiles_m"] * plan["tiles_n"] * batch
    assert bool((_written(plan, p, q, 1) == 1).all())
    if p <= 32 and not (p == 1 or q == 1):
        assert plan["tiles_m"] == 1  # skinny: the wide operand read once


def test_plan_variants_and_refusals():
    assert km.launch_plan(1, 24, 1000, 1000)["variant"] == "skinny"
    assert km.launch_plan(1, 1000, 12, 1000)["variant"] == "square"
    assert km.launch_plan(64, 256, 16, 16)["variant"] == "thin"
    assert km.launch_plan(1, 1000, 1000, 1)["variant"] == "vector"
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="1 to 4 products"):
        km.smallmm_group([(a, a.T, False, False)] * 5, device="cpu")
    with pytest.raises(ValueError, match="row scale"):
        km.smallmm_group([(a, a.T, False, False, torch.ones(3))], device="cpu")
    before = km.smallmm_group.launches
    km.smallmm_group([(a, a.T, False, False, torch.ones(2))], device="cpu")
    assert km.smallmm_group.launches == before  # the plain version counts no launch
