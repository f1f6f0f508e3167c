"""The port's dominance stack against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX functions and their
counterparts in ``evox_tpu_torch`` (``device="cpu"``, which takes the plain
route of ``packed_dominance``). The JAX Pallas kernel runs in interpret
mode, as the JAX package's own tests run it on the CPU. Every output here is
boolean or integer, so the tolerance is zero: words compare through a
numpy ``view(uint32)``, counts and ranks exactly. The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.kernels.dominance import packed_dominance as jax_packed_dominance
from evox_tpu.kernels.dominance import packed_dominance_reference as jax_reference
from evox_tpu.operators.selection.non_dominate import non_dominated_sort as jax_nds
from evox_tpu.utils.common import dominate_relation as jax_dominate_relation
from evox_tpu_torch.kernels import dominance as tdom
from evox_tpu_torch.operators.selection import non_dominated_sort
from evox_tpu_torch.utils import dominate_relation


def _fitness(n, m, seed, specials=True):
    """Uniform objectives with per-objective ties (the first one rounded),
    a duplicated row and, with ``specials``, +inf, -inf and NaN rows."""
    rng = np.random.default_rng(seed)
    fit = rng.random((n, m)).astype(np.float32)
    fit[:, 0] = np.round(fit[:, 0], 1)
    if n > 2:
        fit[n // 2] = fit[0]
    if specials and n > 8:
        fit[3] = np.inf
        fit[5, 1 % m] = np.nan
        fit[7] = np.nan
        fit[n - 1, 0] = -np.inf
    return fit


def _assert_words_equal(jax_out, torch_out):
    (jp, jc), (tp, tc) = jax_out, torch_out
    assert tp.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n,m,seed", [(1, 2, 0), (31, 3, 1), (33, 3, 2), (100, 2, 3), (257, 4, 4)])
def test_dominate_relation_matches_jax(n, m, seed):
    fit = _fitness(n, m, seed)
    other = _fitness(n + 5, m, seed + 100)
    for x, y in ((fit, fit), (fit, other)):
        np.testing.assert_array_equal(
            dominate_relation(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
            np.asarray(jax_dominate_relation(jnp.asarray(x), jnp.asarray(y))),
        )


@pytest.mark.parametrize(
    "n,m,seed", [(1, 2, 0), (31, 3, 1), (32, 3, 2), (33, 4, 3), (257, 2, 4), (700, 5, 5)]
)
def test_packed_words_match_jax_reference(n, m, seed):
    """Ragged n, duplicates, ±inf and NaN rows: word for word."""
    fit = _fitness(n, m, seed)
    _assert_words_equal(
        jax_reference(jnp.asarray(fit)),
        tdom.packed_dominance(torch.from_numpy(fit), device="cpu"),
    )


@pytest.mark.parametrize("n,chunk_rows", [(300, 64), (257, 100), (130, 32)])
def test_chunked_build_matches_jax(n, chunk_rows):
    """The slab build (forced here by ``chunk_rows``; by default above
    n = 20000): the same words as JAX's chunked build and as the dense one,
    also with extra words asked for."""
    fit = _fitness(n, 3, n)
    t_fit, j_fit = torch.from_numpy(fit), jnp.asarray(fit)
    dense = tdom.packed_dominance_reference(t_fit)
    for n_words in (None, (n + 31) // 32 + 2):
        chunked = tdom.packed_dominance_reference(t_fit, n_words=n_words, chunk_rows=chunk_rows)
        _assert_words_equal(jax_reference(j_fit, n_words, chunk_rows), chunked)
    np.testing.assert_array_equal(chunked[0][: dense[0].shape[0]].numpy(), dense[0].numpy())
    np.testing.assert_array_equal(chunked[1].numpy(), dense[1].numpy())


@pytest.mark.parametrize("n,m,seed", [(5, 3, 0), (64, 3, 1), (100, 3, 2), (700, 2, 3)])
def test_plain_version_matches_jax_pallas_kernel(n, m, seed):
    """The Pallas kernel in interpret mode, with its +inf padding rows and
    columns (n below and across one tile)."""
    fit = _fitness(n, m, seed)
    _assert_words_equal(
        jax_packed_dominance(jnp.asarray(fit), use_pallas=True, interpret=True),
        tdom.packed_dominance(torch.from_numpy(fit), device="cpu"),
    )


def test_column_popcount_counts_every_bit():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(7, 50), dtype=np.uint64).astype(np.uint32)
    words[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.unpackbits(words.view(np.uint8).reshape(7, 50, 4), axis=2).sum(axis=(0, 2))
    got = tdom.column_popcount(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "n,m,until,seed",
    [(300, 3, None, 0), (300, 3, 150, 1), (257, 2, 100, 2), (500, 4, 1, 3), (200, 3, 200, 4)],
)
def test_non_dominated_sort_matches_jax(n, m, until, seed):
    """Ranks (unranked rows hold the sentinel n) and the cut rank."""
    fit = _fitness(n, m, seed)
    j_rank, j_cut = jax_nds(jnp.asarray(fit), until=until, return_cut_rank=True)
    t_rank, t_cut = non_dominated_sort(torch.from_numpy(fit), until=until, return_cut_rank=True)
    assert t_rank.dtype == torch.int32
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    assert t_cut == int(j_cut)
    if until is not None and until < n:
        assert (t_rank.numpy() == n).any()  # the peel stopped early


def test_non_dominated_sort_refuses_a_mesh():
    """The mesh is ported (the row-sharded sort, ``mesh=``): on an 8-shard
    CPU mesh the ranks and the cut equal the unsharded sort's, a mesh whose
    ``"pop"`` axis is 1 shard sorts unsharded, and stacked members with a
    mesh are refused."""
    from evox_tpu_torch.core.distributed import create_mesh

    fit = torch.from_numpy(np.random.default_rng(3).integers(0, 9, (300, 3)).astype(np.float32))
    want = non_dominated_sort(fit, until=150, return_cut_rank=True)
    for devices in (["cpu"] * 8, ["cpu"]):
        got = non_dominated_sort(fit, until=150, return_cut_rank=True,
                                 mesh=create_mesh(devices=devices))
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError, match="one member"):
        torch.func.vmap(lambda f: non_dominated_sort(f, mesh=create_mesh(devices=["cpu"] * 2)))(
            torch.stack([fit, fit]))


def test_packed_dominance_checks_its_input():
    with pytest.raises(ValueError, match="float32"):
        tdom.packed_dominance(torch.zeros(4, 2, dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tdom.packed_dominance(torch.zeros(4), device="cpu")


@pytest.mark.parametrize("m", list(range(1, tdom.MAX_OBJECTIVES + 1)))
def test_launch_plan_instance_and_shared_memory(m):
    """The exact instance for m = 1..4 (super-tiles of up to 8 words a
    side) and the generic one above (up to 4); a block's two row ranges fit
    in 32 KB of shared memory (48 KB with the counters, the most a launch
    takes without opting in); the main path's n = 20000 keeps the 8 x 8
    super-tiles, 79 to a side, on the square form's 79 x 79 grid (3160
    working blocks); the generic instance's 4 x 4 ones on a linear grid of
    its working blocks."""
    plan = tdom.launch_plan(20000, m)
    assert plan["instance"] == (m if m <= 4 else 0)
    assert plan["tile_words"] == (8 if m <= 4 else 4)
    assert 4 * 2 * 32 * plan["tile_words"] * plan["stride"] <= 32 * 1024
    assert plan["smem_bytes"] <= 48 * 1024
    g = plan["super_tiles"]
    assert (g - 1) * plan["tile_words"] < plan["n_words"] <= g * plan["tile_words"]
    assert plan["working_blocks"] == g * (g + 1) // 2
    assert plan["grid"] == ((g, g, 1) if m <= 4 else (g * (g + 1) // 2,))
    if m <= 4:
        assert g == 79 and plan["working_blocks"] == 3160


def _plan_coverage(plan, b=1):
    """``(b, n_words, n_words)``: how many (block, tile pair) of the plan
    write word row w of the columns of word v of each member, with the
    kernel's own index arithmetic (``csrc/dominance.cu``: block i is
    member and super-tile ``(z, by, bx)`` by :func:`block_tile`, ``by <=
    bx``; its tile pair ``(wi, vi)`` is ``w = by * tile_words + wi``
    against ``v = bx * tile_words + vi`` when both are words and ``w <=
    v``, and writes word rows w (columns of v) and, when ``w != v``, v
    (columns of w))."""
    s, nw = plan["tile_words"], plan["n_words"]
    tiles = [tdom.block_tile(plan, i) for i in range(math.prod(plan["grid"]))]
    tiles = torch.tensor([t for t in tiles if t is not None])
    z, by, bx = (tiles[:, k, None, None] for k in range(3))
    wi, vi = torch.meshgrid(torch.arange(s), torch.arange(s), indexing="ij")
    w, v = by * s + wi, bx * s + vi
    z = z.expand_as(w)
    work = (by <= bx) & (w < nw) & (v < nw) & (w <= v)
    z, w, v = z[work], w[work], v[work]
    off = w != v
    cells = torch.cat([(z * nw + w) * nw + v, (z[off] * nw + v[off]) * nw + w[off]])
    return torch.bincount(cells, minlength=b * nw * nw).view(b, nw, nw)


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 20001])
@pytest.mark.parametrize("m", [2, 3, 5, 32])
def test_launch_plan_covers_every_word_once(n, m):
    """Every (word row, word of columns) of the matrix, so every (word,
    column), is written by exactly one (block, tile pair) of the plan."""
    plan = tdom.launch_plan(n, m)
    assert plan["n_words"] == (n + 31) // 32
    assert bool((_plan_coverage(plan) == 1).all())


def _tile_hits(plan, b):
    """``(b, g, g)``: how many blocks of the plan's linear grid map onto
    each (member, row super-tile, column super-tile)."""
    g = plan["super_tiles"]
    hits = torch.zeros((b, g, g), dtype=torch.int64)
    for i in range(math.prod(plan["grid"])):
        tile = tdom.block_tile(plan, i)
        if tile is not None:
            hits[tile] += 1
    return hits


_BATCH_SHAPES = [tuple(s) for s in __import__("chip_smoke").DOMINANCE_BATCHES] + [
    (b, n, m) for n in (1, 31, 33, 1000, 20001) for m in (2, 3, 5, 32) for b in (1, 3)]


@pytest.mark.parametrize("b,n,m", _BATCH_SHAPES)
def test_linear_grid_maps_every_member_super_tile_once(b, n, m):
    """At every ``DOMINANCE_BATCHES`` shape and at n 1, 31, 33, 1000, 20001
    for m 2, 3, 5 and 32 (one member and three): the plan's grid (linear
    at 4 and 2 words, 2-D at 8) maps its working blocks onto every
    member's working super-tiles (``by <= bx``) exactly once and onto no
    other, with every super-tile the plan could take; a linear grid has no
    other block; and the plan takes the largest super-tile that gives
    ``FILL_BLOCKS`` working blocks, else the smallest."""
    tiles = tdom.SQUARE_TILES[m <= 4]
    chosen = tdom.launch_plan(n, m, b)
    fills = [t for t in tiles if tdom.tile_plan(n, m, b, t)["working_blocks"] >= tdom.FILL_BLOCKS]
    assert chosen["tile_words"] == (fills[0] if fills else tiles[-1])
    for t in tiles if b * n <= 3 * 1000 else (chosen["tile_words"],):
        plan = tdom.tile_plan(n, m, b, t)
        assert plan == tdom.launch_plan(n, m, b) or t != chosen["tile_words"]
        g = plan["super_tiles"]
        upper = torch.triu(torch.ones((g, g), dtype=torch.int64))
        assert torch.equal(_tile_hits(plan, b), upper.expand(b, g, g))
        if t < 8:
            assert plan["grid"] == (plan["working_blocks"],)


@pytest.mark.parametrize("b,n,m", [(4, 1000, 3), (8, 1250, 3), (64, 512, 2), (3, 33, 5)])
def test_batched_plan_covers_every_member_word_once(b, n, m):
    """Word by word at small batched shapes: every member's (word row, word
    of columns) is written by exactly one (block, tile pair)."""
    plan = tdom.launch_plan(n, m, b)
    assert bool((_plan_coverage(plan, b) == 1).all())


def test_path2_shape_keeps_its_plan():
    """Path 2's single launch (n 20000, m 3) keeps the square form's plan:
    8 x 8 super-tiles, 128 threads, a 79 x 79 grid; smaller launches (the
    archive's n 11024, IM-MOEA's n 1998, the MO islands' (4, 2000, 3)) take
    smaller ones on a linear grid (every batched shape of the chip check 2 x
    2)."""
    plan = tdom.launch_plan(20000, 3)
    assert (plan["tile_words"], plan["threads"], plan["grid"]) == (8, 128, (79, 79, 1))
    assert plan["working_blocks"] == 3160
    assert tdom.launch_plan(11024, 3)["tile_words"] == 4
    assert tdom.launch_plan(1998, 3)["tile_words"] == 2
    assert tdom.launch_plan(2000, 3, 4)["tile_words"] == 2
    assert all(tdom.launch_plan(n, m, b)["tile_words"] == 2
               for b, n, m in __import__("chip_smoke").DOMINANCE_BATCHES)


def test_launch_plan_refuses_what_the_kernel_does_not_take():
    for n, m in ((0, 3), (10, 0), (10, tdom.MAX_OBJECTIVES + 1)):
        with pytest.raises(ValueError, match="plans"):
            tdom.launch_plan(n, m)
    with pytest.raises(ValueError, match="plans"):
        tdom.launch_plan(10, 3, b=0)
    with pytest.raises(ValueError, match="plans"):
        tdom.tile_plan(10, 5, 1, 8)  # the generic instance stops at 4
    with pytest.raises(ValueError, match="plans"):
        tdom.tile_plan(10, 3, 0, 2)


# ------------------------------------------ B3's rows form: the one-way rule


def _stress_rows(n, m, seed):
    """Rows with ties on every objective, NaN, -0.0 against +0.0, +inf and
    -inf, duplicated rows and rows equal but for one objective."""
    rng = np.random.default_rng(seed)
    fit = np.round(rng.random((n, m)), 1).astype(np.float32)
    fit[1::7] = fit[0::7][: len(fit[1::7])]  # duplicates
    fit[2::11, 0] = -0.0
    fit[3::11, 0] = 0.0
    fit[4::13] = np.inf
    fit[5::17, m - 1] = np.nan
    fit[6::19, 0] = -np.inf
    fit[8::23] = fit[9::23][: len(fit[8::23])]
    fit[8::23, m // 2] = np.nextafter(fit[8::23, m // 2], np.float32(-np.inf))
    return torch.from_numpy(fit)


def _one_way_rows(rows, fitness):
    """The rows kernel's rule in plain PyTorch: bit k of word w, column j
    is ``le_all(rows[32w + k], fitness[j]) & lt_any(...)``, packed."""
    le = (rows[:, None, :] <= fitness[None, :, :]).all(-1)
    lt = (rows[:, None, :] < fitness[None, :, :]).any(-1)
    packed = tdom.pack_dominator_rows(le & lt, (rows.shape[0] + 31) // 32)
    return packed, tdom.column_popcount(packed)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7])
def test_one_way_strict_rule_equals_the_rows_reference(m):
    """``le_all & lt_any`` in one pass equals ``a & ~transpose(b)`` (the
    plain rows form, ``dominate_relation``) word for word on stress rows:
    ties, NaN, ±0.0 and ±inf, at m 1-5 and a generic m."""
    fit = _stress_rows(300, m, seed=40 + m)
    rows = torch.cat([fit[64:160], torch.full((32, m), float("inf"))])
    got = _one_way_rows(rows, fit)
    want = tdom.packed_dominance_rows_reference(rows, fit)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _rows_coverage(plan):
    """``(r_words, n_words)``: how many (block, warp task, lane word) of the
    rows plan write word row w of the columns of word v, with
    ``csrc/dominance.cu``'s index arithmetic: block ``(bx, by)``, task t of
    ``tile * tile / C`` is slab word ``by * tile + t // (tile / C)``
    against column words ``bx * tile + (t % (tile / C)) * C + c``, c < C,
    each inside the slab's and the fitness's words."""
    s, c = plan["tile_words"], plan["columns_per_lane"]
    gx, gy = plan["grid"]
    rw, nw = plan["r_words"], plan["n_words"]
    hits = np.zeros((rw, nw), np.int64)
    for by in range(gy):
        for bx in range(gx):
            wn, vn = min(s, rw - by * s), min(s, nw - bx * s)
            for t in range(plan["tasks"]):
                wi, v0 = t // (s // c), (t % (s // c)) * c
                if wi >= wn or v0 >= vn:
                    continue
                for cc in range(c):
                    if v0 + cc < vn:
                        hits[by * s + wi, bx * s + v0 + cc] += 1
    return hits


@pytest.mark.parametrize("n,m,shards", __import__("chip_smoke").DOMINANCE_ROWS)
def test_rows_launch_plan_covers_every_word_once(n, m, shards):
    """At each ``DOMINANCE_ROWS`` shape (a shard's ``+inf``-padded slab
    against the full fitness), every (slab word, column word) is written by
    exactly one warp task and lane word of the plan."""
    n_words = -(-n // 32)
    r = -(-n_words // shards) * 32
    plan = tdom.rows_launch_plan(r, n, m)
    assert plan["columns_per_lane"] == (4 if m <= 4 else 2)
    assert plan["tasks"] * plan["columns_per_lane"] == plan["tile_words"] ** 2
    assert bool((_rows_coverage(plan) == 1).all())
