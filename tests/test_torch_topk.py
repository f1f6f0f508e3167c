"""The port's ``partial_topk`` against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX
``partial_topk_reference`` (``lax.top_k(-v, k)`` negated back) and the
port's ``partial_topk`` with ``device="cpu"``, which takes the plain route
(``partial_topk_reference``). Values are compared bit for bit (as uint32
patterns, so NaN payloads and the sign of zero count) and indices exactly:
the tolerance is zero, since the function selects, it does not compute.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; its algorithm is held here through a numpy model of its
stages (below), against the JAX reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.kernels.topk import partial_topk as jax_partial_topk
from evox_tpu.kernels.topk import partial_topk_reference as jax_reference
from evox_tpu_torch.kernels import topk as tk

# NaNs of both signs and several payloads, infinities and signed zeros
SPECIAL_BITS = np.array(
    [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001, 0xFFF00000,
     0x7F800000, 0xFF800000, 0x00000000, 0x80000000, 0x3F800000, 0xBF800000],
    dtype=np.uint32,
)


def _assert_same(values, k):
    jv, ji = jax_reference(jnp.asarray(values), k)
    tv, ti = tk.partial_topk(torch.from_numpy(values.copy()), k, device="cpu")
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


def test_tie_law_is_the_total_order_on_bits():
    """-0.0 before +0.0, NaN by sign and payload: the order lax.top_k uses,
    which torch.argsort(stable=True) does not follow."""
    v = np.array([0, -0.0, 1, np.nan, -np.inf, np.inf, 0], np.float32)
    _, idx = tk.partial_topk(torch.from_numpy(v), 7, device="cpu")
    assert idx.tolist() == [4, 1, 0, 6, 2, 5, 3]
    assert torch.argsort(torch.from_numpy(v), stable=True).tolist() != idx.tolist()
    _assert_same(SPECIAL_BITS.view(np.float32), len(SPECIAL_BITS))


@pytest.mark.parametrize(
    "n,k,seed",
    [(1, 1, 0), (5, 1, 1), (100, 100, 2), (127, 40, 3), (1000, 1, 4), (3001, 3001, 5),
     (20000, 10000, 6)],
)
def test_matches_jax_reference(n, k, seed):
    """Random values with heavy duplicates (rounded to a few levels), the
    special values sprinkled in; k = 1, k = n, n < 128 and the NSGA-II
    shape n = 20000, k = 10000."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=n), 1).astype(np.float32)
    hit = rng.integers(0, n, size=min(n, 3 * len(SPECIAL_BITS)))
    v[hit] = np.resize(SPECIAL_BITS, hit.size).view(np.float32)
    _assert_same(v, k)


@pytest.mark.parametrize("n,k,seed", [(2500, 1, 0), (2048, 300, 1), (3000, 1024, 2)])
def test_matches_jax_pallas_kernel_in_interpret_mode(n, k, seed):
    """Where the Pallas kernel runs (k <= 1024 < n): duplicates and ±inf
    sentinels. No NaN or signed zero here: the Pallas kernel ranks inside a
    block by float compares, where -0.0 == +0.0."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(-3, 3, size=n), 1).astype(np.float32)
    v[rng.integers(0, n, 20)] = np.inf
    v[rng.integers(0, n, 20)] = -np.inf
    v[v == 0] = 0.5
    jv, ji = jax_partial_topk(jnp.asarray(v), k, use_kernel=True, interpret=True)
    tv, ti = tk.partial_topk(torch.from_numpy(v), k, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _stress_rows(rows, n, seed, special):
    """Rows of rounded normals (heavy ties) with ±inf sprinkled in; with
    ``special``, the SPECIAL_BITS too (NaNs by sign and payload, ±0.0)."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=(rows, n)), 1).astype(np.float32)
    for r in range(rows):
        v[r, rng.integers(0, n, 3)] = np.inf
        v[r, rng.integers(0, n, 3)] = -np.inf
        if special:
            hit = rng.integers(0, n, size=len(SPECIAL_BITS))
            v[r, hit] = SPECIAL_BITS.view(np.float32)
    v[-1] = v[-1, 0]  # an all-equal row
    return v


@pytest.mark.parametrize("rows,n,k", [(8, 512, 1), (8, 512, 4), (4, 2000, 4), (3, 2049, 8),
                                      (2, 300, 300)])
def test_batched_rows_match_vmapped_jax_pallas_kernel(rows, n, k):
    """A ``(rows, n)`` batch against ``jax.vmap`` of the JAX function on
    its Pallas kernel in interpret mode (what ``IslandWorkflow`` runs: one
    batched kernel with a grid over the rows), values and indices exact:
    ties, ±inf and an all-equal row (no NaN or signed zero: the Pallas
    kernel ranks inside a block by float compares). (8, 512, 1) is the
    island workload's migration; k = n the whole row sorted."""
    v = _stress_rows(rows, n, rows * n + k, special=False)
    v[v == 0] = 0.5
    jv, ji = jax.vmap(lambda r: jax_partial_topk(r, k, use_kernel=True, interpret=True))(
        jnp.asarray(v))
    tv, ti = tk.partial_topk(torch.from_numpy(v), k, device="cpu")
    assert tv.shape == ti.shape == (rows, k) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("rows,n,k", [(8, 512, 1), (5, 100, 100), (3, 1000, 37)])
def test_batched_rows_follow_the_total_order_like_vmapped_reference(rows, n, k):
    """Stress rows with NaNs of both signs and payloads and ±0.0: each row
    of the batch follows the 1-D contract, the total order on bits (JAX's
    ``lax.top_k`` reference under ``vmap``), bit for bit."""
    v = _stress_rows(rows, n, n + k, special=True)
    jv, ji = jax.vmap(lambda r: jax_reference(r, k))(jnp.asarray(v))
    tv, ti = tk.partial_topk(torch.from_numpy(v), k, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


def test_launch_plan_of_a_batch():
    """The small route batches into one launch of a grid of rows; the large
    route queues a row's sequence once a row."""
    one, batch = tk.launch_plan(512, 1), tk.launch_plan(512, 1, rows=8)
    assert batch["route"] == "small" and batch["batched"] == "grid" and batch["launches"] == 1
    assert {k: v for k, v in batch.items() if k not in ("rows", "batched")} == {
        k: v for k, v in one.items() if k != "rows"}
    assert "batched" not in one and one["rows"] == 1
    assert tk.launch_plan(20000, 10000, rows=3)["batched"] == "grid"
    large = tk.launch_plan(30000, 15000, rows=3)
    assert large["route"] == "large" and large["batched"] == "per_row"
    assert large["launches"] == 3 * tk.launch_plan(30000, 15000)["launches"]
    with pytest.raises(ValueError, match="rows"):
        tk.launch_plan(10, 1, rows=0)


def test_total_order_key_orders_like_the_bits():
    keys = tk.total_order_key(torch.from_numpy(SPECIAL_BITS.view(np.float32)))
    order = torch.argsort(keys, stable=True).tolist()
    _, want = jax_reference(jnp.asarray(SPECIAL_BITS.view(np.float32)), len(SPECIAL_BITS))
    assert order == np.asarray(want).tolist()


def test_arguments_are_checked():
    v = torch.zeros(4)
    for k in (0, 5):
        with pytest.raises(ValueError, match="k must be"):
            tk.partial_topk(v, k, device="cpu")
    with pytest.raises(ValueError, match="1-D vector or a 2-D batch"):
        tk.partial_topk(torch.zeros(2, 2, 2), 1, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        tk.partial_topk(torch.zeros(0, 4), 1, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        tk.partial_topk(torch.zeros(3, 4), 5, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tk.partial_topk(torch.zeros(4, dtype=torch.float64), 1, device="cpu")
    assert tk.default_use_kernel() is False


# ---------------------------------------------------------------------------
# A numpy model of csrc/topk.cu's algorithm: the select's digit histograms
# and threshold, the stable compaction, and the LSD passes of both sorts,
# stage by stage as the kernels do them, with the route chosen by
# launch_plan at a shrunk shared-memory limit and shrunk tiles, so that both
# routes (and both sorts of the large one) run at n of a few thousand.

FULL = 0xFFFFFFFF
MODEL_SMALL_WORDS = 2048  # launch_plan's limit, shrunk from 49152
MODEL_COMPACT_TILE = 256  # the compaction's tile, shrunk from 4096
MODEL_SORT_TILE = 128  # route 2's tile, shrunk from 4096
MODEL_SORT_THREADS = ((32, 8), (512, 32))  # (most keys, threads) of the sized sort, shrunk
MODEL_BLOCK = {256: 64, 1024: 128}  # the block sizes, shrunk


def order_key(v):
    b = np.asarray(v, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def value_bits(u):
    return np.where(u & 0x80000000, u ^ 0x80000000, ~u).astype(np.uint32)


def model_select(u, k):
    """The MSD passes: (mask, bits, less) of the kept bucket, and the passes
    run. A pass stops the select when the chosen bucket is taken whole or
    when every key it counted is the same."""
    mask, bits, less, passes = 0, 0, 0, 0
    done = k == len(u)
    for shift, nbits in tk.SELECT_DIGITS:
        if done:
            break
        passes += 1
        inb = (u & np.uint32(mask)) == bits
        d = ((u[inb] >> np.uint32(shift)) & np.uint32((1 << nbits) - 1)).astype(np.int64)
        hist = np.bincount(d, minlength=1 << nbits)
        need = k - less
        cum = np.cumsum(hist)
        chosen = int(np.searchsorted(cum, need))  # first bin where the count reaches need
        below = int(cum[chosen] - hist[chosen])
        mask |= ((1 << nbits) - 1) << shift
        bits |= chosen << shift
        less += below
        # every key the pass counted is the same (the OR of the keys and the
        # OR of their complements agree): that key is the threshold
        if np.bitwise_or.reduce(u[inb]) == np.uint32(~np.bitwise_or.reduce(~u[inb])):
            mask, bits = FULL, int(u[inb][0])
        done = need - below == hist[chosen] or mask == FULL
    return mask, bits, less, passes


def model_compact(u, k, mask, bits, less, tile):
    """Keys below the bucket to [0, less), the first need of the bucket to
    [less, k), each in index order: per-tile counts, exclusive scans over the
    tiles, ranks inside a tile."""
    h = u & np.uint32(mask)
    is_l, is_b = h < bits, h == bits
    need = k - less
    starts = np.arange(0, len(u), tile)
    off_l = np.concatenate([[0], np.cumsum(np.add.reduceat(is_l.astype(np.int64), starts))[:-1]])
    off_b = np.concatenate([[0], np.cumsum(np.add.reduceat(is_b.astype(np.int64), starts))[:-1]])
    keys = np.zeros(k, np.uint32)
    idx = np.zeros(k, np.int64)
    for t, t0 in enumerate(starts):
        sl = slice(t0, min(t0 + tile, len(u)))
        rl = off_l[t] + np.cumsum(is_l[sl]) - is_l[sl]
        rb = off_b[t] + np.cumsum(is_b[sl]) - is_b[sl]
        i = np.arange(sl.start, sl.stop)
        take_l = is_l[sl]
        take_b = is_b[sl] & (rb < need)
        keys[rl[take_l]] = u[sl][take_l]
        idx[rl[take_l]] = i[take_l]
        keys[less + rb[take_b]] = u[sl][take_b]
        idx[less + rb[take_b]] = i[take_b]
    assert int(is_l.sum()) == less
    return keys, idx


def model_block_sort(keys, idx, threads):
    """The one-block sort: 4-bit LSD passes; thread t owns an odd-length
    contiguous range and a counter a digit; counters scanned digit-major,
    thread-minor; a digit in which OR and AND of all keys agree is no pass."""
    m = len(keys)
    if m <= 1:
        return keys, idx
    vary = int(np.bitwise_or.reduce(keys)) ^ int(np.bitwise_and.reduce(keys))
    bits = tk.BLOCK_SORT_BITS
    for shift in range(0, 32, bits):
        if not (vary >> shift) & ((1 << bits) - 1):
            continue
        it = (-(-m // threads)) | 1
        digit = ((keys >> np.uint32(shift)) & np.uint32((1 << bits) - 1)).astype(np.int64)
        thread = np.arange(m) // it
        counts = np.zeros((1 << bits, threads), np.int64)
        np.add.at(counts, (digit, thread), 1)
        start = (np.cumsum(counts.ravel()) - counts.ravel()).reshape(counts.shape)
        pos = np.empty(m, np.int64)
        seen = np.zeros_like(counts)
        for j in range(m):  # a thread walks its range in index order
            d, t = digit[j], thread[j]
            pos[j] = start[d, t] + seen[d, t]
            seen[d, t] += 1
        out_k, out_i = np.empty_like(keys), np.empty_like(idx)
        out_k[pos], out_i[pos] = keys, idx
        keys, idx = out_k, out_i
    return keys, idx


def model_grid_sort(keys, idx, tile):
    """Route 2: 8-bit LSD passes over tiles; per-tile digit counts scanned
    digit-major, tile-minor; a tile ranks its keys stably by digit; a pass
    whose digit holds all keys (from the compaction's histograms) is
    skipped."""
    m = len(keys)
    bits = tk.GRID_SORT_BITS
    for shift in range(0, 32, bits):
        digit = ((keys >> np.uint32(shift)) & np.uint32((1 << bits) - 1)).astype(np.int64)
        if m == 0 or (np.bincount(digit, minlength=1 << bits) == m).any():
            continue
        tiles = -(-m // tile)
        counts = np.zeros((1 << bits, tiles), np.int64)
        np.add.at(counts, (digit, np.arange(m) // tile), 1)
        start = (np.cumsum(counts.ravel()) - counts.ravel()).reshape(counts.shape)
        pos = np.empty(m, np.int64)
        for t in range(tiles):
            sl = slice(t * tile, min((t + 1) * tile, m))
            d = digit[sl]
            order = np.argsort(d, kind="stable")  # the tile in digit order
            local = np.empty(len(d), np.int64)
            local[order] = np.arange(len(d))
            first = np.searchsorted(d[order], np.arange(1 << bits))  # digit starts in the tile
            pos[sl] = start[d, t] + local - first[d]
        out_k, out_i = np.empty_like(keys), np.empty_like(idx)
        out_k[pos], out_i[pos] = keys, idx
        keys, idx = out_k, out_i
    return keys, idx


def model_topk(values, k, small_words=MODEL_SMALL_WORDS):
    """The kernel's algorithm on the route launch_plan chooses."""
    u = order_key(values)
    n = len(u)
    plan = tk.launch_plan(n, k, small_words)
    mask, bits, less, _ = model_select(u, k)
    tile = n if plan["route"] == "small" else MODEL_COMPACT_TILE
    keys, idx = model_compact(u, k, mask, bits, less, tile)
    m = less if mask == FULL else k  # a complete threshold: its keys need no sorting
    if plan["sort"] == "block":  # as many threads as the keys keep busy (block_sort_sized)
        block = MODEL_BLOCK[plan["threads"]]
        threads = next((t for most, t in MODEL_SORT_THREADS if m <= most and t <= block), block)
        sk, si = model_block_sort(keys[:m], idx[:m], threads)
    else:
        sk, si = model_grid_sort(keys[:m], idx[:m], MODEL_SORT_TILE)
    keys = np.concatenate([sk, keys[m:]])
    idx = np.concatenate([si, idx[m:]])
    return value_bits(keys).view(np.float32), idx.astype(np.int32), plan


def _model_cases():
    rng = np.random.default_rng(7)
    cases = []

    def add(name, v, ks):
        for k in sorted({int(k) for k in ks if 1 <= k <= len(v)}):
            cases.append(pytest.param(v, k, id=f"{name}-n{len(v)}-k{k}"))

    # heavy duplicates with NaNs of both signs and payloads, ±inf, ±0.0
    for n in (1000, 3001):
        v = np.round(rng.normal(size=n) * 4).astype(np.float32) / 4
        hit = rng.integers(0, n, size=48)
        v[hit] = np.resize(SPECIAL_BITS, hit.size).view(np.float32)
        add("duplicates", v, (1, n // 10, n // 2, n))
    # an all-+inf tail: c finite keys; k at c, c + 1 and n
    n, c = 2500, 700
    v = np.full(n, np.inf, np.float32)
    v[rng.permutation(n)[:c]] = -rng.uniform(0, 2, c).astype(np.float32)
    v[rng.permutation(n)[:3]] = -np.inf
    add("inf-tail", v, (1, c - 1, c, c + 1, n))
    # all-equal vectors: +inf, one NaN payload, -0.0
    for name, bits in (("all-inf", 0x7F800000), ("all-nan", 0xFFC00123),
                       ("all-negzero", 0x80000000)):
        v = np.full(1500, bits, np.uint32).view(np.float32)
        add(name, v, (1, 750, 1500))
    # k at a bucket boundary of the first select digit: keys spread over
    # several buckets, k equal to the count of the buckets below one
    v = np.concatenate([np.full(400, 1.0), np.full(300, 2.0), np.full(500, 4.0),
                        rng.uniform(8, 16, 800)]).astype(np.float32)
    v = v[rng.permutation(v.size)]
    top = order_key(v) >> np.uint32(21)
    for edge in np.unique(top)[1:3]:
        add("bucket-edge", v, ((top < edge).sum(), (top < edge).sum() + 1))
    # distinct values of both signs
    v = (rng.permutation(4000) - 2000).astype(np.float32)
    add("distinct", v, (1, 100, 400, 2000, 4000))
    return cases


@pytest.mark.parametrize("values,k", _model_cases())
def test_algorithm_model_matches_jax_reference(values, k):
    """The model of the kernel's algorithm, on whichever route launch_plan
    picks at the shrunk limit, equals lax.top_k bit for bit."""
    mv, mi, _ = model_topk(values, k)
    jv, ji = jax_reference(jnp.asarray(values), k)
    np.testing.assert_array_equal(mi, np.asarray(ji))
    np.testing.assert_array_equal(mv.view(np.uint32), np.asarray(jv).view(np.uint32))


def test_algorithm_model_runs_every_route():
    """The model's cases cover the small route, the large route with the
    one-block sort and with the grid sort, and a select that stops on a
    bucket of equal keys."""
    routes = {(c.values[0].size, c.values[1]): tk.launch_plan(c.values[0].size, c.values[1],
                                                              MODEL_SMALL_WORDS)
              for c in _model_cases()}
    kinds = {(p["route"], p["sort"]) for p in routes.values()}
    assert kinds == {("small", "block"), ("large", "block"), ("large", "grid")}
    # the +inf bucket is one key: the second pass completes the threshold
    inf_tail = np.full(10, np.inf, np.float32)
    inf_tail[:3] = [1.0, 2.0, 3.0]
    assert model_select(order_key(inf_tail), 5) == (FULL, int(order_key(np.float32(np.inf))), 3, 2)
    # an all-equal input: the first pass does; k == n runs none
    assert model_select(order_key(np.zeros(9, np.float32)), 4) == (FULL, 0x80000000, 0, 1)
    assert model_select(order_key(np.zeros(9, np.float32)), 9) == (0, 0, 0, 0)


def test_launch_plan_routes_and_switches():
    """Small while one block holds the keys beside two buffers of kept
    pairs, max(n + 2k [k < n], 4k) <= SMALL_WORDS; its block is 256 threads
    up to SMALL_N; then the large route, its sort in one block while 4k <=
    SMALL_WORDS and over tiles beyond; no select passes when k == n."""
    w = tk.SMALL_WORDS
    assert tk.launch_plan(20000, 10000)["route"] == "small"  # the NSGA-II main path
    assert tk.launch_plan(w // 4, w // 4)["route"] == "small"
    assert tk.launch_plan(w // 4 + 1, w // 4 + 1)["route"] == "large"
    assert tk.launch_plan(w - 2, 1)["route"] == "small"
    assert tk.launch_plan(w - 1, 1)["route"] == "large"
    assert tk.launch_plan(w - 2000, 1000)["route"] == "small"
    assert tk.launch_plan(w - 1999, 1000)["route"] == "large"
    assert tk.launch_plan(tk.SMALL_N, 1)["threads"] == 256
    assert tk.launch_plan(tk.SMALL_N + 1, 1)["threads"] == 1024
    one = tk.launch_plan(10**6, w // 4)
    grid = tk.launch_plan(10**6, w // 4 + 1)
    assert (one["code"], one["sort"], one["launches"]) == (1, "block", 7)
    assert (grid["code"], grid["sort"], grid["launches"]) == (2, "grid", 19)
    every = tk.launch_plan(10**6, 10**6)
    assert every["launches"] == 16 and every["scratch_words"] > 4 * 10**6
    assert tk.launch_plan(1000, 1)["scratch_words"] == 0
    for n, k in ((1000, 1), (20000, 10000), (12288, 12288)):
        assert tk.launch_plan(n, k)["smem_bytes"] <= 232448  # an H100 block's limit
    with pytest.raises(ValueError):
        tk.launch_plan(5, 6)
