"""The port's ``partial_topk`` against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX
``partial_topk_reference`` (``lax.top_k(-v, k)`` negated back) and the
port's ``partial_topk`` with ``device="cpu"``, which takes the plain route
(``partial_topk_reference``). Values are compared bit for bit (as uint32
patterns, so NaN payloads and the sign of zero count) and indices exactly:
the tolerance is zero, since the function selects, it does not compute.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    with pytest.raises(ValueError, match="1-D"):
        tk.partial_topk(torch.zeros(2, 2), 1, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tk.partial_topk(torch.zeros(4, dtype=torch.float64), 1, device="cpu")
    assert tk.default_use_kernel() is False
