"""Exact partial top-k (the ``k`` smallest): hand-written CUDA kernels on the card.

The port of ``evox_tpu/kernels/topk.py``. ``partial_topk(values, k)`` returns
the ``k`` smallest entries of a float32 vector and their int32 indices,
ascending, element for element as the JAX package's
``partial_topk_reference`` (``lax.top_k(-values, k)`` negated back).

**The tie law is a total order on float bits, not ``==``.** ``lax.top_k``
ranks ``-0.0`` before ``+0.0``, NaNs with the sign bit set before ``-inf``
and NaNs without it after ``+inf``, NaNs among themselves by payload, and
equal bits by lowest index: IEEE totalOrder. ``torch.sort`` and
``jnp.argsort`` instead treat ``-0.0 == +0.0``. So the plain version ranks
by :func:`total_order_key`, an int32 whose signed order is that total
order, joined with the index into a unique 64-bit key, and the kernels by
the same order on unsigned keys.

On a CUDA tensor ``partial_topk`` launches the hand-written kernels of
``csrc/topk.cu``: a radix select of the threshold key over 11-, 11- and
10-bit digits, a stable compaction of the ``k`` kept keys in index order,
and a stable LSD radix sort of those below the threshold on the key alone,
so equal keys keep index order (that file's header has the design and
what bounds it). :func:`launch_plan` chooses the route: ``small`` (one
block, one launch, everything in shared memory) or ``large`` (grid-wide
select and compaction, then a one-block sort of the kept keys when they
are few, else a grid-wide one). On a CPU tensor it runs
``partial_topk_reference``: the same key, one ``torch.sort`` and a slice.
The JAX kernel's envelope (``k <= block_size``, ``n < 2**24``, else a
silent fallback to XLA) does not exist here: the kernel computes the
whole contract for every ``1 <= k <= n < 2**31``. A CUDA tensor goes to the
kernel or raises.

Under ``torch.func.vmap`` (stacked members, :mod:`evox_tpu_torch.core.
members`) ``partial_topk`` goes through a ``torch.library`` custom op whose
``vmap`` rule folds the member axis into the ``(rows, n)`` batch: one
launch on the small route.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import Mapping, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..core.members import is_batched
from . import _build

__all__ = [
    "default_use_kernel",
    "empty_launch",
    "launch_plan",
    "partial_topk",
    "partial_topk_reference",
    "topk_work",
    "total_order_key",
]


def topk_work(n: int, k: int, rows: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of selecting the k smallest of each of ``rows``
    rows: n floats read, k values and k indices written; one key per value
    (a radix select needs O(n) work). The bound column of PERF.md's kernel
    table and the cost analysis (``core/cost.py``) both count so."""
    return rows * (4 * n + 8 * k), rows * n


def default_use_kernel() -> bool:
    """Resolve ``use_kernel=None`` at the call sites that choose between a
    full sort and ``partial_topk`` (``rank_crowding_truncate``): False, as
    in the JAX package, so the default path is the lexsort one."""
    return False


def total_order_key(values: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is IEEE totalOrder of float32
    ``values``: non-negative floats keep their bits; negative ones (sign bit
    set) flip every other bit, so larger magnitudes sort lower and ``-0.0``
    becomes -1, just below ``+0.0``'s 0."""
    bits = values.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _check_args(values: torch.Tensor, k: int) -> int:
    if values.ndim not in (1, 2):
        raise ValueError(f"partial_topk takes a 1-D vector or a 2-D batch of rows, got "
                         f"{tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise ValueError(f"partial_topk takes float32 values, got {values.dtype}")
    n = values.shape[-1]
    if values.ndim == 2 and not 1 <= values.shape[0] < 2**31:
        raise ValueError(f"partial_topk takes 1 to 2**31 - 1 rows, got {values.shape[0]}")
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if n >= 2**31:
        raise ValueError(f"partial_topk takes fewer than 2**31 values (int32 indices), got {n}")
    return n


def partial_topk_reference(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the ``k`` smallest of float32 ``values`` with their
    int32 indices, ascending, ties by lowest index under the total order of
    :func:`total_order_key`. The 64-bit key ``key * 2**32 + index`` is
    unique, so one sort fixes the order. A ``(rows, n)`` batch goes row by
    row through the 1-D version, giving ``(rows, k)`` values and indices."""
    n = _check_args(values, k)
    if values.ndim == 2:
        rows = [partial_topk_reference(row, k) for row in values]
        return torch.stack([v for v, _ in rows]), torch.stack([i for _, i in rows])
    index = torch.arange(n, dtype=torch.int64, device=values.device)
    key = total_order_key(values).to(torch.int64) * (1 << 32) + index
    order = torch.sort(key).indices[:k]
    return values[order], order.to(torch.int32)


# csrc/topk.cu's constants
SMALL_WORDS = 49152  # 192 KB of keys and survivor pairs in one block's shared memory
SMALL_N = 4096  # the small route's block is 256 threads up to here, else 1024
CONTROL_WORDS = 64 + 3 * 2048 + 4 * 256  # control header, select and sort histograms
COMPACT_TILE = 4096
SORT_TILE = 4096
SELECT_DIGITS = ((21, 11), (10, 11), (0, 10))  # (shift, bits) of the select passes
BLOCK_SORT_BITS = 4  # the one-block sort's digit
GRID_SORT_BITS = 8  # route 2's digit


def _align4(words: int) -> int:
    return -(-words // 4) * 4


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, k: int, small_words: int = SMALL_WORDS, rows: int = 1) -> Mapping:
    """The kernel's route for ``(n, k)``, over ``rows`` rows of ``n``.

    ``small`` (code 0): one launch, no scratch, when one block's shared
    memory holds the keys (``n`` words, while ``k < n``) beside the kept
    keys and indices (``2k`` words), and then two buffers of them:
    ``max(n + 2k [k < n], 4k) <= small_words``. The block has 256 threads
    up to ``n = SMALL_N``, else 1024. Else ``large``: a memset of the
    control header, the three select passes (none when ``k == n``), the
    compaction's count and scatter, and the sort: in one block of 1024
    threads (code 1, ``sort: "block"``) when ``4k <= small_words``, else
    over tiles of :data:`SORT_TILE` (code 2, ``sort: "grid"``: four passes
    of count, scan and scatter, then the kernel that writes the kept keys
    that need no sorting). ``small_words`` exists so that a model of the
    algorithm can shrink the limit; the kernel's is :data:`SMALL_WORDS`.
    Over ``rows > 1`` rows (``batched``): the small route is one launch of
    a grid of ``rows`` blocks (``"grid"``, one block a row, each as the 1-D
    route's); the large route queues its 1-D sequence once a row
    (``"per_row"``: ``launches`` is ``rows`` times a row's; a batched large
    route is left for later, ROADMAP B4). ``smem_bytes`` and
    ``scratch_words`` are a row's (the per-row sequence reuses one
    scratch). The plan is cached and read-only.
    """
    if not 1 <= k <= n:
        raise ValueError(f"launch_plan takes 1 <= k <= n, got n={n}, k={k}")
    if rows < 1:
        raise ValueError(f"launch_plan takes rows >= 1, got {rows}")
    region = _align4(max(n + 2 * k if k < n else 0, 4 * k))
    if region <= small_words:
        threads = 256 if n <= SMALL_N else 1024
        counters = max(8 * threads, 2048)  # the sort's 16-bit counters, the select's bins
        return MappingProxyType({"route": "small", "code": 0, "sort": "block", "threads": threads,
                                 "launches": 1, "smem_bytes": 4 * (region + counters),
                                 "scratch_words": 0, "rows": rows,
                                 **({"batched": "grid"} if rows > 1 else {})})
    compact_tiles = -(-n // COMPACT_TILE)
    scratch = CONTROL_WORDS + 2 * compact_tiles + 2 * k
    launches = 1 + (3 if k < n else 0) + 2
    if 4 * k <= small_words:
        code, sort, launches = 1, "block", launches + 1
        smem = 4 * (4 * _align4(k) + 8 * 1024)
    else:
        code, sort, launches = 2, "grid", launches + 4 * 3 + 1
        scratch += 2 * k + 256 * -(-k // SORT_TILE)
        smem = 0
    return MappingProxyType({"route": "large", "code": code, "sort": sort, "threads": 1024,
                             "launches": rows * launches, "smem_bytes": smem,
                             "scratch_words": scratch, "compact_tiles": compact_tiles, "rows": rows,
                             **({"batched": "per_row"} if rows > 1 else {})})


_kernels: dict = {}

# entry point -> its ctypes argument types
_ENTRIES = {
    # values, n, k, out values, out indices, stream
    "evox_partial_topk_small": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
    # values, rows, n, k, out values, out indices, stream
    "evox_partial_topk_small_rows": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    # values, n, k, route, scratch, its words, out values, out indices, stream
    "evox_partial_topk": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p],
}


def _function(entry: str) -> ctypes._CFuncPtr:
    fn = _kernels.get(entry)
    if fn is None:
        fn = _kernels[entry] = _build.function("topk", entry, _ENTRIES[entry])
    return fn


def _launch(values: torch.Tensor, k: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    v = values if values.is_contiguous() else values.contiguous()
    dev = v.device
    index = torch.cuda.current_device()
    if dev.index is not None and dev.index != index:
        with torch.cuda.device(dev):
            return _launch(v, k, n)
    rows = v.shape[0] if v.ndim == 2 else 1
    plan = launch_plan(n, k, rows=rows)
    out_v = v.new_empty(v.shape[:-1] + (k,))
    out_i = v.new_empty(v.shape[:-1] + (k,), dtype=torch.int32)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if plan["code"] == 0 and v.ndim == 2:
        err = _function("evox_partial_topk_small_rows")(
            v.data_ptr(), rows, n, k, out_v.data_ptr(), out_i.data_ptr(), stream)
    elif plan["code"] == 0:
        err = _function("evox_partial_topk_small")(v.data_ptr(), n, k, out_v.data_ptr(),
                                                   out_i.data_ptr(), stream)
    else:
        # kernel scratch, held until the launches are queued (stream order
        # keeps it for them after that); a batch queues a row's sequence
        # once a row on the same scratch
        words = plan["scratch_words"]
        scratch = v.new_empty((words,), dtype=torch.int32)
        err = 0
        for r in range(rows):
            err = _function("evox_partial_topk")(
                v.data_ptr() + 4 * r * n, n, k, plan["code"], scratch.data_ptr(), words,
                out_v.data_ptr() + 4 * r * k, out_i.data_ptr() + 4 * r * k, stream)
            if err:
                break
    if err:
        _build.check_launch("topk", err, "partial_topk")
    launches = 1 if plan["code"] == 0 else rows
    partial_topk.launches += launches
    nbytes, ops = topk_work(n, k, rows)
    charge("partial_topk", ops, nbytes, launches=launches)
    return out_v, out_i


def empty_launch(count: int, device: DeviceLike = None) -> None:
    """Launch an empty kernel ``count`` times, back to back from C, on
    ``device``'s current stream: CUDA events around it, over ``count``, give
    the card's floor under any call that launches (``chip_smoke.py`` records
    it beside ``partial_topk``). Counts no launch of ``partial_topk``."""
    dev = resolve_device(device)
    with torch.cuda.device(dev):
        fn = _build.function("topk", "evox_topk_empty_launch", [ctypes.c_int, ctypes.c_void_p])
        err = fn(count, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("topk", err, "empty")


def partial_topk(
    values: torch.Tensor, k: int, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact ``k`` smallest entries of ``values`` and their indices.

    Args:
        values: ``(n,)`` float32 (the minimisation-convention fitness), or
            a ``(rows, n)`` batch of such rows (what ``vmap`` of the JAX
            function takes): each row follows the 1-D contract.
        k: selection size, ``1 <= k <= n``.
        device: where ``values`` lies; ``None`` means ``"cuda"``. On
            ``cuda`` the hand kernel runs; on ``cpu``,
            ``partial_topk_reference``.

    The JAX function's ``use_kernel``, ``interpret`` and ``block_size``
    chose between its kernel and XLA and sized the TPU block; here the
    device of the tensor chooses, so none of them has a counterpart.

    ``partial_topk.launches`` counts kernel launches: one a call on the
    small route, a batch included (one grid over its rows); one a row on
    the large route.

    Returns:
        ``(values (k,) float32, indices (k,) int32)``, ascending in the
        total order of :func:`total_order_key`, ties by lowest index; a
        ``(rows, n)`` batch gives ``(rows, k)`` of each.
    """
    if is_batched(values):  # stacked members: one (rows, n) call (the vmap rule)
        return _partial_topk_op(values, k)
    # the hot path's call (no device, or the tensor's own), checked cheaply
    if values.is_cuda and (device is None or device is values.device or device == values.device):
        return _launch(values, k, _check_args(values, k))
    dev = resolve_device(device)
    n = _check_args(values, k)
    check_device(values, dev, "values")
    if dev.type == "cpu":
        return partial_topk_reference(values, k)
    if dev.type == "cuda":
        return _launch(values, k, n)
    raise ValueError(f"partial_topk runs on cuda or cpu, not {dev}")


partial_topk.launches = 0


@torch.library.custom_op("evox_torch::partial_topk", mutates_args=())
def _partial_topk_op(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    out_v, out_i = partial_topk(values, k, device=values.device)
    return out_v.clone(), out_i.clone()


@_partial_topk_op.register_vmap
def _partial_topk_vmap(info, in_dims, values: torch.Tensor, k: int):
    dim = in_dims[0]
    v = values.movedim(dim, 0) if dim is not None else values.expand(
        (info.batch_size,) + tuple(values.shape))
    lead = tuple(v.shape[:-1])
    out_v, out_i = partial_topk(v.reshape(-1, v.shape[-1]), k, device=v.device)
    return (out_v.reshape(lead + (k,)), out_i.reshape(lead + (k,))), (0, 0)
