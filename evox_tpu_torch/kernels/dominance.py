"""Bit-packed Pareto-dominance matrix: one CUDA kernel on the card.

The port of ``evox_tpu/kernels/dominance.py``. ``packed_dominance`` returns
``(packed, count)``: ``packed`` is ``(ceil(n/32), n)`` with bit ``k`` of
``packed[w, j]`` set iff row ``32w + k`` Pareto-dominates row ``j``
(minimisation), and ``count[j]`` is the number of rows dominating ``j``.
``non_dominated_sort`` peels its fronts off this matrix.

**Words are int32.** The JAX package stores uint32 words; PyTorch's
``torch.uint32`` has no shifts on the CPU, so the port keeps the same 32
bits in ``torch.int32`` (bit 31 is the sign bit). ``packed.numpy().view(
numpy.uint32)`` gives the JAX package's words.

On a CUDA tensor ``packed_dominance`` launches the hand-written kernel of
``csrc/dominance.cu`` (a warp compares two 32 x 32 tiles of rows and
columns for "all <=" once, each tile against the other's transpose, and
adds the words' popcounts into ``count``; that file's header says what
bounds it), on the grid that :func:`launch_plan` computes. On a CPU tensor
it runs
``packed_dominance_reference``, the JAX package's XLA fallback in plain
PyTorch, with its chunked build above n = 20000. A CUDA tensor goes to the
kernel or raises.

**Batched.** ``packed_dominance_batched`` takes ``(b, n, m)`` and returns
``(b, ceil(n/32), n)`` words and ``(b, n)`` counts, what ``vmap`` of the
JAX function gives: on the card one launch over every member's working
super-tiles (each member's words and counts those of the single-member
launch, bit for bit; a single member is the batch of one, and
:func:`launch_plan` takes smaller super-tiles, on a linear grid, where
larger ones would leave the card's SMs idle), on the CPU
``packed_dominance_batched_reference`` (the single-member plain version
stacked over members). ``packed_dominance``
called under ``torch.func.vmap`` (stacked members,
:mod:`evox_tpu_torch.core.members`) goes through a ``torch.library``
custom op whose ``vmap`` rule makes that one batched call.

**Rows form.** ``packed_dominance_rows(rows, fitness)`` compares a slab of
dominator rows ``(r, m)`` against the full fitness ``(n, m)`` and returns
the slab's ``(ceil(r/32), n)`` words and its ``(n,)`` partial counts: the
mesh-sharded sort (``operators/selection/non_dominate.py``) launches it
once a shard on the shard's ``+inf``-padded rows. In the JAX package the
slab is ``dominate_relation`` + ``pack_dominator_rows`` outside Pallas
(``evox_tpu/kernels/dominance.py:88-102``); here it is a launch of B3's
rows kernel, which tests each (slab row, column) pair once, one way
("every <=" and "some <" in one pass over the objectives; no transposed
word), with ``packed_dominance_rows_reference`` its plain version.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Any, Optional, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..core.members import is_batched
from ..utils.common import dominate_relation
from . import _build

# Above this population size the dense (n, n) bool intermediate of the
# one-shot build becomes the memory wall (n=100k -> 10 GB); the chunked
# build caps it at (chunk_rows, n).
_DENSE_BUILD_MAX_N = 20_000
_BUILD_CHUNK_ROWS = 4096
# objectives the kernel takes (csrc/dominance.cu)
MAX_OBJECTIVES = 32
# csrc/dominance.cu's block: 128 threads (4 warps, a warp a 32 x 32 tile
# pair at a time). The square and batched forms take super-tiles of 8, 4 or
# 2 words a side (the generic instance, whose rows of up to 32 objectives
# take 32 KB of shared memory at 4, 4 or 2); the rows form 8 (4 generic)
THREADS = 128
WARPS = THREADS // 32
EXACT_TILE_WORDS = 8
GENERIC_TILE_WORDS = 4
SQUARE_TILES = {True: (8, 4, 2), False: (4, 2)}  # by exact instance, largest first
# the card's SMs (an H100 SXM), and the working blocks a launch wants
# before it takes a larger super-tile: eight an SM, more than the six that
# fit at once, so the blocks' staging and flushes overlap other blocks'
# compares (tools/torch_b3_sweep.py: the fastest super-tile at every
# DOMINANCE_BATCHES shape and at n 1998, 11024 and 20000)
SM_COUNT = 132
FILL_BLOCKS = 8 * SM_COUNT
# the rows form's column words a lane (csrc/dominance.cu's RowsColumns)
ROWS_EXACT_COLUMNS = 4
ROWS_GENERIC_COLUMNS = 2
# blocks an SM the __launch_bounds__ of the exact and the generic instances
# guarantee
EXACT_MIN_BLOCKS_PER_SM = 6
GENERIC_MIN_BLOCKS_PER_SM = 8
# an H100 SM's shared memory for blocks, and what the runtime keeps a block
SM_SMEM_BYTES = 233_472
BLOCK_SMEM_RESERVED = 1024
# the weight of bit k of an int32 word
_BIT_WEIGHTS = torch.tensor([1 << k for k in range(31)] + [-(2**31)], dtype=torch.int32)


def dominance_work(n: int, m: int) -> Tuple[int, int]:
    """(bytes, operations) of the packed dominance matrix: fitness read
    once, words and counts written once; per (row, column) pair 2m compares
    and m and/or steps, about 3m operations. The bound column of PERF.md's
    kernel table and the cost analysis (``core/cost.py``) both count so."""
    n_words = (n + 31) // 32
    return 4 * (n * m + n_words * n + n), 3 * m * n * n


def dominance_compares(n: int, m: int) -> int:
    """The compares the function needs on one member of ``(n, m)``
    fitness: each of the n**2 ordered pairs compared once for "all <=" over
    the m objectives (a compare that also ANDs its predicate into the
    pair's), the strict rule coming from the transposed word. B3's batched
    bound counts them at the card's integer and compare issue rate."""
    return n * n * m


def column_popcount(words: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32: the number of set bits in each column of int32 words
    ``(n_words, n)``.

    PyTorch has no popcount. This is the SWAR popcount on the words' bytes
    (``uint8`` arithmetic, which is unsigned and cannot overflow: after the
    three steps each byte holds its own bit count), then one sum over words
    and bytes."""
    b = words.contiguous().view(torch.uint8)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    b = (b + (b >> 4)) & 0x0F
    return b.view(words.shape[0], words.shape[1], 4).sum(dim=(0, 2), dtype=torch.int32)


def pack_dominator_rows(dom: torch.Tensor, n_words: int) -> torch.Tensor:
    """Bit-pack a boolean ``(rows, n)`` dominator matrix into ``(n_words, n)``
    int32 words (bit ``k`` of word ``w`` <- row ``32w + k``); rows past
    ``rows`` are zero. Each bit is a distinct power of two (bit 31, the
    sign bit, weighs -2**31), so the int32 sum is exact in any order."""
    rows, n = dom.shape
    bits = torch.zeros((n_words * 32, n), dtype=torch.int32, device=dom.device)
    bits[:rows] = dom.to(torch.int32)
    weights = _BIT_WEIGHTS.to(dom.device)[None, :, None]
    return (bits.view(n_words, 32, n) * weights).sum(dim=1, dtype=torch.int32)


def packed_dominance_reference(
    fitness: torch.Tensor,
    n_words: Optional[int] = None,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, with the kernel's outputs.

    Builds the matrix with ``dominate_relation`` and packs it. Beyond
    ``_DENSE_BUILD_MAX_N`` rows (or with an explicit ``chunk_rows``) the
    build runs over dominator-row slabs so the boolean intermediate never
    exceeds ``(chunk_rows, n)``. ``+inf`` padding rows of the last slab
    dominate nothing, so padding only appends zero words.
    """
    n, m = fitness.shape
    if n_words is None:
        n_words = (n + 31) // 32
    if chunk_rows is None:
        chunk_rows = n if n <= _DENSE_BUILD_MAX_N else _BUILD_CHUNK_ROWS
    chunk_rows = -(-chunk_rows // 32) * 32
    if chunk_rows >= n:
        dom = dominate_relation(fitness, fitness)
        return pack_dominator_rows(dom, n_words), dom.sum(dim=0, dtype=torch.int32)

    n_chunks = -(-n // chunk_rows)
    fill = torch.full((n_chunks * chunk_rows - n, m), float("inf"), dtype=fitness.dtype,
                      device=fitness.device)
    fit_rows = torch.cat([fitness, fill])
    packed = torch.cat([
        pack_dominator_rows(
            dominate_relation(fit_rows[c * chunk_rows:(c + 1) * chunk_rows], fitness),
            chunk_rows // 32,
        )
        for c in range(n_chunks)
    ])
    built = packed.shape[0]
    if built >= n_words:
        packed = packed[:n_words]
    else:  # a caller asked for extra words: zero words, as the dense path
        extra = torch.zeros((n_words - built, n), dtype=torch.int32, device=fitness.device)
        packed = torch.cat([packed, extra])
    return packed, column_popcount(packed)


def _instance(n: int, m: int) -> Tuple[int, int]:
    """(instance, the shared-memory floats a row takes): ``m`` for the exact
    instances (m = 1..4; m 3 pads to 4), 0 for the generic one."""
    if not 1 <= m <= MAX_OBJECTIVES or n < 1:
        raise ValueError(f"packed_dominance plans n >= 1 and 1 <= m <= {MAX_OBJECTIVES}, "
                         f"got {n}, {m}")
    return (m, {1: 1, 2: 2, 3: 4, 4: 4}[m]) if m <= 4 else (0, m)


def launch_plan(n: int, m: int, b: int = 1) -> dict:
    """The square kernel's launch for ``b`` members of ``(n, m)`` fitness:
    :func:`tile_plan` at the largest super-tile of 8, 4, 2 words a side
    (4, 2 for the generic instance) that gives :data:`FILL_BLOCKS` working
    blocks, else at the smallest."""
    instance, _ = _instance(n, m)
    if b < 1:
        raise ValueError(f"packed_dominance plans b >= 1 members, got {b}")
    n_words = -(-n // 32)
    tiles = SQUARE_TILES[bool(instance)]
    tile = next((t for t in tiles if b * _per_member(n_words, t) >= FILL_BLOCKS), tiles[-1])
    return tile_plan(n, m, b, tile)


def tile_plan(n: int, m: int, b: int, tile_words: int) -> dict:
    """The square kernel's launch for ``b`` members of ``(n, m)`` fitness
    on super-tiles of ``tile_words`` x ``tile_words`` words.

    A block takes the rows of words ``[by * tile_words, ...)`` against the
    columns of words ``[bx * tile_words, ...)`` (cut at ``n_words``) and,
    from the same compares, its transpose, so only the super-tiles ``by <=
    bx`` work, a diagonal one on its tile pairs ``w <= v``. At 8 words the
    grid is the square form's ``(g, g, b)``, the blocks ``by > bx`` exiting
    at once; at 4 and 2 it is linear over every member's ``g (g + 1) / 2``
    working super-tiles, so every block works (:func:`block_tile` maps a
    block to its member and super-tile). A row takes ``stride`` floats of
    shared memory.
    """
    instance, stride = _instance(n, m)
    if b < 1:
        raise ValueError(f"packed_dominance plans b >= 1 members, got {b}")
    tiles = SQUARE_TILES[bool(instance)]
    if tile_words not in tiles:
        raise ValueError(f"packed_dominance plans super-tiles of {tiles} words at m {m}, "
                         f"got {tile_words}")
    n_words = -(-n // 32)
    g = -(-n_words // tile_words)
    per = g * (g + 1) // 2
    smem = 4 * 2 * 32 * tile_words * (stride + 1)  # two row ranges, two column counters
    return {"instance": instance, "threads": THREADS, "warps_per_block": WARPS,
            "tile_words": tile_words, "super_tiles": g, "blocks_per_member": per,
            "grid": (g, g, b) if tile_words == 8 else (b * per,), "working_blocks": b * per,
            "n_words": n_words, "stride": stride, "smem_bytes": smem,
            # the blocks an SM the __launch_bounds__ guarantee, as far as
            # the SM's shared memory allows
            "blocks_per_sm": min(EXACT_MIN_BLOCKS_PER_SM if instance else GENERIC_MIN_BLOCKS_PER_SM,
                                 SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED))}


def _per_member(n_words: int, tile_words: int) -> int:
    g = -(-n_words // tile_words)
    return g * (g + 1) // 2


def block_tile(plan: dict, block: int) -> Optional[Tuple[int, int, int]]:
    """``(member, by, bx)`` of block ``block`` of ``plan``'s grid, in launch
    order, or ``None`` for a block of the 2-D grid that exits (``by >
    bx``). On the 2-D grid a block's indices are ``(bx, by, member)``; on
    the linear grid block i is member ``i // P`` and that member's ``t =
    i % P``-th working super-tile in row order (row ``by`` holds ``g -
    by``), the last row whose first super-tile, ``by (2g - by + 1) / 2``, is
    at or before ``t``: the row ``csrc/dominance.cu`` corrects its root
    estimate to, found here by binary search."""
    g = plan["super_tiles"]
    if len(plan["grid"]) == 3:
        z, rest = divmod(block, g * g)
        by, bx = divmod(rest, g)
        return None if by > bx else (z, by, bx)
    z, t = divmod(block, plan["blocks_per_member"])
    start = lambda r: r * (2 * g - r + 1) // 2  # noqa: E731
    by, hi = 0, g - 1
    while by < hi:
        mid = (by + hi + 1) // 2
        if start(mid) <= t:
            by = mid
        else:
            hi = mid - 1
    return z, by, by + t - start(by)


def _check_fitness(fitness: torch.Tensor) -> None:
    if fitness.ndim != 2 or fitness.dtype != torch.float32:
        raise ValueError(
            f"fitness must be float32 (n, m), got {fitness.dtype} {tuple(fitness.shape)}"
        )


def kernel_occupancy(plan: dict, m: int) -> dict:
    """The runtime's blocks an SM and registers a thread of the kernel
    instance and super-tile of a ``launch_plan`` for ``m`` objectives;
    builds the kernel."""
    fn = _build.function("dominance", "evox_dominance_occupancy", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)])
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(plan["instance"], plan["tile_words"], m, ctypes.byref(blocks), ctypes.byref(regs))
    _build.check_launch("dominance", err, "occupancy query")
    return {"blocks_per_sm": blocks.value, "registers": regs.value}


@lru_cache(maxsize=None)
def _square_args(b: int, n: int, m: int) -> Tuple[int, int, int]:
    plan = launch_plan(n, m, b)
    blocks = math.prod(plan["grid"])
    if blocks > 2**31 - 1 or (len(plan["grid"]) == 3 and max(plan["grid"]) > 65535):
        raise ValueError(f"packed_dominance's grid {plan['grid']} for {b} members of n {n} "
                         f"exceeds the card's")
    return plan["instance"], plan["tile_words"], blocks


_SQUARE_ARGS = [
    ctypes.c_void_p,  # fitness (b, n, m) float32
    ctypes.c_int,  # b
    ctypes.c_int,  # n
    ctypes.c_int,  # m
    ctypes.c_void_p,  # packed (b, ceil(n/32), n) int32
    ctypes.c_void_p,  # count (b, n) int32
    ctypes.c_void_p,  # cudaStream_t
    ctypes.c_int,  # instance
    ctypes.c_int,  # super-tile words a side
    ctypes.c_int,  # the grid's blocks
]
_square_entry: list = []  # the C entry point, resolved once a process


def _launch(fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch for ``(n, m)`` or ``(b, n, m)`` fitness on the card (a
    single member is the batch of one)."""
    *lead, n, m = fitness.shape
    b = lead[0] if lead else 1
    if m > MAX_OBJECTIVES:
        raise ValueError(
            f"the packed_dominance kernel takes at most {MAX_OBJECTIVES} objectives, got {m}"
        )
    if not fitness.is_contiguous():
        fitness = fitness.contiguous()
    packed = fitness.new_empty((*lead, (n + 31) // 32, n), dtype=torch.int32)
    count = fitness.new_empty((*lead, n), dtype=torch.int32)
    if n == 0 or b == 0:
        return packed, count
    instance, tile, blocks = _square_args(b, n, m)
    if not _square_entry:
        _square_entry.append(_build.function("dominance", "evox_packed_dominance_batched",
                                             _SQUARE_ARGS))
    args = (fitness.data_ptr(), b, n, m, packed.data_ptr(), count.data_ptr())
    index = fitness.get_device()
    if index == torch._C._cuda_getDevice():  # no device context for the current card
        err = _square_entry[0](*args, torch._C._cuda_getCurrentRawStream(index), instance, tile,
                               blocks)
    else:
        with torch.cuda.device(index):
            err = _square_entry[0](*args, torch._C._cuda_getCurrentRawStream(index), instance,
                                   tile, blocks)
    if err:
        _build.check_launch("dominance", err, "packed_dominance")
    packed_dominance.launches += 1
    nbytes, ops = dominance_work(n, m)
    charge("packed_dominance", b * ops, b * nbytes)
    return packed, count


def dominance_rows_work(r: int, n: int, m: int) -> Tuple[int, int]:
    """(bytes, operations) of a slab of ``r`` dominator rows against ``n``
    columns: both row sets read once, the slab's words and counts written
    once; about 3m operations a (row, column) pair, as
    :func:`dominance_work` counts."""
    r_words = (r + 31) // 32
    return 4 * (r * m + n * m + r_words * n + n), 3 * m * r * n


def rows_launch_plan(r: int, n: int, m: int) -> dict:
    """The rows kernel's launch: :func:`launch_plan`'s instance, super-tiles
    of 8 words a side (4 for the generic instance), a grid of
    ``ceil(n_words / tile)`` x ``ceil(r_words / tile)`` blocks, every one
    of which works. A warp task is one slab word against
    ``columns_per_lane`` column words (a lane holds that many column rows),
    ``tile_words * tile_words / columns_per_lane`` tasks a block."""
    instance, _ = _instance(n, m)
    tile = EXACT_TILE_WORDS if instance else GENERIC_TILE_WORDS
    n_words, r_words = -(-n // 32), -(-r // 32)
    gx, gy = -(-n_words // tile), -(-r_words // tile)
    columns = ROWS_EXACT_COLUMNS if instance else ROWS_GENERIC_COLUMNS
    return {"instance": instance, "threads": THREADS, "tile_words": tile,
            "columns_per_lane": columns, "tasks": tile ** 2 // columns,
            "grid": (gx, gy), "working_blocks": gx * gy, "r_words": r_words, "n_words": n_words}


@lru_cache(maxsize=None)
def _rows_args(r: int, n: int, m: int) -> Tuple[int, int, int, int]:
    plan = rows_launch_plan(r, n, m)
    return plan["instance"], plan["grid"][0], plan["grid"][1], plan["columns_per_lane"]


def packed_dominance_rows_reference(rows: torch.Tensor, fitness: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain rows form: ``dominate_relation(rows, fitness)`` packed into
    ``(ceil(r/32), n)`` words, and their column popcounts."""
    packed = pack_dominator_rows(dominate_relation(rows, fitness), (rows.shape[0] + 31) // 32)
    return packed, column_popcount(packed)


_ROWS_ARGS = [
    ctypes.c_void_p,  # rows (r, m) float32
    ctypes.c_int,  # r
    ctypes.c_void_p,  # fitness (n, m) float32
    ctypes.c_int,  # n
    ctypes.c_int,  # m
    ctypes.c_void_p,  # packed (ceil(r/32), n) int32
    ctypes.c_void_p,  # count (n,) int32
    ctypes.c_void_p,  # cudaStream_t
    ctypes.c_int,  # instance
    ctypes.c_int,  # grid x
    ctypes.c_int,  # grid y
    ctypes.c_int,  # column words a lane
]
_rows_entry: list = []  # the C entry point, resolved once a process


def _launch_rows(rows: torch.Tensor, fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r, m = rows.shape
    n = fitness.shape[0]
    if m > MAX_OBJECTIVES:
        raise ValueError(
            f"the packed_dominance kernel takes at most {MAX_OBJECTIVES} objectives, got {m}"
        )
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not fitness.is_contiguous():
        fitness = fitness.contiguous()
    packed = fitness.new_empty(((r + 31) // 32, n), dtype=torch.int32)
    count = fitness.new_empty((n,), dtype=torch.int32)
    if n == 0 or r == 0:
        return packed.zero_(), count.zero_()
    instance, gx, gy, columns = _rows_args(r, n, m)
    if gy > 65535:
        raise ValueError(f"packed_dominance_rows takes at most "
                         f"{65535 * 32 * rows_launch_plan(r, n, m)['tile_words']} rows a slab, "
                         f"got {r}")
    if not _rows_entry:
        _rows_entry.append(_build.function("dominance", "evox_packed_dominance_rows", _ROWS_ARGS))
    args = (rows.data_ptr(), r, fitness.data_ptr(), n, m, packed.data_ptr(), count.data_ptr())
    index = fitness.get_device()
    if index == torch._C._cuda_getDevice():  # no device context for the current card
        err = _rows_entry[0](*args, torch._C._cuda_getCurrentRawStream(index), instance, gx, gy,
                             columns)
    else:
        with torch.cuda.device(index):
            err = _rows_entry[0](*args, torch._C._cuda_getCurrentRawStream(index), instance, gx,
                                 gy, columns)
    if err:
        _build.check_launch("dominance", err, "packed_dominance_rows")
    packed_dominance_rows.launches += 1
    nbytes, ops = dominance_rows_work(r, n, m)
    charge("packed_dominance_rows", ops, nbytes)
    return packed, count


def packed_dominance_rows(rows: torch.Tensor, fitness: torch.Tensor, device: DeviceLike = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dominance words of a slab of dominator rows against every row.

    Args:
        rows: ``(r, m)`` float32 dominator rows (a shard's slab; ``+inf``
            padding rows dominate nothing).
        fitness: ``(n, m)`` float32, the full fitness.
        device: where both lie; ``None`` means ``"cuda"``. On ``cuda`` the
            rows kernel runs; on ``cpu``, ``packed_dominance_rows_reference``.

    ``packed_dominance_rows.launches`` counts kernel launches.

    Returns:
        ``(packed, count)``: int32 ``(ceil(r/32), n)`` words (bit ``k`` of
        ``packed[w, j]``: slab row ``32w + k`` dominates row ``j``) and the
        int32 ``(n,)`` popcounts of their columns.
    """
    _check_fitness(rows)
    _check_fitness(fitness)
    if rows.shape[1] != fitness.shape[1]:
        raise ValueError(f"rows have {rows.shape[1]} objectives, fitness {fitness.shape[1]}")
    if isinstance(device, torch.device) and device.type == "cuda" and rows.is_cuda \
            and rows.get_device() == fitness.get_device() \
            and device.index in (None, rows.get_device()):
        return _launch_rows(rows, fitness)  # both on the named card: no other check
    dev = resolve_device(device)
    check_device(rows, dev, "rows")
    check_device(fitness, dev, "fitness")
    if dev.type == "cpu":
        return packed_dominance_rows_reference(rows, fitness)
    if dev.type == "cuda":
        return _launch_rows(rows, fitness)
    raise ValueError(f"packed_dominance runs on cuda or cpu, not {dev}")


packed_dominance_rows.launches = 0


def packed_dominance_batched_reference(fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain batched version: ``packed_dominance_reference`` of each
    member of ``(b, n, m)``, stacked."""
    pairs = [packed_dominance_reference(f) for f in fitness]
    return torch.stack([p for p, _ in pairs]), torch.stack([c for _, c in pairs])


def packed_dominance_batched(
    fitness: torch.Tensor, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`packed_dominance` of each member of a ``(b, n, m)`` float32
    batch: int32 ``(b, ceil(n/32), n)`` words and ``(b, n)`` counts. On
    ``cuda`` one launch for the batch (``packed_dominance.launches`` counts
    it once); on ``cpu`` ``packed_dominance_batched_reference``."""
    if fitness.ndim != 3 or fitness.dtype != torch.float32:
        raise ValueError(
            f"fitness must be float32 (b, n, m), got {fitness.dtype} {tuple(fitness.shape)}")
    if isinstance(device, torch.device) and device.type == "cuda" and fitness.is_cuda \
            and device.index in (None, fitness.get_device()):
        return _launch(fitness)  # on the named card: no other check
    dev = resolve_device(device)
    check_device(fitness, dev, "fitness")
    if dev.type == "cpu":
        return packed_dominance_batched_reference(fitness)
    if dev.type == "cuda":
        return _launch(fitness)
    raise ValueError(f"packed_dominance runs on cuda or cpu, not {dev}")


@torch.library.custom_op("evox_torch::packed_dominance", mutates_args=())
def _packed_dominance_op(fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return packed_dominance(fitness, device=fitness.device)


def _packed_dominance_vmap(info: Any, in_dims: Tuple[Any, ...], fitness: torch.Tensor):
    dim = in_dims[0]
    if dim is None:
        fitness = fitness.expand((info.batch_size,) + tuple(fitness.shape))
    elif dim:
        fitness = fitness.movedim(dim, 0)
    if fitness.ndim == 3:
        return packed_dominance_batched(fitness, device=fitness.device), (0, 0)
    lead = fitness.shape[:-2]
    packed, count = packed_dominance_batched(fitness.reshape((-1,) + tuple(fitness.shape[-2:])),
                                             device=fitness.device)
    return (packed.reshape(lead + packed.shape[1:]), count.reshape(lead + count.shape[1:])), (0, 0)


_packed_dominance_op.register_vmap(_packed_dominance_vmap)


def packed_dominance(
    fitness: torch.Tensor, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-packed dominance matrix and domination counts.

    Args:
        fitness: ``(n, m)`` float32 objectives (minimisation).
        device: where ``fitness`` lies; ``None`` means ``"cuda"``. On
            ``cuda`` the hand kernel runs; on ``cpu``,
            ``packed_dominance_reference``.

    The JAX function's ``use_pallas``, ``interpret``, ``tile_i`` and
    ``tile_j`` chose between its kernel and XLA and sized the TPU tiles; here
    the device of the tensor chooses, and the CUDA kernel's grid comes from
    :func:`launch_plan`, so none of them has a counterpart.

    ``packed_dominance.launches`` counts kernel launches.

    Returns:
        ``(packed, count)``: int32 ``(ceil(n/32), n)`` words (bit ``k`` of
        ``packed[w, j]``: row ``32w + k`` dominates row ``j``) and int32
        ``(n,)`` counts.
    """
    if is_batched(fitness):  # stacked members: one batched call (the vmap rule)
        return _packed_dominance_op(fitness)
    _check_fitness(fitness)
    if isinstance(device, torch.device) and device.type == "cuda" and fitness.is_cuda \
            and device.index in (None, fitness.get_device()):
        return _launch(fitness)  # on the named card: no other check
    dev = resolve_device(device)
    check_device(fitness, dev, "fitness")
    if dev.type == "cpu":
        return packed_dominance_reference(fitness)
    if dev.type == "cuda":
        return _launch(fitness)
    raise ValueError(f"packed_dominance runs on cuda or cpu, not {dev}")


packed_dominance.launches = 0
