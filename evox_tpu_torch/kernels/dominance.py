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
``csrc/dominance.cu`` (one warp per 32-row word, ``__ballot_sync`` packs
the bits; that file's header says what bounds it). On a CPU tensor it runs
``packed_dominance_reference``, the JAX package's XLA fallback in plain
PyTorch, with its chunked build above n = 20000. A CUDA tensor goes to the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.device import DeviceLike, check_device, resolve_device
from ..utils.common import dominate_relation
from . import _build

# Above this population size the dense (n, n) bool intermediate of the
# one-shot build becomes the memory wall (n=100k -> 10 GB); the chunked
# build caps it at (chunk_rows, n).
_DENSE_BUILD_MAX_N = 20_000
_BUILD_CHUNK_ROWS = 4096
# the kernel keeps a row's objectives in registers (csrc/dominance.cu)
MAX_OBJECTIVES = 32
# the weight of bit k of an int32 word
_BIT_WEIGHTS = torch.tensor([1 << k for k in range(31)] + [-(2**31)], dtype=torch.int32)


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


def _check_fitness(fitness: torch.Tensor) -> None:
    if fitness.ndim != 2 or fitness.dtype != torch.float32:
        raise ValueError(
            f"fitness must be float32 (n, m), got {fitness.dtype} {tuple(fitness.shape)}"
        )


def _launch(fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, m = fitness.shape
    if m > MAX_OBJECTIVES:
        raise ValueError(
            f"the packed_dominance kernel takes at most {MAX_OBJECTIVES} objectives, got {m}"
        )
    fit = fitness.contiguous()
    packed = torch.empty(((n + 31) // 32, n), dtype=torch.int32, device=fit.device)
    count = torch.empty((n,), dtype=torch.int32, device=fit.device)
    if n == 0:
        return packed, count
    fn = _build.function("dominance", "evox_packed_dominance", [
        ctypes.c_void_p,  # fitness (n, m) float32
        ctypes.c_int,  # n
        ctypes.c_int,  # m
        ctypes.c_void_p,  # packed (ceil(n/32), n) int32
        ctypes.c_void_p,  # count (n,) int32
        ctypes.c_void_p,  # cudaStream_t
    ])
    with torch.cuda.device(fit.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fit.data_ptr(), n, m, packed.data_ptr(), count.data_ptr(), stream)
    _build.check_launch("dominance", err, "packed_dominance")
    packed_dominance.launches += 1
    return packed, count


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
    the device of the tensor chooses, and the CUDA kernel's tiles are fixed,
    so none of them has a counterpart.

    ``packed_dominance.launches`` counts kernel launches.

    Returns:
        ``(packed, count)``: int32 ``(ceil(n/32), n)`` words (bit ``k`` of
        ``packed[w, j]``: row ``32w + k`` dominates row ``j``) and int32
        ``(n,)`` counts.
    """
    dev = resolve_device(device)
    _check_fitness(fitness)
    check_device(fitness, dev, "fitness")
    if dev.type == "cpu":
        return packed_dominance_reference(fitness)
    if dev.type == "cuda":
        return _launch(fitness)
    raise ValueError(f"packed_dominance runs on cuda or cpu, not {dev}")


packed_dominance.launches = 0
