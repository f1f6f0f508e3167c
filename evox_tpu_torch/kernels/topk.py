"""Exact partial top-k (the ``k`` smallest): one CUDA kernel on the card.

The port of ``evox_tpu/kernels/topk.py``. ``partial_topk(values, k)`` returns
the ``k`` smallest entries of a float32 vector and their int32 indices,
ascending, element for element as the JAX package's
``partial_topk_reference`` (``lax.top_k(-values, k)`` negated back).

**The tie law is a total order on float bits, not ``==``.** ``lax.top_k``
ranks ``-0.0`` before ``+0.0``, NaNs with the sign bit set before ``-inf``
and NaNs without it after ``+inf``, NaNs among themselves by payload, and
equal bits by lowest index: IEEE totalOrder. ``torch.sort`` and
``jnp.argsort`` instead treat ``-0.0 == +0.0``. So both routes rank by
:func:`total_order_key`, an int32 whose signed order is that total order,
joined with the index into a unique 64-bit key.

On a CUDA tensor ``partial_topk`` launches the hand-written kernel of
``csrc/topk.cu`` (global comparison counting; that file's header says what
bounds it). On a CPU tensor it runs ``partial_topk_reference``: the same
key, one ``torch.sort`` and a slice. The JAX kernel's envelope (``k <=
block_size``, ``n < 2**24``, else a silent fallback to XLA) does not exist
here: the kernel computes the whole contract for every ``1 <= k <= n``. A
CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.device import DeviceLike, check_device, resolve_device
from . import _build

__all__ = [
    "default_use_kernel",
    "partial_topk",
    "partial_topk_reference",
    "total_order_key",
]


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
    if values.ndim != 1:
        raise ValueError(f"partial_topk takes a 1-D vector, got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise ValueError(f"partial_topk takes float32 values, got {values.dtype}")
    n = values.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if n >= 2**31:
        raise ValueError(f"partial_topk takes fewer than 2**31 values (int32 indices), got {n}")
    return n


def partial_topk_reference(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the ``k`` smallest of float32 ``values`` with their
    int32 indices, ascending, ties by lowest index under the total order of
    :func:`total_order_key`. The 64-bit key ``key * 2**32 + index`` is
    unique, so one sort fixes the order."""
    n = _check_args(values, k)
    index = torch.arange(n, dtype=torch.int64, device=values.device)
    key = total_order_key(values).to(torch.int64) * (1 << 32) + index
    order = torch.sort(key).indices[:k]
    return values[order], order.to(torch.int32)


def _launch(values: torch.Tensor, k: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    v = values.contiguous()
    rank = torch.empty((n,), dtype=torch.int32, device=v.device)  # kernel scratch
    out_v = torch.empty((k,), dtype=torch.float32, device=v.device)
    out_i = torch.empty((k,), dtype=torch.int32, device=v.device)
    fn = _build.function("topk", "evox_partial_topk", [
        ctypes.c_void_p,  # values (n,) float32
        ctypes.c_int,  # n
        ctypes.c_int,  # k
        ctypes.c_void_p,  # rank scratch (n,) int32
        ctypes.c_void_p,  # out values (k,) float32
        ctypes.c_void_p,  # out indices (k,) int32
        ctypes.c_void_p,  # cudaStream_t
    ])
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(v.data_ptr(), n, k, rank.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    _build.check_launch("topk", err, "partial_topk")
    partial_topk.launches += 1
    return out_v, out_i


def partial_topk(
    values: torch.Tensor, k: int, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact ``k`` smallest entries of ``values`` and their indices.

    Args:
        values: ``(n,)`` float32 (the minimisation-convention fitness).
        k: selection size, ``1 <= k <= n``.
        device: where ``values`` lies; ``None`` means ``"cuda"``. On
            ``cuda`` the hand kernel runs; on ``cpu``,
            ``partial_topk_reference``.

    The JAX function's ``use_kernel``, ``interpret`` and ``block_size``
    chose between its kernel and XLA and sized the TPU block; here the
    device of the tensor chooses, so none of them has a counterpart.

    ``partial_topk.launches`` counts kernel launches.

    Returns:
        ``(values (k,) float32, indices (k,) int32)``, ascending in the
        total order of :func:`total_order_key`, ties by lowest index.
    """
    dev = resolve_device(device)
    n = _check_args(values, k)
    check_device(values, dev, "values")
    if dev.type == "cpu":
        return partial_topk_reference(values, k)
    if dev.type == "cuda":
        return _launch(values, k, n)
    raise ValueError(f"partial_topk runs on cuda or cpu, not {dev}")


partial_topk.launches = 0
