"""Batch-invariant float32 product: kernel M1 on the card.

M1 replaces no Pallas kernel. It exists because the batch count picks
cuBLAS's kernel: CMA-ES's products under a 64-tenant ``torch.func.vmap``
rounded apart from the same tenant's solo run, so a fleet
tenant drifted from its solo run on the card. ``smallmm(a, b, trans_a,
trans_b)`` computes ``op(a) @ op(b)`` (``op`` a transpose where asked) for
``(p, k)`` and ``(k, q)`` float32 operands, or a batch of them
``(batch, p, k)``, and sums each output element over ``k`` in one fixed
order, every multiply and add rounded on its own::

    acc = 0
    for t in range(k):
        acc = acc + a[i, t] * b[t, j]

Nothing in that order depends on the batch count, so a member in a batch
of 64 equals the same member in a batch of 1 bit for bit.

On a CUDA tensor ``smallmm`` launches the hand-written kernel of
``csrc/smallmm.cu`` (that file's header says what bounds it); on a CPU
tensor it runs :func:`smallmm_plain`, the same loop over ``k`` in
elementwise PyTorch operations (and so the same numbers on the card). A
CUDA tensor goes to the kernel or raises. Under ``torch.func.vmap``
(stacked members, :mod:`evox_tpu_torch.core.members`) ``smallmm`` goes
through a ``torch.library`` custom op whose ``vmap`` rule makes one
batched launch for all members. ``smallmm.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..core.members import is_batched
from . import _build

__all__ = ["smallmm", "smallmm_plain", "smallmm_work"]

# csrc/smallmm.cu's output tile: 16 x 16 threads, one output a thread
TILE = 16


def smallmm_work(batch: int, p: int, k: int, q: int) -> Tuple[int, int]:
    """(bytes, operations) of ``batch`` products ``(p, k) x (k, q)``: each
    operand read once and the product written once, a multiply and an add
    per term."""
    return 4 * batch * (p * k + k * q + p * q), 2 * batch * p * k * q


def _operands(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool):
    """``op(a)`` ``(..., p, k)`` and ``op(b)`` ``(..., k, q)`` as views."""
    return (a.transpose(-1, -2) if trans_a else a), (b.transpose(-1, -2) if trans_b else b)


def smallmm_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
                  trans_b: bool = False) -> torch.Tensor:
    """The plain version: ``op(a) @ op(b)`` summed over ``k`` in order, one
    elementwise multiply and one add a step, each rounded on its own (the
    kernel's ``__fmul_rn``/``__fadd_rn``). Batch-independent by
    construction: every output element is computed alone."""
    A, B = _operands(a, b, trans_a, trans_b)
    _check_shapes(A, B)
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=torch.float32, device=a.device)
    for t in range(A.shape[-1]):
        acc = acc + A[..., :, t, None] * B[..., None, t, :]
    return acc


def _check_shapes(A: torch.Tensor, B: torch.Tensor) -> None:
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError(f"smallmm takes float32 operands, got {A.dtype} and {B.dtype}")
    if A.ndim not in (2, 3) or B.ndim != A.ndim or A.shape[:-2] != B.shape[:-2] \
            or A.shape[-1] != B.shape[-2]:
        raise ValueError(
            "smallmm takes (p, k) x (k, q) or (batch, p, k) x (batch, k, q) after the "
            f"transposes, got {tuple(A.shape)} x {tuple(B.shape)}")


def _launch(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool) -> torch.Tensor:
    A, B = _operands(a, b, trans_a, trans_b)
    _check_shapes(A, B)
    p, k = A.shape[-2:]
    q = B.shape[-1]
    batch = A.shape[0] if A.ndim == 3 else 1
    out = torch.empty(A.shape[:-1] + (q,), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    if batch > 65535 or -(-p // TILE) > 65535:
        raise ValueError(f"smallmm takes at most 65535 members and {65535 * TILE} rows, "
                         f"got {batch} and {p}")
    ac, bc = a.contiguous(), b.contiguous()
    fn = _build.function("smallmm", "evox_smallmm", [
        ctypes.c_void_p,  # a float32
        ctypes.c_void_p,  # b float32
        ctypes.c_void_p,  # c (batch, p, q) float32
        ctypes.c_int,  # batch
        ctypes.c_int,  # p
        ctypes.c_int,  # k
        ctypes.c_int,  # q
        ctypes.c_int,  # trans_a
        ctypes.c_int,  # trans_b
        ctypes.c_void_p,  # cudaStream_t
    ])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ac.data_ptr(), bc.data_ptr(), out.data_ptr(), batch, p, k, q,
                 int(trans_a), int(trans_b), stream)
    _build.check_launch("smallmm", err, "smallmm")
    smallmm.launches += 1
    nbytes, ops = smallmm_work(batch, p, k, q)
    charge("smallmm", ops, nbytes)
    return out


@torch.library.custom_op("evox_torch::smallmm", mutates_args=())
def _smallmm_op(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool) -> torch.Tensor:
    return smallmm(a, b, trans_a, trans_b, device=a.device)


@_smallmm_op.register_vmap
def _smallmm_vmap(info: Any, in_dims: Tuple[Any, ...], a: torch.Tensor, b: torch.Tensor,
                  trans_a: bool, trans_b: bool):
    def batched(x: torch.Tensor, dim: Any) -> torch.Tensor:
        if dim is not None:
            return x.movedim(dim, 0)
        return x.expand((info.batch_size,) + tuple(x.shape))

    A, B = batched(a, in_dims[0]), batched(b, in_dims[1])
    lead = tuple(A.shape[:-2])
    out = smallmm(A.reshape((-1,) + tuple(A.shape[-2:])), B.reshape((-1,) + tuple(B.shape[-2:])),
                  trans_a, trans_b, device=A.device)
    return out.reshape(lead + tuple(out.shape[-2:])), 0


def smallmm(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False, trans_b: bool = False,
            device: DeviceLike = None) -> torch.Tensor:
    """``op(a) @ op(b)`` with one fixed summation order (the module
    docstring).

    Args:
        a: ``(p, k)``, or ``(k, p)`` with ``trans_a``; or a batch of them.
        b: ``(k, q)``, or ``(q, k)`` with ``trans_b``; or a batch of them.
        device: where the operands lie; ``None`` means ``"cuda"``. On
            ``cuda`` the hand kernel runs; on ``cpu``, :func:`smallmm_plain`.

    Returns ``(p, q)`` (or ``(batch, p, q)``) float32.
    """
    if is_batched(a) or is_batched(b):  # stacked members: one batched launch
        return _smallmm_op(a, b, trans_a, trans_b)
    dev = resolve_device(device)
    check_device(a, dev, "a")
    check_device(b, dev, "b")
    if dev.type == "cpu":
        return smallmm_plain(a, b, trans_a, trans_b)
    if dev.type == "cuda":
        return _launch(a, b, trans_a, trans_b)
    raise ValueError(f"smallmm runs on cuda or cpu, not {dev}")


smallmm.launches = 0
