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

``smallmm_group(products)`` runs up to four independent products in one
launch, each with its own shape and transposes and an optional row scale
of its stored ``a``: ``(a * scale[:, None])`` rounded once, then the
product, as a separate elementwise multiply rounds it. Each product's
numbers are those of its own ``smallmm`` call, bit for bit.

On a CUDA tensor both launch the hand-written kernel of
``csrc/smallmm.cu`` (that file's header says what bounds it) with the tile
:func:`launch_plan` picks; on a CPU tensor they run :func:`smallmm_plain`
(:func:`smallmm_group_plain`), the same loop over ``k`` in elementwise
PyTorch operations (and so the same numbers on the card). A CUDA tensor
goes to the kernel or raises. Under ``torch.func.vmap`` (stacked members,
:mod:`evox_tpu_torch.core.members`) each goes through a ``torch.library``
custom op whose ``vmap`` rule makes one batched launch for all members.
``smallmm.launches`` and ``smallmm_group.launches`` count launches.

The launch path is lean: the C entry points are resolved once a process,
shapes are checked in integer arithmetic, the launch plan is cached by
shape, and the ``torch.cuda.device`` context is entered only when the
operands' card is not the current one.
"""

from __future__ import annotations

import ctypes
import threading
from array import array
from functools import lru_cache
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..core.members import is_batched
from . import _build

__all__ = ["launch_plan", "smallmm", "smallmm_group", "smallmm_group_plain", "smallmm_plain",
           "smallmm_work"]

# csrc/smallmm.cu's launch plans: (outputs a thread down, across) of each
SKINNY, THIN, SQUARE, VECTOR = 0, 1, 2, 3
THREAD_TILE = {SKINNY: (2, 1), THIN: (1, 2), SQUARE: (4, 4), VECTOR: (1, 1)}
VARIANT_NAMES = {SKINNY: "skinny", THIN: "thin", SQUARE: "square", VECTOR: "vector"}
MAX_TILE = 64  # rows (columns) of a block tile at most
STAGE_K, LONG_STAGE_K, LONG_FROM = 32, 128, 256  # k a staged slice; a long sum's, from k 256
MAX_SMEM = 160 * 1024  # dynamic shared memory a block may take
COPY_THREADS = 128  # the warps that only copy, beside a small tile's computing ones
MAX_PRODUCTS = 4  # products a grouped launch takes
MAX_BATCH = 65535  # the grid's y axis
TARGET_BLOCKS = 128  # the vector plan spreads its outputs over about this many blocks
_FIELDS = 12  # int64 a product in evox_smallmm_group's table


def smallmm_work(batch: int, p: int, k: int, q: int) -> Tuple[int, int]:
    """(bytes, operations) of ``batch`` products ``(p, k) x (k, q)``: each
    operand read once and the product written once, a multiply and an add
    per term."""
    return 4 * batch * (p * k + k * q + p * q), 2 * batch * p * k * q


@lru_cache(maxsize=None)
def _plan(batch: int, p: int, k: int, q: int) -> Tuple[int, int, int]:
    """``(variant, wm, wn)``: the block's thread grid ``wm x wn``, each
    thread ``THREAD_TILE[variant]`` outputs."""
    if p == 1 or q == 1:  # one chain an output: spread them over ~128 blocks
        share = -(-TARGET_BLOCKS // batch)
        if q == 1:
            return VECTOR, min(MAX_TILE, max(1, -(-p // share))), 1
        return VECTOR, 1, min(MAX_TILE, max(1, -(-q // share)))
    if p <= 32:  # one row tile: the wide operand read once
        return SKINNY, -(-p // 2), 8
    if q <= 32:
        return THIN, 8, -(-q // 2)
    return SQUARE, 16, 16


def _threads(compute: int, slices: int) -> int:
    """A block's threads: the plan's computing warps (at least two), and
    four copying warps beside at most four computing ones whose sum takes
    more than one slice."""
    need = -(-compute // 32) * 32
    return need + COPY_THREADS if need <= COPY_THREADS and slices > 1 else max(64, need)


def launch_plan(batch: int, p: int, k: int, q: int, trans_a: bool = False,
                trans_b: bool = False, scaled: bool = False) -> dict:
    """The kernel's launch for ``batch`` products ``(p, k) x (k, q)``: the
    variant, each thread's outputs ``(tm, tn)``, the thread grid ``(wm,
    wn)``, the block tile ``(bm, bn)``, the tiles and blocks, the threads a
    block (four copying warps beside a tile of at most four computing
    ones over more than one slice), and what
    ``csrc/smallmm.cu`` derives from them and the operands' storage: whether
    each operand is staged as rows along k (``kc_a``, ``kc_b``), the steps a
    staged slice (``kslice``), the staged rows' floats ``(lda, ldb)``, the
    slices in flight and the shared memory a block."""
    variant, wm, wn = _plan(batch, p, k, q)
    tm, tn = THREAD_TILE[variant]
    bm, bn = wm * tm, wn * tn
    tiles_m, tiles_n = -(-p // bm), -(-q // bn)
    kc_a = not trans_a or (p == 1 and not scaled)  # a unit dimension: either storage
    kc_b = trans_b or q == 1
    kslice = LONG_STAGE_K if k >= LONG_FROM and variant != SQUARE else STAGE_K
    lda = kslice + 4 if kc_a else -(-bm // 4) * 4 + 4
    ldb = kslice + 4 if kc_b else -(-bn // 4) * 4 + 4
    slice_floats = (bm if kc_a else kslice) * lda + (bn if kc_b else kslice) * ldb
    most = 4 if kslice == LONG_STAGE_K or variant == SQUARE else 8
    ring = min(-(-k // kslice), most, MAX_SMEM // (4 * slice_floats))
    return {"variant": VARIANT_NAMES[variant], "tm": tm, "tn": tn, "wm": wm, "wn": wn,
            "bm": bm, "bn": bn, "tiles_m": tiles_m, "tiles_n": tiles_n,
            "blocks": tiles_m * tiles_n * batch,
            "threads": _threads(wm * wn, -(-k // kslice)),
            "kc_a": kc_a, "kc_b": kc_b, "kslice": kslice, "lda": lda, "ldb": ldb,
            "ring": ring, "smem_bytes": 4 * ring * slice_floats}


def _operands(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool):
    """``op(a)`` ``(..., p, k)`` and ``op(b)`` ``(..., k, q)`` as views."""
    return (a.transpose(-1, -2) if trans_a else a), (b.transpose(-1, -2) if trans_b else b)


def _dims(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool):
    """``(p, k, q, batch, output shape)`` from the stored shapes, or
    ``ValueError``."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"smallmm takes float32 operands, got {a.dtype} and {b.dtype}")
    sa, sb = a.shape, b.shape
    nd = len(sa)
    if nd in (2, 3) and len(sb) == nd and (nd == 2 or sa[0] == sb[0]):
        p, k = (sa[-1], sa[-2]) if trans_a else (sa[-2], sa[-1])
        kb, q = (sb[-1], sb[-2]) if trans_b else (sb[-2], sb[-1])
        if k == kb:
            if nd == 2:
                return p, k, q, 1, (p, q)
            return p, k, q, sa[0], (sa[0], p, q)
    A, B = _operands(a, b, trans_a, trans_b)
    raise ValueError(
        "smallmm takes (p, k) x (k, q) or (batch, p, k) x (batch, k, q) after the "
        f"transposes, got {tuple(A.shape)} x {tuple(B.shape)}")


def smallmm_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
                  trans_b: bool = False) -> torch.Tensor:
    """The plain version: ``op(a) @ op(b)`` summed over ``k`` in order, one
    elementwise multiply and one add a step, each rounded on its own (the
    kernel's ``__fmul_rn``/``__fadd_rn``). Batch-independent by
    construction: every output element is computed alone."""
    _dims(a, b, trans_a, trans_b)
    A, B = _operands(a, b, trans_a, trans_b)
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=torch.float32, device=a.device)
    for t in range(A.shape[-1]):
        acc = acc + A[..., :, t, None] * B[..., None, t, :]
    return acc


def _scaled(a: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The stored ``a`` with row ``r`` times ``scale[r]``, rounded once."""
    return a if scale is None else a * scale[..., :, None]


def _check_scale(scale: torch.Tensor, a: torch.Tensor, batch: int) -> None:
    want = (a.shape[-2],) if a.ndim == 2 else (batch, a.shape[-2])  # the stored a's rows
    if scale.dtype != torch.float32 or tuple(scale.shape) != want:
        raise ValueError(f"a row scale of the stored a {tuple(a.shape)} is float32 {want}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def _normalise(products: Sequence[Sequence[Any]]) -> List[Tuple[Any, ...]]:
    out = []
    for prod in products:
        if len(prod) not in (4, 5):
            raise ValueError("a product is (a, b, trans_a, trans_b) or (a, b, trans_a, trans_b, "
                             f"scale), got {len(prod)} items")
        a, b, ta, tb = prod[:4]
        out.append((a, b, bool(ta), bool(tb), prod[4] if len(prod) == 5 else None))
    if not 1 <= len(out) <= MAX_PRODUCTS:
        raise ValueError(f"smallmm_group takes 1 to {MAX_PRODUCTS} products, got {len(out)}")
    return out


def smallmm_group_plain(products: Sequence[Sequence[Any]]) -> List[torch.Tensor]:
    """The plain grouped version: each product's :func:`smallmm_plain` on
    its scaled ``a``."""
    prods = _normalise(products)
    for a, b, ta, tb, s in prods:
        if s is not None:
            _check_scale(s, a, _dims(a, b, ta, tb)[3])
    return [smallmm_plain(_scaled(a, s), b, ta, tb) for a, b, ta, tb, s in prods]


_GROUP = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table (int64), count, batch
          ctypes.c_void_p]  # cudaStream_t
_group_entry: list = []  # evox_smallmm_group, resolved once a process


def _call(index: int, table: array, count: int, batch: int) -> int:
    """``evox_smallmm_group`` on card ``index``'s current stream, entering
    the device context only when that card is not the current one."""
    if not _group_entry:
        _group_entry.append(_build.function("smallmm", "evox_smallmm_group", _GROUP))
    fn = _group_entry[0]
    if index == torch._C._cuda_getDevice():
        return fn(table.buffer_info()[0], count, batch, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(table.buffer_info()[0], count, batch, torch._C._cuda_getCurrentRawStream(index))


_local = threading.local()  # per thread: operand shapes -> a launch's fixed parts


def _single(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool) -> tuple:
    """``(output shape, table, batch, bytes, operations, k)`` of a launch
    at these operand shapes: the table holds every field of the C entry's
    row but the three pointers; ``table`` is ``None`` for an empty
    product."""
    key = (a.shape, b.shape, trans_a, trans_b)
    cache = getattr(_local, "single", None)
    if cache is None:
        cache = _local.single = {}
    hit = cache.get(key)
    if hit is None:
        p, k, q, batch, shape = _dims(a, b, trans_a, trans_b)
        table = None
        if p and q and batch and k:
            if batch > MAX_BATCH:
                raise ValueError(f"smallmm takes at most {MAX_BATCH} members, got {batch}")
            table = array("q", (0, 0, 0, 0, p, k, q, trans_a, trans_b) + _plan(batch, p, k, q))
        hit = cache[key] = (shape, table, batch, *smallmm_work(batch, p, k, q), k)
    return hit


def _launch(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool,
            index: int) -> torch.Tensor:
    if a.dtype is not torch.float32 or b.dtype is not torch.float32:
        _dims(a, b, trans_a, trans_b)  # raises
    shape, table, batch, nbytes, ops, k = _single(a, b, trans_a, trans_b)
    out = a.new_empty(shape)
    if table is None:
        return out.zero_() if k == 0 else out
    if not a.is_contiguous():
        a = a.contiguous()
    if not b.is_contiguous():
        b = b.contiguous()
    table[0], table[1], table[2] = a.data_ptr(), b.data_ptr(), out.data_ptr()
    err = _call(index, table, 1, batch)  # the entry copies the table before it returns
    if err:
        _build.check_launch("smallmm", err, "smallmm")
    smallmm.launches += 1
    charge("smallmm", ops, nbytes)
    return out


def _grouped(prods: List[Tuple[Any, ...]]) -> tuple:
    """``(output shapes, launched products, zeroed products, table, batch,
    bytes, operations)`` of a grouped launch at these operand shapes,
    cached as :func:`_single` does: ``launched`` lists the product of each
    table row (an empty product has none), ``zeroed`` those with ``k ==
    0``."""
    key = tuple([(a.shape, b.shape, ta, tb, None if s is None else s.shape)
                 for a, b, ta, tb, s in prods])
    cache = getattr(_local, "group", None)
    if cache is None:
        cache = _local.group = {}
    hit = cache.get(key)
    if hit is None:
        shapes, launched, zeroed, rows, nbytes, ops, batch = [], [], [], [], 0, 0, None
        for n, (a, b, ta, tb, s) in enumerate(prods):
            p, k, q, nb, shape = _dims(a, b, ta, tb)
            if batch is None:
                batch = nb
            elif nb != batch or (a.ndim == 3) != (prods[0][0].ndim == 3):
                raise ValueError("the products of a group share one batch")
            shapes.append(shape)
            if s is not None:
                _check_scale(s, a, nb)
            if p and q and nb:
                if not k:
                    zeroed.append(n)
                    continue
                launched.append(n)
                rows += (0, 0, 0, 0, p, k, q, ta, tb) + _plan(nb, p, k, q)
                w_bytes, w_ops = smallmm_work(nb, p, k, q)
                nbytes += w_bytes + (4 * s.numel() if s is not None else 0)
                ops += w_ops + (a.numel() if s is not None else 0)
        if batch > MAX_BATCH:
            raise ValueError(f"smallmm_group takes at most {MAX_BATCH} members, got {batch}")
        hit = cache[key] = (shapes, launched, zeroed, array("q", rows), batch, nbytes, ops)
    return hit


def _launch_group(prods: List[Tuple[Any, ...]], index: int) -> List[torch.Tensor]:
    shapes, launched, zeroed, table, batch, nbytes, ops = _grouped(prods)
    outs = [prod[0].new_empty(shape) for prod, shape in zip(prods, shapes)]
    for n in zeroed:
        outs[n].zero_()
    if not launched:
        return outs
    keep = []  # contiguous copies live until the entry has read their pointers
    f = 0
    for n in launched:
        a, b, ta, tb, s = prods[n]
        # the cache is by shape: the types are checked every call
        if a.dtype is not torch.float32 or b.dtype is not torch.float32:
            _dims(a, b, ta, tb)  # raises
        if not a.is_contiguous():
            a = a.contiguous()
            keep.append(a)
        if not b.is_contiguous():
            b = b.contiguous()
            keep.append(b)
        table[f], table[f + 1], table[f + 2] = a.data_ptr(), b.data_ptr(), outs[n].data_ptr()
        if s is None:
            table[f + 3] = 0
        else:
            if s.dtype is not torch.float32:
                _check_scale(s, a, batch)  # raises
            if not s.is_contiguous():
                s = s.contiguous()
                keep.append(s)
            table[f + 3] = s.data_ptr()
        f += _FIELDS
    err = _call(index, table, len(launched), batch)  # the entry copies the table first
    if err:
        _build.check_launch("smallmm", err, "smallmm_group")
    smallmm_group.launches += 1
    charge("smallmm_group", ops, nbytes)
    return outs


def _stacked(x: torch.Tensor, dim: Any, size: int) -> torch.Tensor:
    if dim is not None:
        return x.movedim(dim, 0)
    return x.expand((size,) + tuple(x.shape))


@torch.library.custom_op("evox_torch::smallmm", mutates_args=())
def _smallmm_op(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool) -> torch.Tensor:
    return smallmm(a, b, trans_a, trans_b, device=a.device)


@_smallmm_op.register_vmap
def _smallmm_vmap(info: Any, in_dims: Tuple[Any, ...], a: torch.Tensor, b: torch.Tensor,
                  trans_a: bool, trans_b: bool):
    A, B = _stacked(a, in_dims[0], info.batch_size), _stacked(b, in_dims[1], info.batch_size)
    lead = tuple(A.shape[:-2])
    out = smallmm(A.reshape((-1,) + tuple(A.shape[-2:])), B.reshape((-1,) + tuple(B.shape[-2:])),
                  trans_a, trans_b, device=A.device)
    return out.reshape(lead + tuple(out.shape[-2:])), 0


@torch.library.custom_op("evox_torch::smallmm_group", mutates_args=())
def _group_op(tensors: List[torch.Tensor], flags: List[int]) -> List[torch.Tensor]:
    return smallmm_group(_unpack(tensors, flags), device=tensors[0].device)


def _pack(prods: List[Tuple[Any, ...]]) -> Tuple[List[torch.Tensor], List[int]]:
    """A group as the custom op's arguments: the tensors in order (a, b and
    the scale where there is one) and three flags a product."""
    tensors, flags = [], []
    for a, b, ta, tb, s in prods:
        tensors += [a, b] + ([] if s is None else [s])
        flags += [int(ta), int(tb), int(s is not None)]
    return tensors, flags


def _unpack(tensors: List[torch.Tensor], flags: List[int]) -> List[Tuple[Any, ...]]:
    prods, i = [], 0
    for f in range(0, len(flags), 3):
        ta, tb, has_scale = flags[f:f + 3]
        prods.append((tensors[i], tensors[i + 1], bool(ta), bool(tb),
                      tensors[i + 2] if has_scale else None))
        i += 3 if has_scale else 2
    return prods


@_group_op.register_vmap
def _group_vmap(info: Any, in_dims: Tuple[Any, ...], tensors: List[torch.Tensor],
                flags: List[int]):
    phys = [_stacked(x, d, info.batch_size) for x, d in zip(tensors, in_dims[0])]
    lead = None
    prods = []
    for a, b, ta, tb, s in _unpack(phys, flags):
        lead = tuple(a.shape[:-2])
        prods.append((a.reshape((-1,) + tuple(a.shape[-2:])),
                      b.reshape((-1,) + tuple(b.shape[-2:])), ta, tb,
                      None if s is None else s.reshape((-1, s.shape[-1]))))
    outs = smallmm_group(prods, device=phys[0].device)
    return [o.reshape(lead + tuple(o.shape[-2:])) for o in outs], [0] * len(outs)


def _card(device: DeviceLike, tensors: Sequence[torch.Tensor]) -> Optional[int]:
    """The card index when every tensor lies on one card that ``device``
    (``None``, or a ``torch.device``) names: the launch needs no other
    check. ``None`` sends the call through the full checks."""
    if not (device is None or (isinstance(device, torch.device) and device.type == "cuda")):
        return None
    index = tensors[0].get_device()
    if index < 0 or any(x.get_device() != index for x in tensors[1:]):
        return None
    if device is not None and device.index not in (None, index):
        return None
    return index


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
    index = _card(device, (a, b))
    if index is not None:  # the lean path: both operands on the named card
        return _launch(a, b, trans_a, trans_b, index)
    dev = resolve_device(device)
    check_device(a, dev, "a")
    check_device(b, dev, "b")
    if dev.type == "cuda":
        return _launch(a, b, trans_a, trans_b, a.get_device())
    if dev.type == "cpu":
        return smallmm_plain(a, b, trans_a, trans_b)
    raise ValueError(f"smallmm runs on cuda or cpu, not {dev}")


smallmm.launches = 0


def smallmm_group(products: Sequence[Sequence[Any]], device: DeviceLike = None
                  ) -> List[torch.Tensor]:
    """Up to four independent products in one launch.

    Args:
        products: each ``(a, b, trans_a, trans_b)`` or ``(a, b, trans_a,
            trans_b, scale)``, with :func:`smallmm`'s operands; ``scale``
            is a float32 row scale of the stored ``a`` (``(rows,)``, or
            ``(batch, rows)`` for a batch), applied as ``a * scale[:,
            None]`` before the product. All products share one batch
            count (or none).
        device: where the operands lie; ``None`` means ``"cuda"``. On
            ``cuda`` one kernel launch; on ``cpu``,
            :func:`smallmm_group_plain`.

    Returns each product's ``(p, q)`` (or ``(batch, p, q)``) float32, in
    order, each equal bit for bit to :func:`smallmm` of its scaled ``a``.
    """
    prods = _normalise(products)
    tensors, flags = _pack(prods)
    if any(is_batched(x) for x in tensors):  # stacked members: one batched launch
        return list(_group_op(tensors, flags))
    index = _card(device, tensors)
    if index is not None:  # the lean path: every operand on the named card
        return _launch_group(prods, index)
    dev = resolve_device(device)
    for i, x in enumerate(tensors):
        check_device(x, dev, f"operand {i}")
    if dev.type == "cuda":
        return _launch_group(prods, tensors[0].get_device())
    if dev.type == "cpu":
        return smallmm_group_plain(prods)
    raise ValueError(f"smallmm_group runs on cuda or cpu, not {dev}")


smallmm_group.launches = 0
