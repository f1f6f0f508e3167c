"""The mesh, its shardings, the POP-sharded ES and the process layer — the
port of ``evox_tpu/core/distributed.py``.

**The mesh.** The JAX package's ``Mesh`` + ``shard_map`` is one program
that XLA partitions over devices; PyTorch has no counterpart. Here a
:class:`Mesh` is named axes over an array of ``torch.device``\\ s in which a
device may repeat: ``create_mesh(devices=["cuda:0"] * 8)`` is an 8-shard
mesh on one card (what the JAX tests do with 8 virtual CPU devices),
``create_mesh()`` a mesh over every visible card, ``create_mesh(devices=
["cpu"] * 8)`` the CPU tests' mesh. Every process runs the same program
(JAX's multi-controller model); in one process it is the only controller:

- A replicated value lives whole on the mesh's first device, its
  *controller* (on a mesh that spans processes, on each process's first
  device of the mesh).
- A value split over a mesh axis (``P(axis)``) lives as its blocks, each
  on its position's device: a :class:`ShardedTensor`. It is not a
  ``torch.Tensor``, and arithmetic on it raises, so nothing gathers it
  unseen; :meth:`ShardedTensor.gather` is the explicit, counted
  all-gather (the JAX package's ``host_value`` and replicated
  ``with_sharding_constraint``).
- :func:`shard_map` runs a per-shard function for each of this process's
  positions of the axis, in mesh order: an input specified ``P(axis)``
  enters as its position's block (a resident leaf's own block, or a block
  of rows of a whole tensor), ``P()`` whole. Each output is combined by
  its out spec: ``P(axis)`` stays resident (a :class:`ShardedTensor` of
  the blocks), ``P()`` is shard 0's, :data:`PSUM` is summed in mesh order
  (the ``psum``). Mesh order is fixed, so sums are reproducible; they can
  differ from the JAX package's only in their order.
- :func:`axis_index` inside a per-shard function is the shard's index.

So a mesh of repeated devices runs the sharded program's arithmetic on one
device (the sharded sort's row slabs, ``ShardedES``'s per-shard draws and
partial moments), and a mesh of distinct cards spreads the per-shard work
over them.

**A mesh that spans processes** (:func:`create_pod_mesh`: each process's
devices a contiguous block of positions). :func:`shard_map` runs only this
process's positions; ``P(axis)`` outputs keep this process's blocks;
``P()`` is shard 0's value, taken from the process that owns it;
:data:`PSUM` on floats gathers every shard's partial and each process adds
them in mesh order, as the single-process :func:`psum` does (the same bits);
on integers (exact in any order) each process first adds its own shards.
Every crossing is one :func:`exchange` (an all-gather of bytes) over
``torch.distributed``: under gloo, which collects
no CUDA tensor, a CUDA payload is staged through host memory explicitly,
and :func:`collective_stats` counts the calls, the bytes staged and the
ms of the staging copies. Nothing switches backend or device on its own: a
failed collective raises.

**Shardings.** :class:`P` and :class:`NamedSharding` keep the JAX names.
``field(sharding=P(POP_AXIS))`` on a state's dataclass field
(:mod:`evox_tpu_torch.core.struct`) is the per-field annotation;
:func:`annotation_specs`, :func:`state_sharding`, :func:`match_partition_rules`
and :func:`constrain_state` resolve them (rules first, then annotations),
and :func:`place_state`/:func:`place_pop` put a state's leaves on the
controller, or, on a mesh that spans processes, keep the blocks this
process's positions own as a :class:`ShardedTensor`
(:func:`ensure_global_state`).

**ShardedES** wraps a low-memory ES (``SepCMAES``, ``LMMAES``, ``RMES``):
its per-candidate fields (``sharded_pop_fields``) are born on their shards
and stay resident between generations; shard ``s`` draws its block from
``fold_in_seed(k, s)`` (the JAX package's ``fold_in(k, s)``), and the
tell weights every candidate by its global fitness rank (one stable
argsort and its inverse) and sums per-shard moments with :data:`PSUM`.
``mesh=None, n_shards=N`` runs the same law on one device, the reference
of the sharded run.

**The process layer** runs over ``torch.distributed`` (gloo on the CPU,
NCCL on cards): :func:`init_distributed` builds its store itself (a
``FileStore`` for ``file://``, a ``TCPStore`` for ``tcp://``) and
:func:`process_barrier` waits on that store's counters with a deadline,
raising :class:`BarrierTimeoutError` naming the processes that never came.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
import warnings
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

POP_AXIS = "pop"
# the second axis of a (TENANT, POP) fleet mesh (workflows/tenancy.py)
TENANT_AXIS = "tenant"

__all__ = [
    "POP_AXIS",
    "PSUM",
    "TENANT_AXIS",
    "BarrierTimeoutError",
    "Mesh",
    "NamedSharding",
    "P",
    "ShardedES",
    "ShardedTensor",
    "all_gather",
    "annotation_specs",
    "assemble_global_array",
    "axis_index",
    "axis_processes",
    "collective_stats",
    "constrain_state",
    "create_mesh",
    "create_pod_mesh",
    "dist_store",
    "ensure_global_state",
    "exchange",
    "gather_counts",
    "gather_tree",
    "host_value",
    "init_distributed",
    "is_dist_initialized",
    "local_positions",
    "match_partition_rules",
    "mesh_psum",
    "mesh_spans_processes",
    "require_single_process",
    "place_by_sharding",
    "place_pop",
    "place_state",
    "pod_devices",
    "pop_sharding",
    "process_barrier",
    "process_count",
    "process_id",
    "psum",
    "replicate",
    "replicated_sharding",
    "reset_collective_stats",
    "shard_map",
    "shard_pop",
    "shard_tensor",
    "sharded_es_tell",
    "shutdown_distributed",
    "split_rows",
    "state_sharding",
    "tree_all_gather",
    "tree_host_value",
]


# ------------------------------------------------------------------ specs


class P(tuple):
    """A partition spec: one mesh axis name (or ``None``) per leading
    dimension, as ``jax.sharding.PartitionSpec``. ``P()`` is replicated."""

    def __new__(cls, *axes: Any) -> "P":
        return tuple.__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class _Psum:
    """The out spec of a per-shard output that is summed over the shards in
    mesh order (the JAX package's ``lax.psum``)."""

    def __repr__(self) -> str:
        return "PSUM"


PSUM = _Psum()


class Mesh:
    """Named axes over an array of devices (a device may repeat).

    ``devices``: nested sequences (or an array) of ``torch.device`` or
    device strings, of the mesh's shape. ``processes`` (same shape, default
    this process everywhere): the process that owns each position, for
    meshes that span processes (:func:`create_pod_mesh`)."""

    def __init__(self, devices: Any, axis_names: Sequence[str], processes: Any = None):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        if processes is None:
            processes = np.full(arr.shape, process_id(), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(arr.shape)
        # what a shard_map call reads off the mesh, made once: the mesh
        # does not change
        self._derived: Dict[tuple, Any] = {}

    def derived(self, key: tuple, make: Callable[[], Any]) -> Any:
        """``make()`` computed once for this mesh and ``key``."""
        if key not in self._derived:
            self._derived[key] = make()
        return self._derived[key]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def controller(self) -> torch.device:
        """Where the mesh's global values live: its first device."""
        return self.devices.flat[0]

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along ``axis_name`` (the other axes at index 0), in
        mesh order: the devices of that axis's shards."""
        def make() -> List[torch.device]:
            ax = self.axis_names.index(axis_name)
            index = [0] * self.devices.ndim
            out = []
            for i in range(self.devices.shape[ax]):
                index[ax] = i
                out.append(self.devices[tuple(index)])
            return out

        return list(self.derived(("axis_devices", axis_name), make))

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape, self.axis_names,
                tuple(self.processes.flat))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: how one leaf is laid out."""

    mesh: Mesh
    spec: P

    @property
    def is_fully_replicated(self) -> bool:
        return all(ax is None for ax in self.spec)


def create_mesh(
    axis_names: Sequence[str] = (POP_AXIS,),
    devices: Optional[Sequence[Any]] = None,
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """A device mesh; by default 1-D, named ``"pop"``, over every visible
    card (raises without one: pass ``devices`` of ``"cpu"`` for a CPU mesh).
    A device may repeat: ``devices=["cuda:0"] * 8`` is 8 shards on one
    card."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {len(devices)} devices")
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def pop_sharding(mesh: Mesh, axis_name: str = POP_AXIS) -> NamedSharding:
    """Rows split over ``axis_name``."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _mesh_axis_size(mesh: Optional[Mesh], axis_name: str) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(axis_name, 1)


# ------------------------------------------------------- resident leaves


def axis_processes(mesh: Mesh, axis_name: str) -> List[int]:
    """The process that owns each position of ``axis_name`` (the other axes
    at index 0), in mesh order."""
    def make() -> List[int]:
        ax = mesh.axis_names.index(axis_name)
        return [int(p) for p in np.moveaxis(mesh.processes, ax, 0).reshape(
            mesh.devices.shape[ax], -1)[:, 0]]

    return list(mesh.derived(("axis_processes", axis_name), make))


def local_positions(mesh: Mesh, axis_name: str = POP_AXIS) -> List[int]:
    """The positions of ``axis_name`` this process runs: all of them in one
    process, its own on a mesh that spans processes."""
    me = process_id()

    def make() -> List[int]:
        owners = axis_processes(mesh, axis_name)
        if not mesh_spans_processes(mesh):
            return list(range(len(owners)))
        return [s for s, p in enumerate(owners) if p == me]

    return list(mesh.derived(("local_positions", axis_name, me), make))


_GATHERS = {"calls": 0, "bytes": 0}


def gather_counts() -> dict:
    """``{"calls", "bytes"}`` of :meth:`ShardedTensor.gather` in this
    process (the explicit all-gathers)."""
    return dict(_GATHERS)


def _refuse(name: str) -> Callable[..., Any]:
    def refuse(self: "ShardedTensor", *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"{name} on a resident leaf {self!r}: its blocks live on their shards; compute "
            "on them inside shard_map, or gather it explicitly with .gather()")

    return refuse


class ShardedTensor:
    """A value split over one mesh axis (``P(axis)``), held as its blocks.

    ``blocks`` holds one block for each of this process's positions of the
    axis (every position in one process), in mesh order, each on its
    position's device; ``positions`` names them. ``rows`` is every
    position's row count, so ``shape`` and ``dtype`` are the logical
    value's. Blocks differ in size by at most one row, as
    :func:`split_rows` cuts them.

    It is not a ``torch.Tensor``: arithmetic, indexing and torch functions
    on it raise, so no operator gathers it unseen. :meth:`gather` is the
    explicit, counted all-gather (:func:`gather_counts`; on a mesh that
    spans processes a collective every process must call);
    :meth:`map_blocks` applies a function block by block and stays
    resident. A snapshot stores the gathered value (``core/state_io.py``).
    """

    __slots__ = ("_blocks", "positions", "rows", "shape", "dtype", "mesh", "spec")

    def __init__(self, blocks: Sequence[torch.Tensor], positions: Sequence[int],
                 rows: Sequence[int], mesh: Mesh, spec: P):
        blocks, positions, rows = list(blocks), [int(s) for s in positions], [int(r) for r in rows]
        if not blocks or len(blocks) != len(positions):
            raise ValueError("a ShardedTensor needs one block for each of its positions")
        for s, b in zip(positions, blocks):
            if b.shape[0] != rows[s] or b.shape[1:] != blocks[0].shape[1:] \
                    or b.dtype != blocks[0].dtype:
                raise ValueError(f"block {s} of shape {tuple(b.shape)} {b.dtype} does not fit "
                                 f"{rows[s]} rows of {tuple(blocks[0].shape[1:])} "
                                 f"{blocks[0].dtype}")
        self._blocks = blocks
        self.positions = positions
        self.rows = rows
        self.shape = torch.Size((sum(rows),) + tuple(blocks[0].shape[1:]))
        self.dtype = blocks[0].dtype
        self.mesh = mesh
        self.spec = spec

    @classmethod
    def from_tensor(cls, x: torch.Tensor, mesh: Mesh, spec: P) -> "ShardedTensor":
        """``x`` (the whole value) cut into its blocks, this process's kept,
        each copied onto its position's device (no view keeps ``x``
        alive)."""
        axis = spec[0]
        devices = mesh.axis_devices(axis)
        parts = split_rows(x, len(devices))
        mine = local_positions(mesh, axis)
        return cls([parts[s].to(devices[s], copy=True) for s in mine], mine,
                   [p.shape[0] for p in parts], mesh, spec)

    @property
    def blocks(self) -> List[torch.Tensor]:
        """This process's blocks, in mesh order."""
        return list(self._blocks)

    @property
    def axis_name(self) -> str:
        return self.spec[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self._blocks[0].element_size()

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def block_at(self, position: int) -> torch.Tensor:
        return self._blocks[self.positions.index(position)]

    def map_blocks(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedTensor":
        """``fn`` on every block; the blocks must keep their rows."""
        return ShardedTensor([fn(b) for b in self._blocks], self.positions, self.rows,
                             self.mesh, self.spec)

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole value on ``device`` (default the controller, or this
        process's first device of the mesh): the explicit all-gather,
        counted."""
        dev = torch.device(device) if device is not None else _local_device(self.mesh)
        _GATHERS["calls"] += 1
        _GATHERS["bytes"] += self.numel() * self.element_size()
        if not mesh_spans_processes(self.mesh):
            return torch.cat([b.to(dev) for b in self._blocks])
        owners = axis_processes(self.mesh, self.axis_name)
        per_process = [0] * process_count()
        for s, p in enumerate(owners):
            per_process[p] += self.rows[s]
        width = max(per_process)
        mine = torch.cat([b.to(dev) for b in self._blocks])
        pad = mine.new_zeros((width - mine.shape[0],) + tuple(mine.shape[1:]))
        got = exchange(torch.cat([mine, pad]))
        by_position, offset = {}, [0] * len(got)
        for s, p in enumerate(owners):
            by_position[s] = got[p][offset[p]:offset[p] + self.rows[s]]
            offset[p] += self.rows[s]
        return torch.cat([by_position[s] for s in range(len(owners))])

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec!r}, positions={self.positions})")

    def __reduce__(self) -> Any:
        raise TypeError(f"a resident leaf {self!r} is not pickled: gather it explicitly")

    @classmethod
    def __torch_function__(cls, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
        raise TypeError(
            f"{getattr(func, '__name__', func)} on a resident leaf: its blocks live on their "
            "shards; compute on them inside shard_map, or gather it explicitly with .gather()")

    def __array__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError("numpy on a resident leaf: gather it explicitly with .gather()")


for _name in ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "matmul", "and", "or",
              "xor", "lshift", "rshift"):
    setattr(ShardedTensor, f"__{_name}__", _refuse(f"__{_name}__"))
    setattr(ShardedTensor, f"__r{_name}__", _refuse(f"__r{_name}__"))
for _name in ("neg", "pos", "abs", "invert", "getitem", "setitem", "lt", "le", "gt", "ge",
              "float", "int", "index", "iter"):
    setattr(ShardedTensor, f"__{_name}__", _refuse(f"__{_name}__"))


def shard_tensor(x: Any, mesh: Mesh, spec: P) -> Any:
    """``x`` resident on ``mesh`` by ``spec`` when ``spec`` splits its rows
    over an axis of the mesh (a resident leaf as it is), else ``x``."""
    if isinstance(x, ShardedTensor) or not isinstance(x, torch.Tensor):
        return x
    if not spec or spec[0] is None or spec[0] not in mesh.axis_names or x.ndim == 0:
        return x
    return ShardedTensor.from_tensor(x, mesh, spec)


# ------------------------------------------------------- the collective layer

_COLLECTIVES = {"calls": 0, "bytes": 0, "staged_bytes": 0, "staged_ms": 0.0,
                "collective_ms": 0.0}


def collective_stats() -> dict:
    """The cross-process collectives of this process: ``calls``, the bytes
    each contributed (``bytes``), the bytes staged between a card and host
    memory (``staged_bytes``: gloo collects no CUDA tensor), the host ms of
    those staging copies (``staged_ms``, each waited for) and of the
    collectives themselves (``collective_ms``)."""
    return dict(_COLLECTIVES)


def reset_collective_stats() -> None:
    for k in _COLLECTIVES:
        _COLLECTIVES[k] = 0.0 if k.endswith("_ms") else 0


def _staged(t: torch.Tensor) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend() == "gloo"


def exchange(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype in every process), in
    process order, on ``t``'s device: an ``all_gather`` of its bytes (so
    every dtype crosses bit for bit). Under gloo a CUDA ``t`` is copied to
    pinned host memory and the results back, counted in
    :func:`collective_stats`."""
    import torch.distributed as dist

    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    staged = _staged(t)
    t0 = time.perf_counter()
    if staged:
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    t1 = time.perf_counter()
    outs = [torch.empty_like(flat) for _ in range(process_count())]
    dist.all_gather(outs, flat)
    t2 = time.perf_counter()
    if staged:
        outs = [o.to(t.device) for o in outs]
        torch.cuda.synchronize(t.device)
    t3 = time.perf_counter()
    _COLLECTIVES["calls"] += 1
    _COLLECTIVES["bytes"] += flat.numel()
    _COLLECTIVES["collective_ms"] += (t2 - t1) * 1e3
    if staged:
        _COLLECTIVES["staged_bytes"] += flat.numel() * (1 + len(outs))
        _COLLECTIVES["staged_ms"] += (t1 - t0 + t3 - t2) * 1e3
    return [o.view(t.dtype).reshape(t.shape) for o in outs]


def mesh_psum(parts: Dict[int, torch.Tensor], mesh: Mesh, axis_name: str = POP_AXIS,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum over every position of ``axis_name`` of the partials this
    process computed (``{position: partial}``), in mesh order, on
    ``device`` (default the controller): :func:`psum` in one process. On a
    mesh that spans processes a float partial of every position is
    gathered and the sum taken in mesh order, the same bits as in one
    process; an integer sum (exact in any order) adds this process's
    partials first and gathers one a process."""
    dev = _local_device(mesh) if device is None else device
    if not mesh_spans_processes(mesh):
        return psum([parts[s] for s in sorted(parts)], dev)
    owners = axis_processes(mesh, axis_name)
    mine = sorted(parts)
    first = parts[mine[0]]
    if not (first.is_floating_point() or first.is_complex()):
        return psum(exchange(psum([parts[s] for s in mine], dev)), dev)
    counts = {p: owners.count(p) for p in set(owners)}
    if len(set(counts.values())) > 1:
        raise ValueError(f"a float PSUM over processes needs equal positions a process, got "
                         f"{counts}")
    got = exchange(torch.stack([parts[s] for s in mine]))
    taken = [0] * len(got)
    ordered = []
    for p in owners:
        ordered.append(got[p][taken[p]])
        taken[p] += 1
    return psum(ordered, dev)


# ------------------------------------------------------- per-shard programs

_shard_ctx = threading.local()


def axis_index(axis_name: str = POP_AXIS) -> int:
    """The index of the shard whose per-shard function is running, inside
    :func:`shard_map`."""
    stack = getattr(_shard_ctx, "stack", None)
    if not stack:
        raise RuntimeError("axis_index() is only defined inside shard_map")
    name, index = stack[-1]
    if name != axis_name:
        raise ValueError(f"shard_map runs over {name!r}, not {axis_name!r}")
    return index


def current_position() -> Optional[int]:
    """The position of the per-shard function running in this thread
    (``None`` outside :func:`shard_map`): where ``core/cost.py`` counts the
    memory it makes."""
    stack = getattr(_shard_ctx, "stack", None)
    return stack[-1][1] if stack else None


def split_rows(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``x``'s leading axis in ``n`` blocks, in order; the blocks differ in
    size by at most one row where ``n`` does not divide it."""
    return list(torch.tensor_split(x, n, dim=0))


def _is_leaf_spec(spec: Any) -> bool:
    return spec is None or spec is PSUM or isinstance(spec, P)


def _is_value(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor))


def _map_spec(fn: Callable[[Any, Any], Any], spec: Any, tree: Any) -> Any:
    """``fn(spec, leaf)`` over ``tree``'s tensors and resident leaves,
    where ``spec`` is one spec for the whole tree or a tree of specs of
    ``tree``'s shape (dicts, lists, tuples and states; any other leaf maps
    to ``None``)."""
    if _is_value(tree):
        return fn(spec if _is_leaf_spec(spec) else None, tree)
    whole = _is_leaf_spec(spec)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, spec if whole else spec[k], tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_spec(fn, spec if whole else spec[i], t) for i, t in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_spec(fn, spec if whole else getattr(spec, f.name), getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return None


def _map_leaves(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over ``tree``'s tensors; resident leaves stay as they are."""
    from .struct import map_tensors

    return map_tensors(fn, tree, resident="keep")


class _Combiner:
    """How :func:`shard_map` combines one call's outputs: this process's
    ``positions`` of the axis, their devices, the global value's device
    and the row counts of the first split input (``hint``), which a
    ``P(axis)`` output that keeps its input's rows takes as its own."""

    def __init__(self, mesh: Mesh, axis_name: str, positions: List[int], hint: Optional[list]):
        self.mesh, self.axis_name, self.positions, self.hint = mesh, axis_name, positions, hint
        self.spans = mesh_spans_processes(mesh)
        self.device = _local_device(mesh)

    def rows(self, parts: List[torch.Tensor]) -> List[int]:
        local = [p.shape[0] for p in parts]
        if not self.spans:
            return local
        hint = self.hint
        if hint is not None:
            if [hint[s] for s in self.positions] != local:
                raise ValueError(
                    f"a P({self.axis_name!r}) output's blocks have {local} rows where the split "
                    f"input's have {[hint[s] for s in self.positions]}: over processes an output "
                    "keeps its input's rows, or has no split input")
            return list(hint)
        # each position's rows from the process that owns it: zeros elsewhere
        counts = torch.zeros(len(axis_processes(self.mesh, self.axis_name)), dtype=torch.int64,
                             device=self.device)
        counts[self.positions] = torch.tensor(local, dtype=torch.int64, device=self.device)
        return [int(r) for r in torch.stack(exchange(counts)).sum(0).tolist()]

    def leaf(self, spec: Any, parts: List[torch.Tensor]) -> Any:
        if spec is PSUM:
            return mesh_psum(dict(zip(self.positions, parts)), self.mesh, self.axis_name,
                             self.device)
        if spec is not None and self.axis_name in spec:
            return ShardedTensor(parts, self.positions, self.rows(parts), self.mesh,
                                 P(self.axis_name))
        if not self.spans:
            return parts[0].to(self.device)
        # shard 0's value, from the process that owns it (every process's
        # first position made a value of the same shape)
        owner = axis_processes(self.mesh, self.axis_name)[0]
        return exchange(parts[0])[owner].to(self.device)

    def combine(self, spec: Any, parts: List[Any]) -> Any:
        p0, whole = parts[0], _is_leaf_spec(spec)
        if isinstance(p0, torch.Tensor):
            return self.leaf(spec if whole else None, parts)
        if isinstance(p0, dict):
            return {k: self.combine(spec if whole else spec[k], [p[k] for p in parts]) for k in p0}
        if isinstance(p0, (list, tuple)):
            return type(p0)(self.combine(spec if whole else spec[i], [p[i] for p in parts])
                            for i in range(len(p0)))
        if dataclasses.is_dataclass(p0) and not isinstance(p0, type):
            return dataclasses.replace(p0, **{
                f.name: self.combine(spec if whole else getattr(spec, f.name),
                                     [getattr(p, f.name) for p in parts])
                for f in dataclasses.fields(p0)})
        return p0


def shard_map(fn: Callable[..., Any], mesh: Mesh, in_specs: Sequence[Any], out_specs: Any,
              axis_name: str = POP_AXIS) -> Callable[..., Any]:
    """``fn`` run once for each of this process's positions of
    ``axis_name``, in mesh order, on its position's device (module
    docstring). ``in_specs``: one spec (or tree of specs) per argument; a
    ``P(axis)`` argument may be a :class:`ShardedTensor` on this axis (its
    blocks enter as they are) or a whole tensor (cut into blocks); a
    resident leaf under any other spec raises. ``out_specs``: one for the
    output (``P(axis)``: resident, ``P()`` or :data:`PSUM`)."""
    n = _mesh_axis_size(mesh, axis_name)
    devices = mesh.axis_devices(axis_name)
    positions = local_positions(mesh, axis_name)

    def run(*args: Any) -> Any:
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map got {len(args)} arguments for {len(in_specs)} specs")
        hints: List[list] = []

        def split(spec: Any, x: Any) -> Any:
            splits = spec is not None and spec is not PSUM and axis_name in spec
            if isinstance(x, ShardedTensor):
                if not splits or x.axis_name != axis_name or len(x.rows) != n:
                    raise ValueError(
                        f"shard_map over {axis_name!r} ({n} positions) got a resident leaf "
                        f"{x!r} under {spec!r}: gather it explicitly for a replicated input")
                hints.append(x.rows)
                return {s: x.block_at(s) for s in positions}
            if not splits:
                return None
            parts = split_rows(x, n)
            hints.append([p.shape[0] for p in parts])
            return {s: parts[s] for s in positions}

        blocks = [_map_spec(split, spec, arg) for spec, arg in zip(in_specs, args)]
        outs = []
        stack = _shard_ctx.__dict__.setdefault("stack", [])
        for s in positions:
            local = [_local(arg, blk, s, devices[s]) for arg, blk in zip(args, blocks)]
            stack.append((axis_name, s))
            try:
                outs.append(fn(*local))
            finally:
                stack.pop()
        combiner = _Combiner(mesh, axis_name, positions, hints[0] if hints else None)
        return combiner.combine(out_specs, outs)

    return run


def _local(arg: Any, blocks: Any, s: int, dev: torch.device) -> Any:
    """Shard ``s``'s view of one argument: its block of each split leaf,
    the whole of each replicated one, on ``dev``."""
    if _is_value(arg):
        return (blocks[s] if blocks is not None else arg).to(dev)
    if isinstance(arg, dict):
        return {k: _local(arg[k], blocks[k], s, dev) for k in arg}
    if isinstance(arg, (list, tuple)):
        return type(arg)(_local(a, b, s, dev) for a, b in zip(arg, blocks))
    if dataclasses.is_dataclass(arg) and not isinstance(arg, type):
        return dataclasses.replace(arg, **{
            f.name: _local(getattr(arg, f.name), getattr(blocks, f.name), s, dev)
            for f in dataclasses.fields(arg)})
    return arg


def psum(parts: Sequence[torch.Tensor], device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of per-shard partials in mesh order (``parts[0]`` first) on
    ``device`` (default ``parts[0]``'s): a fixed order, so the same every
    run."""
    dev = parts[0].device if device is None else device
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def all_gather(parts: Sequence[torch.Tensor], device: Optional[torch.device] = None
               ) -> torch.Tensor:
    """Per-shard blocks concatenated along their leading axis in mesh order,
    on ``device`` (default ``parts[0]``'s): the tiled ``lax.all_gather``."""
    dev = parts[0].device if device is None else device
    return torch.cat([p.to(dev) for p in parts])


def gather_tree(tree: Any, device: Optional[torch.device] = None) -> Any:
    """``tree`` with every resident leaf gathered (:meth:`ShardedTensor.
    gather`, counted)."""
    from .struct import map_tensors

    return map_tensors(lambda x: x.gather(device) if isinstance(x, ShardedTensor) else x, tree,
                       resident="leaf")


def tree_all_gather(trees: Sequence[Any], device: Optional[torch.device] = None) -> Any:
    """:func:`all_gather` leaf by leaf over per-shard trees of one shape (a
    resident leaf of them gathered first)."""
    trees = [gather_tree(t, device) for t in trees]
    dev = device if device is not None else _first_device(trees[0])

    def cat(*leaves: Any) -> Any:
        return all_gather(list(leaves), dev)

    return _zip_trees(cat, trees)


def _zip_trees(fn: Callable[..., Any], trees: List[Any]) -> Any:
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _zip_trees(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_zip_trees(fn, [t[i] for t in trees]) for i in range(len(t0)))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: _zip_trees(fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)})
    return t0


def _first_device(tree: Any) -> torch.device:
    from .struct import named_leaves

    for _, leaf in named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


# ------------------------------------------------------- state layouts


def _rule_resolver(rules: Optional[Sequence[Tuple[str, P]]]):
    if not rules:
        return lambda path, leaf: None
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def resolve(path: str, leaf: Any) -> Optional[P]:
        if getattr(leaf, "ndim", None) == 0:
            return P()
        for pat, spec in compiled:
            if pat.search(path) is not None:
                return spec
        return None

    return resolve


def _prefix_spec(spec: P, leaf: Any, axis_prefix: Optional[str]) -> P:
    """``spec`` shifted one axis right under ``axis_prefix`` (a stacked
    state's leading member axis); leaves too narrow fall back to the prefix
    alone, or to replicated for scalars."""
    if axis_prefix is None or axis_prefix in spec:
        return spec
    ndim = getattr(leaf, "ndim", 0)
    if ndim < 1 + len(spec):
        return P(axis_prefix) if ndim >= 1 else P()
    return P(axis_prefix, *spec)


def _walk(tree: Any, fn: Callable[[str, torch.Tensor, Any], Any], path: str = "",
          spec: Any = None) -> Any:
    """``tree`` with ``fn(path, tensor, annotated_spec)`` at each tensor
    leaf; ``annotated_spec`` is the deepest ``field(sharding=...)`` along
    the path (``spec`` where none); a resident leaf is a leaf."""
    if _is_value(tree):
        return fn(path, tree, spec)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {}
        for f in dataclasses.fields(tree):
            inner = f.metadata.get("sharding", spec)
            changes[f.name] = _walk(getattr(tree, f.name), fn, f"{path}.{f.name}", inner)
        return dataclasses.replace(tree, **changes)
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}[{k!r}]", spec) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_walk(v, fn, f"{path}[{i}]", spec) for i, v in enumerate(tree))
    return tree


def match_partition_rules(rules: Sequence[Tuple[str, P]], tree: Any, default: Optional[P] = None,
                          strict: bool = False) -> Any:
    """A tree of ``P`` over ``tree``'s tensor leaves assigned by regex rules
    over the leaves' paths (``named_leaves`` form, ``re.search``; the first
    match wins). 0-d leaves resolve to ``P()``; unmatched leaves get
    ``default``, or raise with ``strict``."""
    resolve = _rule_resolver(rules)

    def assign(path: str, leaf: torch.Tensor, _: Any) -> Optional[P]:
        if leaf.ndim == 0:
            return P()
        spec = resolve(path, leaf)
        if spec is not None:
            return spec
        if strict:
            raise ValueError(f"no partition rule matched leaf {path!r}")
        return default

    return _walk(tree, assign)


def annotation_specs(state: Any, default: P = P()) -> Any:
    """A tree of ``P`` over ``state``'s tensor leaves from the per-field
    ``field(sharding=...)`` annotations alone (``default`` elsewhere)."""
    return _walk(state, lambda path, leaf, spec: default if spec is None else spec)


def state_sharding(state: Any, mesh: Mesh, default: Optional[P] = None,
                   rules: Optional[Sequence[Tuple[str, P]]] = None,
                   axis_prefix: Optional[str] = None) -> Any:
    """A tree of :class:`NamedSharding` over ``state``'s tensor leaves:
    rules first, then annotations, then ``default`` (replicated), each
    shifted under ``axis_prefix``."""
    default = P() if default is None else default
    rule_spec = _rule_resolver(rules)

    def resolve(path: str, leaf: torch.Tensor, spec: Any) -> NamedSharding:
        got = rule_spec(path, leaf)
        if got is None:
            got = default if spec is None else spec
        return NamedSharding(mesh, _prefix_spec(got, leaf, axis_prefix))

    return _walk(state, resolve)


def constrain_state(state: Any, mesh: Optional[Mesh], policy: Any = None,
                    rules: Optional[Sequence[Tuple[str, P]]] = None,
                    axis_prefix: Optional[str] = None) -> Any:
    """The end-of-step boundary: storage-annotated float leaves cast to a
    ``DtypePolicy``'s storage dtype (``policy`` may be ``None``), and on a
    mesh every leaf placed by its resolved layout (:func:`place_state`)."""
    from .dtype_policy import apply_storage

    state = apply_storage(state, policy)
    if mesh is None:
        return state
    return place_state(state, mesh, rules=rules, axis_prefix=axis_prefix)


def _process_block(leaf: Any, sharding: NamedSharding) -> Any:
    """A leaf on a mesh that spans processes: split over a mesh axis, the
    blocks this process's positions own (a :class:`ShardedTensor`);
    replicated, whole on this process's device (a resident leaf
    gathered)."""
    mesh, spec = sharding.mesh, sharding.spec
    if not spec or spec[0] is None:
        return leaf.gather() if isinstance(leaf, ShardedTensor) else leaf.to(_local_device(mesh))
    if isinstance(leaf, ShardedTensor):
        return leaf
    out = shard_tensor(leaf, mesh, P(spec[0]))
    return out if isinstance(out, ShardedTensor) else out.to(_local_device(mesh))


def place_state(state: Any, mesh: Optional[Mesh], rules: Optional[Sequence[Tuple[str, P]]] = None,
                axis_prefix: Optional[str] = None) -> Any:
    """Eager placement of every leaf by its resolved layout: on the mesh's
    controller (where global values live; a resident leaf stays on its
    shards); on a mesh that spans processes, :func:`ensure_global_state`.
    ``None`` mesh: unchanged."""
    if mesh is None:
        return state
    if mesh_spans_processes(mesh):
        return ensure_global_state(state, mesh, rules=rules, axis_prefix=axis_prefix)
    return _map_leaves(lambda x: x.to(mesh.controller), state)


def place_by_sharding(state: Any, shardings: Any) -> Any:
    """Every leaf placed by its :class:`NamedSharding` in ``shardings`` (a
    tree over the state's leaves, :func:`state_sharding`'s form): on its
    mesh's controller, or this process's rows on a mesh that spans
    processes (:func:`_process_block`)."""
    def place(path: str, leaf: Any, _: Any) -> Any:
        sh = _leaf_at(shardings, path)
        if mesh_spans_processes(sh.mesh):
            return _process_block(leaf, sh)
        if isinstance(leaf, ShardedTensor):
            return leaf
        return leaf.to(sh.mesh.controller)

    return _walk(state, place)


def shard_pop(tree: Any, mesh: Optional[Mesh], axis_name: str = POP_AXIS) -> Any:
    """Every leaf laid out with its leading axis over ``axis_name``: placed
    on the controller, from where :func:`shard_map` splits it (``None``
    mesh: unchanged)."""
    return place_pop(tree, mesh, axis_name)


def replicate(tree: Any, mesh: Optional[Mesh]) -> Any:
    """Every leaf replicated over the mesh: placed on the controller."""
    if mesh is None:
        return tree
    return _map_leaves(lambda x: x.to(mesh.controller), tree)


def place_pop(tree: Any, mesh: Optional[Mesh], axis_name: str = POP_AXIS) -> Any:
    """Eager placement of a population tree; on a mesh that spans
    processes each process keeps the blocks its positions own (a
    :class:`ShardedTensor` a leaf)."""
    if mesh is None:
        return tree
    if mesh_spans_processes(mesh):
        sh = pop_sharding(mesh, axis_name)
        return _map_leaves(lambda x: _process_block(x, sh), tree)
    return _map_leaves(lambda x: x.to(mesh.controller), tree)


def _local_device(mesh: Mesh) -> torch.device:
    me = process_id()

    def make() -> torch.device:
        for d, p in zip(mesh.devices.flat, mesh.processes.flat):
            if int(p) == me:
                return d
        raise ValueError("the mesh holds no device of this process")

    return mesh.derived(("local_device", me), make)


def assemble_global_array(host_arr: Any, sharding: NamedSharding) -> torch.Tensor:
    """A leaf on ``sharding`` from a full host value every process holds:
    on a mesh that spans processes, this process's blocks (or the whole
    value, replicated); else the whole value on the controller."""
    mesh = sharding.mesh
    x = torch.as_tensor(np.asarray(host_arr))
    return _process_block(x, sharding) if mesh_spans_processes(mesh) else x.to(mesh.controller)


def ensure_global_state(state: Any, mesh: Optional[Mesh], default: Optional[P] = None,
                        rules: Optional[Sequence[Tuple[str, P]]] = None,
                        axis_prefix: Optional[str] = None) -> Any:
    """Per-process assembly of an eagerly built state over a mesh that spans
    processes: each leaf split over a process-spanning axis keeps this
    process's blocks (a :class:`ShardedTensor`), every other leaf stays
    whole on this process's device. No-op when the mesh does not span
    processes."""
    if not mesh_spans_processes(mesh):
        return state
    shardings = state_sharding(state, mesh, default=default, rules=rules,
                               axis_prefix=axis_prefix)

    def place(path: str, leaf: Any, _: Any) -> Any:
        return _process_block(leaf, _leaf_at(shardings, path))

    return _walk(state, place)


def _leaf_at(tree: Any, path: str) -> Any:
    for p, leaf in _named_any(tree):
        if p == path:
            return leaf
    raise KeyError(path)


def _named_any(tree: Any, prefix: str = "") -> list:
    """``[(path, leaf)]`` over a tree whose leaves may be any object (the
    trees of specs and shardings these functions build)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, (type, NamedSharding)):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _named_any(getattr(tree, f.name), f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _named_any(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [leaf for i, v in enumerate(tree) for leaf in _named_any(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def host_value(x: Any) -> np.ndarray:
    """The full host (numpy) value of ``x``: a resident leaf gathered
    (:meth:`ShardedTensor.gather`, a collective over processes on a mesh
    that spans them: every process must call it)."""
    if isinstance(x, ShardedTensor):
        return x.gather().detach().cpu().numpy()
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    return x.detach().cpu().numpy()


def tree_host_value(tree: Any) -> Any:
    """:func:`host_value` over every tensor leaf of ``tree``."""
    return _walk(tree, lambda path, leaf, _: host_value(leaf))


# ------------------------------------------- the POP-sharded low-memory ES


def _require_shard_protocol(algorithm: Any) -> None:
    missing = [name for name in ("ask_rows", "rank_weights", "pop_moments", "tell_with_moments")
               if not callable(getattr(algorithm, name, None))]
    if missing or not getattr(algorithm, "pop_shard_capable", False):
        raise TypeError(
            f"{type(algorithm).__name__} does not implement the POP-sharded low-memory ES "
            "protocol (pop_shard_capable + ask_rows/rank_weights/pop_moments/"
            "tell_with_moments); capable algorithms: the low-memory CMA track (SepCMAES, "
            "LMMAES, RMES)" + (f"; missing: {missing}" if missing else ""))


def global_ranks(fitness: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, ranks)``: one stable argsort of ``fitness`` and its inverse
    (each candidate's 0-based rank; ties by index, as the sorted
    selection)."""
    order = torch.argsort(fitness, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return order, ranks


def sharded_es_tell(algorithm: Any, state: Any, fitness: Any, mesh: Mesh,
                    axis_name: str = POP_AXIS) -> Any:
    """One tell over a POP-sharded sample matrix: global ranks from the
    whole fitness (a resident fitness gathered first: every process needs
    it), then per shard the partial moments of its rows (read where they
    are resident) weighted by their ranks' weights, summed over the shards
    in mesh order; the small strategy update (``tell_with_moments``) runs
    on the sums."""
    if isinstance(fitness, ShardedTensor):
        fitness = fitness.gather()
    if fitness.ndim != 1:
        raise ValueError(f"sharded_es_tell is single-objective; got fitness {tuple(fitness.shape)}")
    fields = tuple(algorithm.sharded_pop_fields)
    rows = {name: getattr(state, name) for name in fields}
    order, ranks = global_ranks(fitness)

    def island(rows_local: dict, ranks_local: torch.Tensor) -> dict:
        return algorithm.pop_moments(rows_local, algorithm.rank_weights(ranks_local))

    moments = shard_map(island, mesh, ({name: P(axis_name) for name in fields}, P(axis_name)),
                        PSUM, axis_name)(rows, ranks)
    moments = dict(moments, f_sel=fitness[order[: algorithm.mu]])
    return algorithm.tell_with_moments(state, moments, fitness)


class ShardedES:
    """A low-memory ES (``SepCMAES``, ``LMMAES``, ``RMES``) whose
    per-candidate arrays are POP-sharded: per-shard draws in ``ask``,
    rank-weighted partial moments summed over the shards in ``tell``
    (:func:`sharded_es_tell`). Attribute reads forward to the wrapped
    algorithm, so it drops into ``StdWorkflow``.

    On a mesh the ``sharded_pop_fields`` are resident: born on their
    shards (:meth:`init`), kept there between generations, and ``ask``
    returns the population as a :class:`ShardedTensor`; no step gathers a
    ``(pop, dim)`` value. On a mesh that spans processes each process
    draws, keeps and reads only its own blocks; the fitness and the
    moments cross processes (:func:`sharded_es_tell`).

    Sampling law: ``ask`` splits the state's seed once (``seed, k``), then
    shard ``s`` draws its block of ``pop / n_shards`` rows from
    ``fold_in_seed(k, s)`` through ``ask_rows`` (the algorithm's one
    ``_draw``). On the mesh each shard draws on its own device;
    ``mesh=None`` with ``n_shards=N`` concatenates the same blocks on one
    device, the reference of the sharded run (equal samples; the states
    differ by summation order only, since that side's tell is the wrapped
    algorithm's sorted selection). ``mesh=None, n_shards=1`` is the wrapped
    algorithm, bit for bit.

    Args:
        algorithm: a ``pop_shard_capable`` algorithm; its pop size must be
            divisible by ``n_shards``.
        mesh: a mesh with an ``axis_name`` axis, or ``None``.
        axis_name: the mesh axis the population is split over.
        n_shards: the sampling law's shard count; defaults to the mesh's
            ``axis_name`` size (1 without a mesh). A multiple of that size
            makes each shard draw ``n_shards / size`` consecutive blocks.
    """

    is_pop_sharded = False

    def __init__(self, algorithm: Any, mesh: Optional[Mesh] = None, axis_name: str = POP_AXIS,
                 n_shards: Optional[int] = None):
        _require_shard_protocol(algorithm)
        if getattr(algorithm, "has_init_ask", False) or getattr(algorithm, "has_init_tell", False):
            raise TypeError("ShardedES supports steady-state ask/tell algorithms only "
                            f"({type(algorithm).__name__} declares init_ask/init_tell)")
        self.algorithm = algorithm
        self.mesh = mesh
        self.axis_name = axis_name
        if n_shards is None:
            n_shards = _mesh_axis_size(mesh, axis_name) if mesh is not None else 1
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if mesh is not None and self.n_shards % _mesh_axis_size(mesh, axis_name):
            raise ValueError(
                f"n_shards={self.n_shards} is not a multiple of the mesh's '{axis_name}' axis "
                f"({_mesh_axis_size(mesh, axis_name)}); the per-shard sampling law needs whole "
                "blocks per device")
        if int(algorithm.pop_size) % self.n_shards:
            raise ValueError(f"pop_size {algorithm.pop_size} is not divisible by "
                             f"n_shards={self.n_shards}")
        self.is_pop_sharded = mesh is not None

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") or name == "algorithm":
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "algorithm"), name)

    @property
    def has_init_ask(self) -> bool:
        return False

    @property
    def has_init_tell(self) -> bool:
        return False

    def init(self, seed: int) -> Any:
        """The wrapped algorithm's state, its ``sharded_pop_fields`` born on
        their shards: each position's block made on its device (the whole
        value, made once on the controller, dropped), and the rest placed
        as :func:`place_state` places it."""
        state = place_state(self.algorithm.init(seed), self.mesh)
        return self.resident(state)

    def resident(self, state: Any) -> Any:
        """``state`` with its ``sharded_pop_fields`` resident on the mesh
        (a whole leaf, as a restored snapshot holds it, cut into its
        blocks); unchanged without a mesh."""
        if self.mesh is None:
            return state
        spec = P(self.axis_name)
        return state.replace(**{name: shard_tensor(getattr(state, name), self.mesh, spec)
                                for name in self.algorithm.sharded_pop_fields})

    def _blocks(self, state: Any, k: int, first: int, count: int, shard: int):
        """Blocks ``first .. first + count - 1`` of the sampling law,
        concatenated: ``(pop rows, {field: rows})``."""
        from ..utils.common import fold_in_seed

        pops, arts = [], []
        for b in range(first, first + count):
            p, a = self.algorithm.ask_rows(state, fold_in_seed(k, b), shard)
            pops.append(p)
            arts.append(a)
        fields = tuple(self.algorithm.sharded_pop_fields)
        return torch.cat(pops), {name: torch.cat([a[name] for a in arts]) for name in fields}

    def ask(self, state: Any) -> Tuple[torch.Tensor, Any]:
        from ..utils.common import split_seed

        if self.mesh is None and self.n_shards == 1:
            return self.algorithm.ask(state)
        seed, k = split_seed(state.seed)
        shard = int(self.algorithm.pop_size) // self.n_shards
        if self.mesh is None:
            pop, art = self._blocks(state, k, 0, self.n_shards, shard)
            return pop, state.replace(seed=seed, **art)
        per = self.n_shards // _mesh_axis_size(self.mesh, self.axis_name)
        fields = tuple(self.algorithm.sharded_pop_fields)

        def island(st: Any) -> Tuple[torch.Tensor, dict]:
            d = axis_index(self.axis_name)
            return self._blocks(st, k, d * per, per, shard)

        specs = self._state_specs(state)
        pop, art = shard_map(island, self.mesh, (specs,),
                             (P(self.axis_name), {name: P(self.axis_name) for name in fields}),
                             self.axis_name)(state)
        return pop, state.replace(seed=seed, **art)

    def _state_specs(self, state: Any) -> Any:
        """The state's annotations with ``POP_AXIS`` renamed to this
        wrapper's ``axis_name``."""
        def rename(spec: P) -> P:
            return P(*(self.axis_name if ax == POP_AXIS else ax for ax in spec))

        return _walk(state, lambda path, leaf, spec: rename(P() if spec is None else spec))

    def tell(self, state: Any, fitness: torch.Tensor) -> Any:
        if self.mesh is None:
            return self.algorithm.tell(state, fitness)
        return sharded_es_tell(self.algorithm, state, fitness, self.mesh, self.axis_name)


# ------------------------------------------------------ the process layer

# what this process passed to init_distributed, and the store it built
_INIT_RECORD: Optional[dict] = None
_STORE: Any = None
_BARRIER_SEQ = [0]
_BARRIER_PREFIX = "evox_tpu_torch/barrier"


def is_dist_initialized() -> bool:
    """True when ``torch.distributed`` has a process group in this
    process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_id() -> int:
    """This process's rank (0 without a process group)."""
    if not is_dist_initialized():
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def process_count() -> int:
    """The processes of the group (1 without one)."""
    if not is_dist_initialized():
        return 1
    import torch.distributed as dist

    return int(dist.get_world_size())


def dist_store() -> Any:
    """The process group's key-value store (the ``FileStore`` or
    ``TCPStore`` that :func:`init_distributed` made), or None without one:
    what :func:`process_barrier` and the pod supervisor's heartbeats meet
    on, with no collective."""
    return _STORE if is_dist_initialized() else None


def _make_store(init_method: str, world_size: int, rank: int, timeout: timedelta) -> Any:
    import torch.distributed as dist

    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world_size)
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world_size, rank == 0, timeout)
    raise ValueError(f"init_method must be file://PATH or tcp://HOST:PORT, got {init_method!r}")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 300.0) -> None:
    """Join a process group (call once per process).

    ``coordinator_address``: ``"file://PATH"`` (a ``FileStore``, no
    network) or ``"tcp://HOST:PORT"`` (a ``TCPStore`` that process 0
    serves). ``backend``: ``None`` chooses NCCL where a card is visible,
    else gloo. A second call whose arguments agree with the active group
    warns and does nothing; one that names another layout raises."""
    global _INIT_RECORD, _STORE
    import torch.distributed as dist

    requested = {"coordinator_address": coordinator_address, "num_processes": num_processes,
                 "process_id": process_id, "backend": backend}
    if is_dist_initialized():
        current = dict(_INIT_RECORD or {})
        current.setdefault("num_processes", process_count())
        current.setdefault("process_id", globals()["process_id"]())
        conflicts = {k: (v, current.get(k)) for k, v in requested.items()
                     if v is not None and current.get(k) is not None and v != current[k]}
        if conflicts:
            detail = ", ".join(f"{k}: requested {a!r} != active {b!r}"
                               for k, (a, b) in sorted(conflicts.items()))
            raise RuntimeError(
                "init_distributed: torch.distributed is already initialized with a "
                f"CONFLICTING configuration ({detail}); restart the process to join another")
        warnings.warn("init_distributed: torch.distributed is already initialized; this "
                      "matching call is a no-op", stacklevel=2)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and "
                         "process_id (nothing in the environment describes a cluster)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = timedelta(seconds=timeout_s)
    store = _make_store(coordinator_address, int(num_processes), int(process_id), timeout)
    dist.init_process_group(backend, store=store, world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _STORE = store
    _INIT_RECORD = {k: v for k, v in dict(requested, backend=backend).items() if v is not None}


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    global _INIT_RECORD, _STORE
    _INIT_RECORD, _STORE = None, None
    if not is_dist_initialized():
        return
    import torch.distributed as dist

    try:
        dist.destroy_process_group()
    except Exception as e:  # pragma: no cover - backend-dependent teardown
        warnings.warn(f"shutdown_distributed: destroy_process_group raised "
                      f"{type(e).__name__}: {e}", stacklevel=2)


def pod_devices(local: Optional[Sequence[Any]] = None) -> List[Tuple[int, torch.device]]:
    """``[(process, device)]`` of every process's devices in pod order (by
    process, then local order): ``local`` (default every visible card, else
    the CPU) from each process, gathered (a collective with a group)."""
    if local is None:
        n = torch.cuda.device_count()
        local = [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]
    mine = [str(torch.device(d)) for d in local]
    if process_count() <= 1:
        return [(0, torch.device(d)) for d in mine]
    import torch.distributed as dist

    everyone: List[Any] = [None] * process_count()
    dist.all_gather_object(everyone, mine)
    return [(p, torch.device(d)) for p, devs in enumerate(everyone) for d in devs]


def create_pod_mesh(axis_names: Sequence[str] = (POP_AXIS,), shape: Optional[Sequence[int]] = None,
                    devices: Optional[Sequence[Tuple[int, Any]]] = None) -> Mesh:
    """A mesh over every process's devices in pod order, so each process's
    devices hold a contiguous block of the leading axis. Every process must
    contribute the same number of devices and the shape must hold them
    all."""
    devices = pod_devices() if devices is None else list(devices)
    counts: Dict[int, int] = {}
    for p, _ in devices:
        counts[p] = counts.get(p, 0) + 1
    if len(set(counts.values())) > 1:
        raise ValueError(f"create_pod_mesh: processes contribute unequal device counts ({counts})")
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"create_pod_mesh: shape {tuple(shape)} does not hold the {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [d for _, d in devices]
    procs = np.asarray([p for p, _ in devices], dtype=np.int64)
    return Mesh(arr.reshape(tuple(shape)), axis_names, procs.reshape(tuple(shape)))


def mesh_spans_processes(mesh: Optional[Mesh]) -> bool:
    """True when the mesh holds devices of more than one process."""
    return mesh is not None and mesh.derived(
        ("spans",), lambda: len(set(int(p) for p in mesh.processes.flat)) > 1)


def require_single_process(mesh: Optional[Mesh], where: str) -> None:
    """Refuse a mesh that spans processes where the computation does not
    take one yet: the tenant fleets and the islands, whose members would
    have to spread over distinct cards (ROADMAP A11, part 4).
    :func:`shard_map`, ``ShardedES``, ``StdWorkflow`` over a problem on the
    device and the sharded sort do take such a mesh."""
    if mesh_spans_processes(mesh):
        raise NotImplementedError(
            f"{where}: a mesh that spans processes is not ported here yet (ROADMAP A11, "
            "part 4: tenants, islands and eval_shard_map blocks over distinct cards); run it "
            "on a mesh of this process's devices")


class BarrierTimeoutError(RuntimeError):
    """A :func:`process_barrier` deadline passed with processes missing;
    ``arrived`` and ``missing`` are sorted process ids from the store's
    arrival records."""

    def __init__(self, name: str, timeout_s: float, arrived: Sequence[int],
                 missing: Sequence[int], cause: str = ""):
        self.barrier_name = name
        self.timeout_s = timeout_s
        self.arrived = sorted(int(p) for p in arrived)
        self.missing = sorted(int(p) for p in missing)
        detail = f" [{cause}]" if cause else ""
        super().__init__(
            f"process_barrier '{name}' timed out after {timeout_s:g} s: processes "
            f"{self.missing or '<unknown>'} never arrived (arrived: {self.arrived}){detail}")


def process_barrier(name: Optional[str] = None, timeout_s: float = 120.0,
                    poll_s: float = 0.002) -> None:
    """Wait until every process reached this barrier, on the group's store
    (no collective, so it works where the backend cannot run one). Each
    process records its arrival, then waits for the arrival count; past
    ``timeout_s`` it raises :class:`BarrierTimeoutError` naming the
    processes that never came. No-op in one process. Every process must
    call the same barriers in the same order (unnamed ones take a per-
    process counter)."""
    nprocs = process_count()
    if nprocs <= 1:
        return
    if _STORE is None:
        raise RuntimeError("process_barrier: the process group was not made by init_distributed, "
                           "so there is no store to meet on")
    if name is None:
        _BARRIER_SEQ[0] += 1
        name = f"evox_barrier_{_BARRIER_SEQ[0]}"
    pid = process_id()
    key = f"{_BARRIER_PREFIX}/{name}"
    _STORE.set(f"{key}/arrived/{pid}", "1")
    _STORE.add(f"{key}/count", 1)
    deadline = time.monotonic() + timeout_s
    while _STORE.add(f"{key}/count", 0) < nprocs:
        if time.monotonic() > deadline:
            arrived = [p for p in range(nprocs) if _STORE.check([f"{key}/arrived/{p}"])]
            missing = sorted(set(range(nprocs)) - set(arrived))
            raise BarrierTimeoutError(name, timeout_s, arrived, missing)
        time.sleep(poll_s)

