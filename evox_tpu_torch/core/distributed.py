"""The mesh, its shardings, the POP-sharded ES and the process layer — the
port of ``evox_tpu/core/distributed.py``.

**The mesh.** The JAX package's ``Mesh`` + ``shard_map`` is one program
that XLA partitions over devices; PyTorch has no counterpart. Here a
:class:`Mesh` is named axes over an array of ``torch.device``\\ s in which a
device may repeat: ``create_mesh(devices=["cuda:0"] * 8)`` is an 8-shard
mesh on one card (what the JAX tests do with 8 virtual CPU devices),
``create_mesh()`` a mesh over every visible card, ``create_mesh(devices=
["cpu"] * 8)`` the CPU tests' mesh. The program stays single-controller:

- A global value lives on the mesh's first device, its *controller*.
- :func:`shard_map` runs a per-shard function shard by shard, in mesh
  order: an input specified ``P(axis)`` enters as its shard's block of rows
  (a view on the controller, a copy on another device), ``P()`` whole.
  Each output is combined by its out spec: ``P(axis)`` concatenated in
  mesh order (the ``all_gather``), ``P()`` shard 0's, :data:`PSUM` summed
  in mesh order (the ``psum``). Mesh order is fixed, so sums are
  reproducible; they can differ from the JAX package's only in their order.
- :func:`axis_index` inside a per-shard function is the shard's index.

So a mesh of repeated devices runs the sharded program's arithmetic on one
device (the sharded sort's row slabs, ``ShardedES``'s per-shard draws and
partial moments), and a mesh of distinct cards spreads the per-shard work
over them, with copies to and from the controller.

**Shardings.** :class:`P` and :class:`NamedSharding` keep the JAX names.
``field(sharding=P(POP_AXIS))`` on a state's dataclass field
(:mod:`evox_tpu_torch.core.struct`) is the per-field annotation;
:func:`annotation_specs`, :func:`state_sharding`, :func:`match_partition_rules`
and :func:`constrain_state` resolve them (rules first, then annotations),
and :func:`place_state`/:func:`place_pop` put a state's leaves on the
controller, or, on a mesh that spans processes, keep the rows this
process's devices own (:func:`ensure_global_state`).

**ShardedES** wraps a low-memory ES (``SepCMAES``, ``LMMAES``, ``RMES``):
shard ``s`` draws its block from ``fold_in_seed(k, s)`` (the JAX package's
``fold_in(k, s)``), and the tell weights every candidate by its global
fitness rank (one stable argsort and its inverse) and sums per-shard
moments with :func:`psum`. ``mesh=None, n_shards=N`` runs the same law on
one device, the reference of the sharded run.

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
    "all_gather",
    "annotation_specs",
    "assemble_global_array",
    "axis_index",
    "constrain_state",
    "create_mesh",
    "create_pod_mesh",
    "ensure_global_state",
    "host_value",
    "init_distributed",
    "is_dist_initialized",
    "match_partition_rules",
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
    "shard_map",
    "shard_pop",
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
        ax = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            index[ax] = i
            out.append(self.devices[tuple(index)])
        return out

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


def split_rows(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``x``'s leading axis in ``n`` blocks, in order; the blocks differ in
    size by at most one row where ``n`` does not divide it."""
    return list(torch.tensor_split(x, n, dim=0))


def _is_leaf_spec(spec: Any) -> bool:
    return spec is None or spec is PSUM or isinstance(spec, P)


def _map_spec(fn: Callable[[Any, Any], Any], spec: Any, tree: Any) -> Any:
    """``fn(spec, tensor)`` over ``tree``'s tensors, where ``spec`` is one
    spec for the whole tree or a tree of specs of ``tree``'s shape (dicts,
    lists, tuples and states; a non-tensor leaf maps to ``None``)."""
    if isinstance(tree, torch.Tensor):
        return fn(spec if _is_leaf_spec(spec) else None, tree)
    if _is_leaf_spec(spec):
        return _map_leaves(lambda x: fn(spec, x), tree)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, spec[k], tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_spec(fn, sp, t) for sp, t in zip(spec, tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_spec(fn, getattr(spec, f.name), getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return None


def _map_leaves(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    from .struct import map_tensors

    return map_tensors(fn, tree)


def _combine(spec: Any, parts: List[Any], axis_name: str, controller: torch.device) -> Any:
    if isinstance(parts[0], torch.Tensor):
        if spec is PSUM:
            return psum(parts, controller)
        if spec is not None and axis_name in spec:
            return all_gather(parts, controller)
        return parts[0].to(controller)
    if isinstance(parts[0], dict):
        return {k: _combine(spec if _is_leaf_spec(spec) else spec[k], [p[k] for p in parts],
                            axis_name, controller) for k in parts[0]}
    if isinstance(parts[0], (list, tuple)):
        return type(parts[0])(
            _combine(spec if _is_leaf_spec(spec) else spec[i], [p[i] for p in parts], axis_name,
                     controller) for i in range(len(parts[0])))
    if dataclasses.is_dataclass(parts[0]):
        return dataclasses.replace(parts[0], **{
            f.name: _combine(spec if _is_leaf_spec(spec) else getattr(spec, f.name),
                             [getattr(p, f.name) for p in parts], axis_name, controller)
            for f in dataclasses.fields(parts[0])})
    return parts[0]


def shard_map(fn: Callable[..., Any], mesh: Mesh, in_specs: Sequence[Any], out_specs: Any,
              axis_name: str = POP_AXIS) -> Callable[..., Any]:
    """The single-controller ``shard_map``: ``fn`` runs once per shard of
    ``axis_name``, in mesh order, on its shard's device (module docstring).
    ``in_specs``: one spec (or tree of specs) per argument; ``out_specs``:
    one for the output (``P(axis)``, ``P()`` or :data:`PSUM`). A mesh
    that spans processes is refused (:func:`require_single_process`)."""
    require_single_process(mesh, "shard_map")
    n = _mesh_axis_size(mesh, axis_name)
    devices = mesh.axis_devices(axis_name)

    def run(*args: Any) -> Any:
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map got {len(args)} arguments for {len(in_specs)} specs")
        blocks = [
            _map_spec(lambda spec, x: split_rows(x, n) if spec is not None and axis_name in spec
                      else None, spec, arg)
            for spec, arg in zip(in_specs, args)]
        outs = []
        stack = _shard_ctx.__dict__.setdefault("stack", [])
        for s, dev in enumerate(devices):
            local = [
                _local(arg, blk, s, dev) for arg, blk in zip(args, blocks)]
            stack.append((axis_name, s))
            try:
                outs.append(fn(*local))
            finally:
                stack.pop()
        return _combine(out_specs, outs, axis_name, mesh.controller)

    return run


def _local(arg: Any, blocks: Any, s: int, dev: torch.device) -> Any:
    """Shard ``s``'s view of one argument: its block of each split leaf,
    the whole of each replicated one, on ``dev``."""
    if isinstance(arg, torch.Tensor):
        return (blocks[s] if blocks is not None else arg).to(dev)
    if isinstance(arg, dict):
        return {k: _local(arg[k], blocks[k], s, dev) for k in arg}
    if isinstance(arg, (list, tuple)):
        return type(arg)(_local(a, b, s, dev) for a, b in zip(arg, blocks))
    if dataclasses.is_dataclass(arg):
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


def tree_all_gather(trees: Sequence[Any], device: Optional[torch.device] = None) -> Any:
    """:func:`all_gather` leaf by leaf over per-shard trees of one shape."""
    return _combine(P(POP_AXIS), list(trees), POP_AXIS,
                    device if device is not None else _first_device(trees[0]))


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
    the path (``spec`` where none)."""
    if isinstance(tree, torch.Tensor):
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


def _process_block(leaf: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The rows of a leaf split over a mesh axis that this process's
    positions of that axis own (all of it for replicated leaves)."""
    mesh, spec = sharding.mesh, sharding.spec
    if not spec or spec[0] is None:
        return leaf
    ax = mesh.axis_names.index(spec[0])
    along = np.moveaxis(mesh.processes, ax, 0).reshape(mesh.devices.shape[ax], -1)[:, 0]
    mine = [i for i, p in enumerate(along) if int(p) == process_id()]
    blocks = split_rows(leaf, len(along))
    return torch.cat([blocks[i] for i in mine]) if mine else leaf[:0]


def place_state(state: Any, mesh: Optional[Mesh], rules: Optional[Sequence[Tuple[str, P]]] = None,
                axis_prefix: Optional[str] = None) -> Any:
    """Eager placement of every leaf by its resolved layout: on the mesh's
    controller (where global values live); on a mesh that spans processes,
    :func:`ensure_global_state`. ``None`` mesh: unchanged."""
    if mesh is None:
        return state
    if mesh_spans_processes(mesh):
        return ensure_global_state(state, mesh, rules=rules, axis_prefix=axis_prefix)
    return _map_leaves(lambda x: x.to(mesh.controller), state)


def place_by_sharding(state: Any, shardings: Any) -> Any:
    """Every leaf placed by its :class:`NamedSharding` in ``shardings`` (a
    tree over the state's leaves, :func:`state_sharding`'s form): on its
    mesh's controller, or this process's rows on a mesh that spans
    processes."""
    def place(path: str, leaf: torch.Tensor, _: Any) -> torch.Tensor:
        sh = _leaf_at(shardings, path)
        if mesh_spans_processes(sh.mesh):
            return _process_block(leaf.to(_local_device(sh.mesh)), sh)
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
    processes each process keeps the rows its devices own."""
    if mesh is None:
        return tree
    if mesh_spans_processes(mesh):
        sh = pop_sharding(mesh, axis_name)
        return _map_leaves(lambda x: _process_block(x.to(_local_device(mesh)), sh), tree)
    return _map_leaves(lambda x: x.to(mesh.controller), tree)


def _local_device(mesh: Mesh) -> torch.device:
    for d, p in zip(mesh.devices.flat, mesh.processes.flat):
        if int(p) == process_id():
            return d
    raise ValueError("the mesh holds no device of this process")


def assemble_global_array(host_arr: Any, sharding: NamedSharding) -> torch.Tensor:
    """A leaf on ``sharding`` from a full host value every process holds:
    on a mesh that spans processes, this process's rows; else the whole
    value on the controller."""
    mesh = sharding.mesh
    dev = _local_device(mesh) if mesh_spans_processes(mesh) else mesh.controller
    x = torch.as_tensor(np.asarray(host_arr)).to(dev)
    return _process_block(x, sharding) if mesh_spans_processes(mesh) else x


def ensure_global_state(state: Any, mesh: Optional[Mesh], default: Optional[P] = None,
                        rules: Optional[Sequence[Tuple[str, P]]] = None,
                        axis_prefix: Optional[str] = None) -> Any:
    """Per-process assembly of an eagerly built state over a mesh that spans
    processes: each leaf split over a process-spanning axis keeps this
    process's rows, every other leaf stays whole on this process's device.
    No-op when the mesh does not span processes."""
    if not mesh_spans_processes(mesh):
        return state
    shardings = state_sharding(state, mesh, default=default, rules=rules,
                               axis_prefix=axis_prefix)
    dev = _local_device(mesh)

    def place(path: str, leaf: torch.Tensor, _: Any) -> torch.Tensor:
        sh = _leaf_at(shardings, path)
        return _process_block(leaf.to(dev), sh)

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


def host_value(x: Any, mesh: Optional[Mesh] = None, axis_name: str = POP_AXIS) -> np.ndarray:
    """The full host (numpy) value of ``x``. On a mesh that spans processes
    with ``x`` split over ``axis_name``, ``x`` is this process's rows and
    the value is every process's rows gathered in process order (a
    collective: every process must call it)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if mesh is None or not mesh_spans_processes(mesh) or axis_name not in mesh.shape:
        return x.detach().cpu().numpy()
    import torch.distributed as dist

    parts = [None] * process_count()
    dist.all_gather_object(parts, x.detach().cpu().numpy())
    return np.concatenate(parts)


def tree_host_value(tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """:func:`host_value` over every tensor leaf of ``tree``."""
    return _walk(tree, lambda path, leaf, _: host_value(leaf, mesh))


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


def sharded_es_tell(algorithm: Any, state: Any, fitness: torch.Tensor, mesh: Mesh,
                    axis_name: str = POP_AXIS) -> Any:
    """One tell over a POP-sharded sample matrix: global ranks from the
    fitness, then per shard the partial moments of its rows weighted by
    their ranks' weights, summed over the shards in mesh order; the small
    strategy update (``tell_with_moments``) runs on the sums."""
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
        require_single_process(mesh, "ShardedES")
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
        state = self.algorithm.init(seed)
        return place_state(state, self.mesh)

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
    return mesh is not None and len(set(int(p) for p in mesh.processes.flat)) > 1


def require_single_process(mesh: Optional[Mesh], where: str) -> None:
    """Refuse a computation on a mesh that spans processes. The mesh is
    single-controller: :func:`shard_map` runs every shard in the calling
    process and no collective crosses processes, so each process would
    redo every shard. Placement (:func:`place_state`, :func:`place_pop`)
    and :func:`host_value` do take such a mesh."""
    if mesh_spans_processes(mesh):
        raise NotImplementedError(
            f"{where}: computing on a mesh that spans processes is not ported yet "
            "(ROADMAP A11: shard-resident state and cross-process collectives); place and "
            "gather on it, or compute on a mesh of this process's devices")


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

