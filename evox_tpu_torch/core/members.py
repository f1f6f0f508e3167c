"""Stacked member states and one call for all members — the port's
counterpart of ``jax.vmap`` over the JAX package's stacked states.

Islands, clusters, co-evolution blocks and tenants hold their member states
**stacked**: every tensor leaf carries a leading member axis, the JAX
package's ``vmap(init)(keys)`` layout. :func:`member_call` runs an
algorithm's ``ask``, ``tell`` or ``migrate`` once for all members through
``torch.func.vmap``.

- **Host fields.** A state's host values (counters, flags) are equal across
  members and held once. Seeds differ: a field whose name ends in ``seed``
  holds a :class:`MemberSeeds`, the members' host integers in member order.
  Any other host field whose members differ holds a :class:`MemberValues`;
  :func:`member_call` then runs each group of members with equal host
  values as one ``vmap`` (the JAX package carries such counters as arrays).
- **Draws.** ``split_seed`` and ``fold_in_seed`` map over member seeds
  member by member. A draw from member seeds (:func:`member_draw`) makes
  each member's draw from its own seed exactly as the solo path does,
  outside the ``vmap`` (:func:`host_call`), stacks them, and hands each
  member its row through the batched member index (:func:`member_rows`).
  So member ``i`` draws what a solo run of its seed draws. The ``vmap``
  runs with ``randomness="error"``: a draw that bypasses the member seeds
  raises, and ``generator`` refuses member seeds.
- **Kernels.** ``packed_dominance``, ``partial_topk`` and
  ``non_dominated_sort`` carry ``vmap`` rules (``torch.library`` custom
  ops) that make one batched launch for all members.

An algorithm whose ask or tell reads the device on the host cannot run
under ``vmap``; it says so with ``stackable = False``, and
:func:`member_call` then runs its members one by one on unstacked states,
with the same results (``member_route`` names the route).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "MemberSeeds",
    "MemberValues",
    "host_call",
    "in_member_call",
    "is_batched",
    "member_call",
    "member_draw",
    "member_index",
    "member_route",
    "member_rows",
    "n_members",
    "put_state",
    "select_members",
    "stack_states",
    "take_state",
    "unstack_states",
]


class MemberSeeds(tuple):
    """The members' host seeds of one seed field of a stacked state, in
    member order. Travels as pytree context, not as a tensor."""

    def __repr__(self) -> str:
        return f"MemberSeeds{tuple.__repr__(self)}"


class MemberValues(tuple):
    """The members' values of a host field (not a seed) that differs
    between members."""

    def __repr__(self) -> str:
        return f"MemberValues{tuple.__repr__(self)}"


_PER_MEMBER = (MemberSeeds, MemberValues)

# the batched member index of each active member call, innermost last
_INDEX: List[torch.Tensor] = []


def is_batched(x: Any) -> bool:
    """Whether ``x`` is a tensor batched by an enclosing ``vmap``."""
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)


def in_member_call() -> bool:
    return bool(_INDEX)


def member_index() -> torch.Tensor:
    """The batched 0-d member index of the innermost :func:`member_call`."""
    if not _INDEX:
        raise RuntimeError("member seeds and member rows exist only inside member_call")
    return _INDEX[-1]


def member_rows(tree: Any) -> Any:
    """Each member's row of a tree of tensors stacked over the members of
    the innermost :func:`member_call` (``x[member_index()]``). How a test
    hands JAX's vmapped draws to a stacked run's draw method."""
    index = member_index()
    return _map(lambda x: x[index.to(x.device)], tree)


# ------------------------------------------------------------ host calls
_CALLS: Dict[int, Callable[[], List[torch.Tensor]]] = {}
_TOKENS = itertools.count()


@torch.library.custom_op("evox_torch::host_call", mutates_args=())
def _host_call_op(token: int) -> List[torch.Tensor]:
    # an opaque op: vmap does not batch its body, so the body's draws run
    # as plain eager code on the members' host seeds, outside every
    # member call
    saved = _INDEX[:]
    _INDEX.clear()
    try:
        return list(_CALLS.pop(token)())
    finally:
        _INDEX[:] = saved


def host_call(fn: Callable[[], List[torch.Tensor]]) -> List[torch.Tensor]:
    """``fn()`` (a list of fresh, unbatched tensors) run outside the
    enclosing ``vmap``; called directly outside a member call."""
    if not _INDEX:
        return list(fn())
    token = next(_TOKENS)
    _CALLS[token] = fn
    try:
        return _host_call_op(token)
    finally:
        _CALLS.pop(token, None)


def member_draw(draw: Callable[[int], Any], seeds: MemberSeeds) -> Any:
    """Each member's ``draw(seed)`` from its own seed, as a solo run draws
    it; inside a member call every member gets its own row.

    ``member_draw.calls`` counts calls and ``member_draw.draws`` the member
    draws made; ``member_draw.seconds`` sums their host time."""
    t0 = time.perf_counter()
    box: Dict[str, Any] = {}

    def run() -> List[torch.Tensor]:
        per = [draw(int(s)) for s in seeds]
        leaves, rebuild = _flatten_tensors(per[0])
        box["rebuild"] = rebuild
        return [torch.stack([_flatten_tensors(p)[0][j] for p in per])
                for j in range(len(leaves))]

    tensors = host_call(run)
    stacked = box["rebuild"](tensors)
    member_draw.calls += 1
    member_draw.draws += len(seeds)
    member_draw.seconds += time.perf_counter() - t0
    return member_rows(stacked)


member_draw.calls = 0
member_draw.draws = 0
member_draw.seconds = 0.0


def per_member_seeds(fn: Callable[[int], Any], seeds: MemberSeeds) -> List[Any]:
    """``[fn(s) for s in seeds]`` for a host function of a seed whose body
    draws on the host (``split_seed``): run outside the ``vmap``. ``fn``
    returns an int or a list of ints."""
    out: Dict[str, Any] = {}

    def run() -> List[torch.Tensor]:
        out["v"] = [fn(int(s)) for s in seeds]
        return []

    host_call(run)
    return out["v"]


# ------------------------------------------------------------ tree walks
def _is_state(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _rebuild_state(obj: Any, values: Dict[str, Any]) -> Any:
    new = object.__new__(type(obj))
    for f in dataclasses.fields(obj):
        object.__setattr__(new, f.name, values[f.name] if f.name in values else getattr(obj, f.name))
    return new


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if _is_state(tree):
        return _rebuild_state(tree, {f.name: _map(fn, getattr(tree, f.name))
                                     for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, _PER_MEMBER):
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _flatten_tensors(tree: Any):
    """``(tensors, rebuild)`` of a tree of tensors."""
    leaves: List[torch.Tensor] = []
    _map(lambda x: leaves.append(x) or x, tree)

    def rebuild(new: Sequence[torch.Tensor]) -> Any:
        it = iter(new)
        return _map(lambda _: next(it), tree)

    return leaves, rebuild


def _host_equal(values: Sequence[Any]) -> bool:
    first = values[0]
    for v in values[1:]:
        if type(v) is not type(first):
            return False
        try:
            if not bool(v == first):
                return False
        except (TypeError, ValueError, RuntimeError):
            return v is first
    return True


def _stack(items: Sequence[Any], name: str) -> Any:
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if _is_state(first):
        return _rebuild_state(first, {f.name: _stack([getattr(i, f.name) for i in items], f.name)
                                      for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _stack([i[k] for i in items], k) for k in first}
    if isinstance(first, (list, tuple)) and not isinstance(first, _PER_MEMBER):
        if len({len(i) for i in items}) != 1:
            raise ValueError(f"members' {name or 'tuple'} differ in length")
        return type(first)(_stack([i[j] for i in items], name) for j in range(len(first)))
    if name.endswith("seed") and all(isinstance(i, (int, np.integer)) for i in items):
        return MemberSeeds(int(i) for i in items)  # seeds stay per member, equal or not
    if _host_equal(items):
        return first
    return MemberValues(items)


def stack_states(members: Sequence[Any]) -> Any:
    """One stacked state from member states of one algorithm: tensors
    stacked on a new leading axis, equal host values kept once, differing
    seeds as :class:`MemberSeeds` and other differing host values as
    :class:`MemberValues`."""
    if not members:
        raise ValueError("stack_states needs at least one member")
    return _stack(list(members), "")


def n_members(stacked: Any) -> int:
    """The member count of a stacked state."""
    found: List[int] = []

    def walk(tree: Any) -> None:
        if found:
            return
        if isinstance(tree, _PER_MEMBER):
            found.append(len(tree))
        elif isinstance(tree, (torch.Tensor, np.ndarray)):
            found.append(int(tree.shape[0]))
        elif _is_state(tree):
            for f in dataclasses.fields(tree):
                walk(getattr(tree, f.name))
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(stacked)
    if not found:
        raise ValueError("a stacked state needs a tensor leaf or member seeds")
    return found[0]


def _take(tree: Any, idx: Any) -> Any:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree[idx]
    if isinstance(tree, _PER_MEMBER):
        if isinstance(idx, (int, np.integer)):
            return tree[int(idx)]
        sub = [tree[int(i)] for i in (idx.tolist() if hasattr(idx, "tolist") else idx)]
        if isinstance(tree, MemberValues) and _host_equal(sub):
            return sub[0]
        return type(tree)(sub)
    if _is_state(tree):
        return _rebuild_state(tree, {f.name: _take(getattr(tree, f.name), idx)
                                     for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, idx) for v in tree)
    return tree


def take_state(stacked: Any, idx: Any) -> Any:
    """Member(s) ``idx`` (an int, or an index array or list) of a stacked
    state: an int gives a member's own state, host seeds as ints."""
    if isinstance(idx, list):
        idx = np.asarray(idx, dtype=np.int64)
    if isinstance(idx, np.ndarray) and _has_torch(stacked):
        idx = torch.as_tensor(idx)
    return _take(stacked, idx)


def _has_torch(tree: Any) -> bool:
    leaves, _ = _flatten_tensors(tree)
    return any(isinstance(x, torch.Tensor) for x in leaves)


def unstack_states(stacked: Any, n: Optional[int] = None) -> List[Any]:
    """The member states of a stacked state, in member order."""
    n = n_members(stacked) if n is None else n
    return [take_state(stacked, i) for i in range(n)]


def _put_leaf(full: Any, new: Any, idx: Any) -> Any:
    if isinstance(full, torch.Tensor):
        out = full.clone()
        index = idx.to(full.device) if isinstance(idx, torch.Tensor) else idx
        out[index] = torch.as_tensor(new, dtype=full.dtype, device=full.device)
        return out
    out = np.array(full, copy=True)
    out[idx] = new
    return out


def _put(full: Any, new: Any, idx: Any, n: int, name: str) -> Any:
    # a leaf one side does not hold yet (a guarded state's candidate batch
    # and best point before its first ask and tell): zeros stand for it,
    # the JAX package's initial buffers
    if full is None and isinstance(new, torch.Tensor):
        lead = () if isinstance(idx, (int, np.integer)) else (1,)
        full = torch.zeros((n,) + tuple(new.shape[len(lead):]), dtype=new.dtype,
                           device=new.device)
    elif new is None and isinstance(full, torch.Tensor):
        new = torch.zeros(full.shape[1:], dtype=full.dtype, device=full.device)
    if isinstance(full, (torch.Tensor, np.ndarray)):
        return _put_leaf(full, new, idx)
    if _is_state(full):
        return _rebuild_state(full, {
            f.name: _put(getattr(full, f.name), getattr(new, f.name), idx, n, f.name)
            for f in dataclasses.fields(full)})
    if isinstance(full, dict):
        return {k: _put(v, new[k], idx, n, k) for k, v in full.items()}
    if isinstance(full, (list, tuple)) and not isinstance(full, _PER_MEMBER):
        return type(full)(_put(v, new[j], idx, n, name) for j, v in enumerate(full))
    # a host field: per-member values, written and collapsed again
    values = list(full) if isinstance(full, _PER_MEMBER) else [full] * n
    if isinstance(idx, (int, np.integer)):
        values[int(idx)] = new
    else:
        rows = idx.tolist() if hasattr(idx, "tolist") else list(idx)
        sub = list(new) if isinstance(new, _PER_MEMBER) else [new] * len(rows)
        for r, v in zip(rows, sub):
            values[int(r)] = v
    return _stack(values, name)


def put_state(stacked: Any, idx: Any, sub: Any) -> Any:
    """``stacked`` with member(s) ``idx`` replaced by ``sub``'s leaves
    (a member's state for an int ``idx``, a stacked one for an index
    array)."""
    if isinstance(idx, list):
        idx = np.asarray(idx, dtype=np.int64)
    if isinstance(idx, np.ndarray) and _has_torch(stacked):
        idx = torch.as_tensor(idx)
    return _put(stacked, sub, idx, n_members(stacked), "")


def select_members(mask: torch.Tensor, rows: Sequence[int], old: Any, new: Any) -> Any:
    """``new`` with the members in ``rows`` keeping ``old``'s values: each
    tensor leaf by ``torch.where`` on the ``(n,)`` bool ``mask`` on the
    device (no read to the host; the other rows pass through bit for bit),
    each host field by ``rows``, the mask's host mirror. A leaf that
    ``old`` does not hold yet (``None``) is ``new``'s."""
    n = n_members(new)

    def walk(o: Any, x: Any, name: str) -> Any:
        if o is None:
            return x
        if isinstance(x, torch.Tensor):
            m = mask.to(x.device).reshape(mask.shape + (1,) * (x.ndim - 1))
            return torch.where(m, o.to(x.dtype), x)
        if isinstance(x, np.ndarray):
            out = np.array(x, copy=True)
            out[list(rows)] = np.asarray(o)[list(rows)]
            return out
        if _is_state(x):
            return _rebuild_state(x, {f.name: walk(getattr(o, f.name), getattr(x, f.name), f.name)
                                      for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: walk(o[k], v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not isinstance(x, _PER_MEMBER):
            return type(x)(walk(o[j], v, name) for j, v in enumerate(x))
        if not rows:
            return x
        values = list(x) if isinstance(x, _PER_MEMBER) else [x] * n
        before = list(o) if isinstance(o, _PER_MEMBER) else [o] * n
        for r in rows:
            values[int(r)] = before[int(r)]
        return _stack(values, name)

    return walk(old, new, "")


# ------------------------------------------------------------ member calls
def member_route(algorithm: Any) -> str:
    """``"vmap"`` for an algorithm that runs stacked, ``"loop"`` for one
    that says it cannot (``stackable = False``)."""
    return "vmap" if getattr(algorithm, "stackable", True) else "loop"


def _groups(stacked: Any, n: int) -> List[List[int]]:
    """Members grouped by their values of the non-seed host fields that
    differ (:class:`MemberValues`); one group when none differ."""
    found: List[MemberValues] = []

    def walk(tree: Any) -> None:
        if isinstance(tree, MemberValues):
            found.append(tree)
        elif _is_state(tree):
            for f in dataclasses.fields(tree):
                walk(getattr(tree, f.name))
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)) and not isinstance(tree, MemberSeeds):
            for v in tree:
                walk(v)

    walk(stacked)
    if not found:
        return [list(range(n))]
    groups: Dict[tuple, List[int]] = {}
    for i in range(n):
        groups.setdefault(tuple(v[i] for v in found), []).append(i)
    return list(groups.values())


def _vmapped(fn: Callable, stacked: Any, args: Sequence[Any], dims: Sequence[Any], n: int) -> Any:
    batched = [a for a, d in zip(args, dims) if d is not None]
    leaves, spec = pytree.tree_flatten((stacked, batched))
    pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    device = leaves[pos[0]].device if pos else torch.device("cpu")
    out: Dict[str, Any] = {}

    def inner(index: torch.Tensor, *tensors: torch.Tensor):
        full = list(leaves)
        for p, t in zip(pos, tensors):
            full[p] = t
        state, bargs = pytree.tree_unflatten(full, spec)
        it = iter(bargs)
        call_args = [next(it) if d is not None else a for a, d in zip(args, dims)]
        _INDEX.append(index)
        try:
            result = fn(state, *call_args)
        finally:
            _INDEX.pop()
        oleaves, ospec = pytree.tree_flatten(result)
        out["leaves"], out["spec"] = oleaves, ospec
        out["pos"] = [i for i, x in enumerate(oleaves) if isinstance(x, torch.Tensor)]
        return tuple(oleaves[i] for i in out["pos"])

    in_dims = (0,) + tuple(0 for _ in pos)
    tensors = torch.func.vmap(inner, in_dims=in_dims, randomness="error")(
        torch.arange(n, device=device), *[leaves[p] for p in pos])
    oleaves = list(out["leaves"])
    for p, t in zip(out["pos"], tensors):
        oleaves[p] = t
    return pytree.tree_unflatten(oleaves, out["spec"])


def member_call(fn: Callable, stacked: Any, *args: Any, in_dims: Any = 0,
                route: str = "vmap") -> Any:
    """``fn(member_state, *member_args)`` for every member of ``stacked``,
    as one ``torch.func.vmap`` call; the outputs stacked on a leading
    member axis (host values as :func:`stack_states` holds them).

    ``in_dims``: 0 (the default) when ``args`` carry a leading member axis,
    ``None`` when every member takes them whole, or one of those per
    argument. ``route="loop"`` runs the members one by one on unstacked
    states (the route of an algorithm with ``stackable = False``), with the
    same results."""
    n = n_members(stacked)
    dims = tuple(in_dims) if isinstance(in_dims, (tuple, list)) else (in_dims,) * len(args)
    if len(dims) != len(args):
        raise ValueError(f"in_dims has {len(dims)} entries for {len(args)} arguments")
    if route == "loop":
        outs = [fn(take_state(stacked, i),
                   *[take_state(a, i) if d is not None else a for a, d in zip(args, dims)])
                for i in range(n)]
        return stack_states(outs)
    if route != "vmap":
        raise ValueError(f"route must be 'vmap' or 'loop', got {route!r}")
    groups = _groups(stacked, n)
    if len(groups) == 1:
        return _vmapped(fn, stacked, args, dims, n)
    per_member: List[Any] = [None] * n
    for g in groups:
        idx = torch.as_tensor(g)
        sub_args = [take_state(a, idx) if d is not None else a for a, d in zip(args, dims)]
        result = _vmapped(fn, take_state(stacked, idx), sub_args, dims, len(g))
        for j, i in enumerate(g):
            per_member[i] = take_state(result, j)
    return stack_states(per_member)
