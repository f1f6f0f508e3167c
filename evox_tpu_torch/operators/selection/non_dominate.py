"""Non-dominated sorting and crowding distance — the port of
``evox_tpu/operators/selection/non_dominate.py``.

The dominance matrix comes bit-packed from
:func:`~evox_tpu_torch.kernels.dominance.packed_dominance` (the CUDA kernel
for tensors on the card), 32 dominators per int32 word. Fronts are peeled
off it by a Python ``while`` loop that reads one number from the device per
front (the front's size: the loop's condition); each peel is one
``popcount(front & packed)`` pass over the words in plain PyTorch. The JAX
package runs the same loop as a ``lax.while_loop`` on the device.

Sorts follow the JAX package's stable ones (``jnp.argsort``,
``jnp.lexsort``): ``stable=True`` everywhere, and ``lexsort`` from
successive stable sorts, so ranks and survivor sets match it exactly.

Under ``torch.func.vmap`` (stacked members, :mod:`evox_tpu_torch.core.
members`) ``non_dominated_sort`` goes through a ``torch.library`` custom op
whose ``vmap`` rule sorts every member at once: one batched B3 launch
(``packed_dominance_batched``) and one peel over all members, which reads
the host once per front round for all of them; each member's ranks and cut
equal its own sort's. There ``return_cut_rank`` gives the cut as a 0-d
tensor, and the selections that use it stay on the device.

**The mesh-sharded sort** (``mesh=`` with a ``"pop"`` axis of D > 1
shards, :mod:`evox_tpu_torch.core.distributed`): the dominator rows are
padded with ``+inf`` rows (which dominate nothing) to ``32·D`` granularity,
and shard ``s`` builds its slab of ``words_per = ceil(n_words / D)`` words
with one launch of B3's rows form (``packed_dominance_rows``) on its own
device, comparing its rows against the full fitness. Each peel's delta is
the ``psum`` (a sum in mesh order) of the shards' slab popcounts, and the
counts the ``psum`` of the slabs' partial counts. Everything is integer, so
ranks and the cut equal the unsharded sort's, and the JAX package's sharded
sort's, exactly. The slabs stay on their shards. On a mesh that spans
processes (every process holding the whole fitness) each process builds
only its own positions' slabs, and each ``psum`` adds this process's
partials and gathers one a process (:func:`~evox_tpu_torch.core.
distributed.mesh_psum`): every process peels the same fronts.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from ...core.distributed import POP_AXIS, local_positions, mesh_psum
from ...core.members import is_batched
from ...kernels.dominance import (
    column_popcount,
    pack_dominator_rows,
    packed_dominance,
    packed_dominance_batched,
    packed_dominance_rows,
)
from ...kernels.topk import default_use_kernel, partial_topk
from ...utils.common import lexsort

INF = float("inf")


def _mesh_axis_size(mesh: Any, axis_name: str) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(axis_name, 1)


def _pack_front(front: torch.Tensor, n_words: int) -> torch.Tensor:
    """Bit-pack a boolean front vector ``(n,)`` into ``(n_words,)`` int32
    words (bit ``k`` of word ``w`` <- row ``32w + k``)."""
    return pack_dominator_rows(front[:, None], n_words)[:, 0]


def _peel_fronts(
    count: torch.Tensor,
    stop: int,
    n_words: int,
    delta_fn: Callable[[torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, int]:
    """Peel fronts until ``stop`` rows are ranked.

    ``count``: ``(n,)`` int32 domination counts. ``delta_fn(front_words)``
    maps the packed current front ``(n_words,)`` to the ``(n,)`` int32
    number of its members dominating each row. Each iteration ranks one
    front ``r``, subtracts its domination counts, and drops its rows to -1
    so they never re-enter. Returns ``(rank, cut)``: unranked rows hold the
    sentinel ``n``, and ``cut`` is the first rank at which the cumulative
    front sizes reach ``stop`` (``n`` if they never do).
    """
    n = count.shape[0]
    rank = torch.full((n,), n, dtype=torch.int32, device=count.device)
    front = count == 0
    r, done, cut = 0, 0, n
    while done < stop:
        size = int(front.sum())  # the one host read of each front
        if size == 0:
            break
        rank = torch.where(front, r, rank)
        done += size
        if done >= stop and cut == n:
            cut = r
        delta = delta_fn(_pack_front(front, n_words))
        count = count - delta - front.to(torch.int32)
        front = count == 0
        r += 1
    return rank, cut


def _peel_fronts_batched(count: torch.Tensor, stop: int, dom_packed: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_peel_fronts` of every member of ``(b, n)`` counts over their
    ``(b, n_words, n)`` packed matrices at once: one host read of the ``b``
    front sizes a round. A member whose peel has stopped keeps its ranks.
    Returns ``(rank (b, n) int32, cut (b,) int64)``."""
    b, n = count.shape
    n_words = dom_packed.shape[1]
    dev = count.device
    rank = torch.full((b, n), n, dtype=torch.int32, device=dev)
    front = count == 0
    done, cut, live = [0] * b, [n] * b, [True] * b
    r = 0
    while True:
        sizes = front.sum(dim=1).tolist()  # the one host read of each round
        live = [lv and done[i] < stop and sizes[i] > 0 for i, lv in enumerate(live)]
        if not any(live):
            break
        on = torch.tensor(live, device=dev)[:, None]
        rank = torch.where(front & on, r, rank)
        for i in range(b):
            if live[i]:
                done[i] += sizes[i]
                if done[i] >= stop and cut[i] == n:
                    cut[i] = r
        words = pack_dominator_rows(front.T, n_words).T  # (b, n_words)
        delta = column_popcount((dom_packed & words[:, :, None]).transpose(0, 1).reshape(
            n_words, b * n)).reshape(b, n)
        count = count - delta - front.to(torch.int32)
        front = count == 0
        r += 1
    return rank, torch.tensor(cut, dtype=torch.int64, device=dev)


@torch.library.custom_op("evox_torch::non_dominated_sort", mutates_args=())
def _sort_op(fitness: torch.Tensor, stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rank, cut = non_dominated_sort(fitness, until=stop, return_cut_rank=True)
    return rank.clone(), torch.tensor(cut, dtype=torch.int64, device=fitness.device)


@_sort_op.register_vmap
def _sort_vmap(info: Any, in_dims: Tuple[Any, ...], fitness: torch.Tensor, stop: int):
    dim = in_dims[0]
    fit = fitness.movedim(dim, 0) if dim is not None else fitness.expand(
        (info.batch_size,) + tuple(fitness.shape))
    lead = tuple(fit.shape[:-2])
    fit = fit.reshape((-1,) + tuple(fit.shape[-2:]))
    dom_packed, count = packed_dominance_batched(fit, device=fit.device)
    rank, cut = _peel_fronts_batched(count, min(stop, fit.shape[1]), dom_packed)
    return (rank.reshape(lead + rank.shape[1:]), cut.reshape(lead)), (0, 0)


def _non_dominated_sort_sharded(fitness: torch.Tensor, mesh: Any, stop: int,
                                axis_name: str) -> Tuple[torch.Tensor, int]:
    """The mesh-sharded sort (module docstring): one B3 rows launch for each
    of this process's shards on its own device, and a ``psum`` of the
    shards' popcounts a peel. Returns ``(rank, cut)`` on the fitness's
    device."""
    n, m = fitness.shape
    devices = mesh.axis_devices(axis_name)
    D = len(devices)
    n_words = (n + 31) // 32
    words_per = -(-n_words // D)
    rows_pad = words_per * D * 32
    fill = torch.full((rows_pad - n, m), INF, dtype=fitness.dtype, device=fitness.device)
    fit_rows = torch.cat([fitness, fill])
    slabs, counts = {}, {}
    for s in local_positions(mesh, axis_name):
        dev = devices[s]
        local_rows = fit_rows[s * words_per * 32:(s + 1) * words_per * 32].to(dev)
        slabs[s], counts[s] = packed_dominance_rows(local_rows, fitness.to(dev), device=dev)
    count = mesh_psum(counts, mesh, axis_name, fitness.device)

    def delta_fn(front_words: torch.Tensor) -> torch.Tensor:
        return mesh_psum({s: column_popcount(
            slab & front_words[s * words_per:(s + 1) * words_per].to(slab.device)[:, None])
            for s, slab in slabs.items()}, mesh, axis_name, fitness.device)

    return _peel_fronts(count, stop, words_per * D, delta_fn)


def non_dominated_sort(
    fitness: torch.Tensor,
    until: Optional[int] = None,
    return_cut_rank: bool = False,
    mesh: Any = None,
    axis_name: str = POP_AXIS,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Pareto rank of each row of ``fitness`` ``(n, m)``; rank 0 is the
    non-dominated front (minimisation).

    With ``until=k`` the peeling stops once at least ``k`` rows are ranked;
    unranked rows get the sentinel rank ``n``. ``return_cut_rank=True``
    also returns the rank at which the cumulative front sizes first reach
    ``until`` (the worst admitted rank of environmental selection), as a
    Python int (a 0-d tensor under ``torch.func.vmap``).

    ``mesh`` (with a ``axis_name`` axis of more than one shard): the
    row-sharded sort (module docstring), with the same ranks and cut.
    """
    n = fitness.shape[0]
    stop = n if until is None else min(until, n)
    if is_batched(fitness):  # stacked members: one batched sort (the vmap rule)
        if _mesh_axis_size(mesh, axis_name) > 1:
            raise ValueError("the mesh-sharded sort takes one member's fitness, not stacked "
                             "members (the batched sort is one launch for all of them)")
        rank, cut = _sort_op(fitness, stop)
        return (rank, cut) if return_cut_rank else rank
    if _mesh_axis_size(mesh, axis_name) > 1:
        rank, cut = _non_dominated_sort_sharded(fitness, mesh, stop, axis_name)
        return (rank, cut) if return_cut_rank else rank
    n_words = (n + 31) // 32
    dom_packed, count = packed_dominance(fitness, device=fitness.device)

    def delta_fn(front_words: torch.Tensor) -> torch.Tensor:
        return column_popcount(dom_packed & front_words[:, None])

    rank, cut = _peel_fronts(count, stop, n_words, delta_fn)
    if return_cut_rank:
        return rank, cut
    return rank


def crowding_distance(fitness: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NSGA-II crowding distance per row ``(n,)``, larger = less crowded.

    Rows outside the boolean ``mask`` get ``-inf`` so they sort last; the
    boundary rows of each objective get ``+inf``. The objectives' terms are
    added in objective order, as the JAX package's sum adds them.
    """
    n, m = fitness.shape
    dev = fitness.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    num_valid = mask.sum()
    last = torch.clamp_min(num_valid - 1, 0)
    fv = torch.where(mask[:, None], fitness, INF)
    order = torch.argsort(fv, dim=0, stable=True)
    s = fv.gather(0, order)
    f_range = torch.clamp_min(s.gather(0, last.expand(1, m)) - s[:1], 1e-12)
    inner = (s[2:] - s[:-2]) / f_range
    edge = torch.full((1, m), INF, dtype=fitness.dtype, device=dev)
    d = torch.cat([edge, inner, edge])
    pos = torch.arange(n, device=dev)[:, None]
    d = torch.where(pos == last, INF, d)
    d = torch.where(pos >= num_valid, -INF, d)
    d = torch.nan_to_num(d, nan=0.0, posinf=INF, neginf=-INF)
    d = torch.zeros_like(d).scatter(0, order, d)
    total = d[:, 0]
    for k in range(1, m):
        total = total + d[:, k]
    return total


def crowding_distance_sort(fitness: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices by descending crowding distance (ties by lowest index)."""
    return torch.argsort(-crowding_distance(fitness, mask), stable=True)


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.float16: torch.int16,
         torch.bfloat16: torch.int16}


def _canonical_rows(pop: torch.Tensor) -> torch.Tensor:
    """``pop`` as integers under ``jnp.unique``'s equality: every NaN one
    bit pattern (sign and payload dropped), ``-0.0`` written as ``0.0``.
    ``torch.unique`` on floats holds NaN unequal to itself."""
    if not pop.is_floating_point():
        return pop
    ints = _BITS[pop.dtype]
    nan_bits = torch.tensor(float("nan"), dtype=pop.dtype, device=pop.device).view(ints)
    bits = torch.where(pop == 0, torch.zeros_like(pop), pop).view(ints)
    return torch.where(torch.isnan(pop), nan_bits, bits)


def _first_occurrence(pop: torch.Tensor) -> torch.Tensor:
    """``(n,)`` bool: the row is the first of its equal rows, equal as
    ``jnp.unique`` holds them (NaN equals NaN, ``-0.0`` equals ``0.0``)."""
    n = pop.shape[0]
    unique, inverse = torch.unique(_canonical_rows(pop.reshape(n, -1)), dim=0, return_inverse=True)
    index = torch.arange(n, device=pop.device)
    # the smallest index of each group: every group has a member, so every
    # slot ends below n
    first = torch.full((unique.shape[0],), n, dtype=index.dtype, device=pop.device).scatter_reduce(
        0, inverse, index, reduce="amin"
    )
    is_first = torch.zeros((n,), dtype=torch.bool, device=pop.device)
    is_first[first] = True
    return is_first


def non_dominate_indices(
    fitness: torch.Tensor,
    topk: int,
    pop: Optional[torch.Tensor] = None,
    deduplicate: bool = False,
    mesh: Any = None,
) -> torch.Tensor:
    """Indices of the ``topk`` best by (rank, -crowding) environmental
    selection. With ``deduplicate`` (requires ``pop``), every repeat of a
    decision vector gets ``+inf`` fitness, so it goes to the back."""
    if deduplicate:
        fitness = torch.where(_first_occurrence(pop)[:, None], fitness, INF)
    rank, worst_rank = non_dominated_sort(fitness, until=topk, return_cut_rank=True, mesh=mesh)
    crowd = crowding_distance(fitness, mask=rank == worst_rank)
    return lexsort((-crowd, rank))[:topk]


def _take(pop: Any, order: torch.Tensor) -> Any:
    """``pop[order]`` for a tensor, or for each tensor of a dict, list or
    tuple of them (the JAX package's pytree of population leaves)."""
    if isinstance(pop, torch.Tensor):
        return pop[order]
    if isinstance(pop, dict):
        return {k: v[order] for k, v in pop.items()}
    return type(pop)(v[order] for v in pop)


def non_dominate(
    pop: Any,
    fitness: torch.Tensor,
    topk: int,
    deduplicate: bool = False,
    mesh: Any = None,
) -> Tuple[Any, torch.Tensor]:
    """Environmental selection: keep the ``topk`` best by (rank,
    -crowding). ``pop`` is a tensor or a dict, list or tuple of tensors with
    a leading population axis."""
    if isinstance(pop, torch.Tensor):
        leaf = pop
    else:
        leaf = next(iter(pop.values())) if isinstance(pop, dict) else pop[0]
    order = non_dominate_indices(fitness, topk, leaf, deduplicate, mesh)
    return _take(pop, order), fitness[order]


class NonDominate:
    """Class-form environmental selector."""

    def __init__(self, topk: int, deduplicate: bool = False, mesh: Any = None):
        self.topk = topk
        self.deduplicate = deduplicate
        self.mesh = mesh

    def __call__(self, pop: Any, fitness: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        return non_dominate(pop, fitness, self.topk, self.deduplicate, self.mesh)


def rank_crowding_truncate(
    fitness: torch.Tensor,
    k: int,
    mesh: Any = None,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NSGA-II environmental truncation: the ``k`` survivors of ``fitness``
    ``(n, m)`` by (Pareto rank ascending, crowding distance descending on
    the cut front). Returns ``(order, ranks)``: int64 survivor indices into
    ``fitness`` and their int32 ranks.

    ``use_kernel`` (``None``: :func:`~evox_tpu_torch.kernels.topk.
    default_use_kernel`, False): instead of the full ``lexsort``, admit the
    fronts better than the cut wholesale by an O(n) cumsum-scatter
    compaction, in index order, and fill the rest from the cut front by
    crowding through :func:`~evox_tpu_torch.kernels.topk.partial_topk` (the
    CUDA kernel for tensors on the card). The survivor SET equals the
    lexsort path's; the order of the admitted fronts is index order, not
    rank-major. ``interpret`` ran the JAX package's Pallas kernel in
    interpreter mode on the CPU; here it is accepted and ignored.
    """
    rank, worst_rank = non_dominated_sort(fitness, until=k, return_cut_rank=True, mesh=mesh)
    crowd = crowding_distance(fitness, mask=rank == worst_rank)
    if use_kernel is None:
        use_kernel = default_use_kernel()
    if not use_kernel:
        order = lexsort((-crowd, rank))[:k]
        return order, rank[order]
    n = fitness.shape[0]
    dev = fitness.device
    better = rank < worst_rank  # whole fronts above the cut: all admitted
    n_better = better.sum()  # < k by the cut's construction
    # slot k is a sink for every row not written: one extra slot, dropped
    order = torch.zeros((k + 1,), dtype=torch.int64, device=dev)
    pos = torch.cumsum(better, dim=0) - 1
    order = order.scatter(0, torch.where(better, pos, k), torch.arange(n, device=dev))
    # the cut front fills the remaining k - n_better slots by crowding,
    # descending: other rows carry +inf keys, boundary members -inf
    cut_key = torch.where(rank == worst_rank, -crowd, INF)
    _, cut_idx = partial_topk(cut_key, k, device=dev)
    j = torch.arange(k, device=dev)
    slots = torch.where(j < k - n_better, n_better + j, k)
    order = order.scatter(0, slots, cut_idx.to(torch.int64))
    order = order[:k]
    return order, rank[order]
