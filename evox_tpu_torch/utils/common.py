"""Common utilities — the port of parts of ``evox_tpu/utils/common.py``.

- ``TreeAndVector``: parameter trees to flat genomes and back, batched.
- ``tree_flatten``/``tree_map``: trees of dicts and lists, leaves in
  ``jax.tree.leaves`` order (dict keys sorted).
- ``parse_opt_direction``: min/max → ±1 per objective.
- ``rank_based_fitness``: centered ranks in [-0.5, 0.5].
- ``dominate_relation``: the Pareto-dominance matrix (minimisation).
- ``pairwise_euclidean_dist``: ``(n, m)`` distances between two point sets;
  ``pairwise_manhattan_dist``, ``pairwise_chebyshev_dist``, ``cos_dist``.
- ``inner_products``, ``sum_last``, ``row_norm``, ``sqrt_rn``: products,
  sums and square roots over a short last axis (objectives) by
  elementwise steps in index order, correctly rounded, which give the same
  bits on the card and on the CPU; ``halving_sum`` and ``exp_rn``, a long
  sum in a fixed order and a correctly rounded ``exp``, for the same end.
- ``lexsort``: ``jnp.lexsort`` from successive stable sorts.
- ``blocked_cumsum``/``weighted_indices``: ``jnp.cumsum`` in XLA's CPU
  order, and the indices ``jax.random.choice(p=)`` draws from uniforms.
- ``generator``: a ``torch.Generator`` seeded from an integer.
- ``float_vector``: a float32 copy of a bound or other vector argument.
- ``split_seed``/``fold_in_seed``: the integer-seed counterparts of
  ``jax.random.split``/``fold_in``. States hold Python integers, and every
  draw comes from a ``torch.Generator`` seeded with one of them. The port's
  numbers differ from JAX's threefry draws; tests hand both the same
  numbers where they compare the two.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

_SEED_BOUND = 2**62


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[Sequence[Any]], Any]]:
    """``(leaves, rebuild)`` of a tree of dicts and lists: the leaves in
    ``jax.tree.leaves`` order (dict keys sorted, lists in order), and the
    function that builds the same tree around new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        make = lambda children: dict(zip(keys, children))
    elif isinstance(tree, list):
        parts = [tree_flatten(x) for x in tree]
        make = list
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves: Sequence[Any]) -> Any:
        children, at = [], 0
        for (_, sub), c in zip(parts, counts):
            children.append(sub(leaves[at : at + c]))
            at += c
        return make(children)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(x) for x in leaves])


class TreeAndVector:
    """Between a parameter tree and a flat genome — the port of
    ``evox_tpu/utils/common.py::TreeAndVector``.

    The genome holds the leaves in ``ravel_pytree``'s order (dict keys
    sorted, so each ``mlp_policy`` layer is ``b`` then ``w``), each leaf
    row-major, so genomes cross between the two packages unchanged.
    ``batched_to_tree`` and ``batched_to_vector`` work on a leading
    population axis; ``batched_to_tree`` returns views into the ``(pop,
    dim)`` tensor (copies only when its rows are not unit-strided), so
    a workflow's pop transform moves no genome bytes.
    """

    def __init__(self, dummy_input: Any):
        leaves, self._rebuild = tree_flatten(dummy_input)
        self._shapes = [tuple(torch.as_tensor(x).shape) for x in leaves]
        self._sizes = [math.prod(s) for s in self._shapes]
        self.dim = sum(self._sizes)

    def to_vector(self, tree: Any) -> torch.Tensor:
        leaves, _ = tree_flatten(tree)
        return torch.cat([torch.as_tensor(x).reshape(-1) for x in leaves])

    def to_tree(self, vector: torch.Tensor) -> Any:
        return self._split(vector, ())

    def batched_to_vector(self, trees: Any) -> torch.Tensor:
        leaves, _ = tree_flatten(trees)
        n = leaves[0].shape[0]
        return torch.cat([x.reshape(n, -1) for x in leaves], dim=1)

    def batched_to_tree(self, vectors: torch.Tensor) -> Any:
        return self._split(vectors, tuple(vectors.shape[:-1]))

    def _split(self, vectors: torch.Tensor, lead: Tuple[int, ...]) -> Any:
        if vectors.shape[-1] != self.dim:
            raise ValueError(f"genome length {vectors.shape[-1]} != {self.dim}")
        leaves, at = [], 0
        for shape, size in zip(self._shapes, self._sizes):
            leaves.append(vectors[..., at : at + size].reshape(lead + shape))
            at += size
        return self._rebuild(leaves)


def split_seed(seed: int, num: int = 2) -> List[int]:
    """``num`` new seeds derived deterministically from ``seed`` (on the
    host: a few microseconds, no device work)."""
    g = torch.Generator().manual_seed(int(seed) % 2**63)
    return torch.randint(0, _SEED_BOUND, (num,), generator=g).tolist()


def fold_in_seed(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` without advancing ``seed``."""
    return split_seed((int(seed) * 1_000_003 + int(data) + 1) % 2**63, 1)[0]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: where every
    draw of the port comes from."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def float_vector(x: Any, device: torch.device) -> torch.Tensor:
    """A float32 copy of ``x`` (a tensor, or anything numpy reads) on
    ``device``: how constructors take their bound vectors."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def parse_opt_direction(opt_direction: Union[str, Sequence[str]]) -> torch.Tensor:
    """Map ``"min"``/``"max"`` (or a per-objective list) to a ±1 float32
    vector on the CPU. Workflows multiply fitness by it so algorithms
    always minimize."""
    if isinstance(opt_direction, str):
        opt_direction = [opt_direction]
    signs = []
    for d in opt_direction:
        if d == "min":
            signs.append(1.0)
        elif d == "max":
            signs.append(-1.0)
        else:
            raise ValueError(f"opt_direction must be 'min' or 'max', got {d!r}")
    return torch.tensor(signs, dtype=torch.float32)


def rank_based_fitness(fitness: torch.Tensor) -> torch.Tensor:
    """Centered-rank fitness shaping in [-0.5, 0.5] (OpenAI-ES style).

    The argsort is stable, so tied values rank in index order, as
    ``jnp.argsort`` ranks them."""
    n = fitness.shape[0]
    order = torch.argsort(fitness, stable=True)
    ranks = torch.empty_like(fitness)
    ranks[order] = torch.arange(n, dtype=fitness.dtype, device=fitness.device)
    return ranks / (n - 1) - 0.5


def pairwise_euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(n, d)``, ``(m, d)`` -> ``(n, m)`` Euclidean distances, through one
    matrix product (the JAX package's formulation)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    sq = x2 - 2.0 * (x @ y.T) + y2.T
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def pairwise_manhattan_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def pairwise_chebyshev_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, added in index order one elementwise step at
    a time. A reduction kernel may add in another order on the card than on
    the CPU; these steps round alike on both."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor. The card's is;
    PyTorch's vectorised CPU one can be an ulp off (about one float32 input
    in six with AVX-512), so the root is taken in float64 and rounded back,
    which gives the correctly rounded float32 root on both."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def exp_rn(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, rounded once from float64: the card's
    ``expf`` and the CPU's vectorised one each miss the correctly rounded
    value now and then, and not alike."""
    return torch.exp(x.to(torch.float64)).to(x.dtype)


def halving_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in a fixed order: the first half of the slices is
    added to the second, elementwise, until one is left (an odd last slice
    waits for a later round). ``log2(n)`` elementwise launches whose
    roundings are the same on the card and on the CPU, where a reduction
    kernel adds in an order of its own."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        head = x[:h] + x[h : 2 * h]
        x = torch.cat([head, x[2 * h :]]) if x.shape[0] % 2 else head
    return x[0]


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, squares added in index order."""
    return sqrt_rn(sum_last(x * x))


def inner_products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(n, k)``, ``(m, k)`` -> ``(n, m)``: ``x @ y.T`` for a short inner
    axis ``k`` (objectives), summed in index order by elementwise steps.
    cuBLAS and the CPU's BLAS may round the same product differently, and
    the callers' argmax and argsort turn on its last bits."""
    out = torch.mul(x[:, None, 0], y[None, :, 0])
    tmp = torch.empty_like(out)
    for j in range(1, x.shape[1]):
        torch.mul(x[:, None, j], y[None, :, j], out=tmp)
        out.add_(tmp)
    return out


def cos_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(n, d)``, ``(m, d)`` -> ``(n, m)`` cosine similarity, for a short
    ``d`` (through :func:`inner_products`)."""
    return inner_products(x / row_norm(x)[:, None], y / row_norm(y)[:, None])


def dominate_relation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Boolean ``(n, m)`` matrix: ``out[i, j]`` iff ``x[i]`` Pareto-dominates
    ``y[j]`` (minimisation: no objective worse, at least one better).

    A loop over the small objective axis, each step an ``(n, m)`` compare,
    as in the JAX package. A NaN objective makes every compare false, so a
    row holding one dominates nothing and is dominated by nothing.
    """
    le = torch.ones((x.shape[0], y.shape[0]), dtype=torch.bool, device=x.device)
    lt = torch.zeros_like(le)
    for k in range(x.shape[1]):
        xk = x[:, k, None]
        yk = y[None, :, k]
        le &= xk <= yk
        lt |= xk < yk
    return le & lt


CUMSUM_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The cumulative sum of ``x`` ``(n,)`` in the order XLA's CPU backend
    adds it (the JAX package's ``jnp.cumsum`` in the tests): blocks of
    ``CUMSUM_BLOCK`` summed left to right, the blocks' totals by the same
    rule, each block's carry added to its sums. ``torch.cumsum`` rounds in
    another order, and a draw with probabilities would then pick the
    neighbouring index now and then. Elementwise adds only: the card and the
    CPU round alike."""
    n = x.shape[0]
    if n <= CUMSUM_BLOCK:
        blocks = x[None]
    else:
        pad = -n % CUMSUM_BLOCK
        blocks = torch.cat([x, x.new_zeros((pad,))]).reshape(-1, CUMSUM_BLOCK)
    cols = [blocks[:, 0]]
    for j in range(1, blocks.shape[1]):
        cols.append(cols[-1] + blocks[:, j])
    inner = torch.stack(cols, dim=1)
    if n <= CUMSUM_BLOCK:
        return inner[0]
    carry = torch.cat([x.new_zeros((1,)), blocked_cumsum(inner[:, -1])[:-1]])
    return (carry[:, None] + inner).reshape(-1)[:n]


def weighted_indices(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn with probabilities ``p`` (``(n,)``, not necessarily
    normalised) from the uniform draw ``u``, as ``jax.random.choice(key, n,
    u.shape, p=p)`` draws them: a left search of ``cumsum(p)`` (summed as
    :func:`blocked_cumsum` sums it) for ``total * (1 - u)``, so a flat
    stretch of the sums goes to its first index. No host read, and no error
    on an all-zero ``p`` (index 0)."""
    cum = blocked_cumsum(p)
    return torch.searchsorted(cum, cum[-1] * (1.0 - u)).clamp_max(p.shape[0] - 1)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that sort by ``keys``, the LAST key primary, ties kept in
    index order: ``jnp.lexsort``. Built from one stable sort per key,
    least significant first."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order
