"""Decision-space decomposition containers — the port of
``evox_tpu/algorithms/containers``: meta-algorithms that split the decision
vector into blocks (or a parameter tree into leaves) and run one instance
of a base algorithm per block.

The JAX package stacks the member states on a leading axis
(``vmap(base.init)``) and runs every member as one vmapped program. The
port holds a **tuple of member states** and loops over the members:
its algorithms draw from ``torch.Generator``s seeded from integers held in
their states, and its kernels are ``ctypes`` launches, neither of which
``torch.func.vmap`` can batch. Member ``i``'s seed comes from
``split_seed``, as member ``i``'s key comes from ``jax.random.split``.
:func:`take_state` and :func:`put_state` split and join states stacked on
a leading axis (the JAX package's, for ``interop``).
"""

from .clustered import ClusteredAlgorithm, RandomMaskAlgorithm, RandomMaskState
from .coevolution import Coevolution, CoevolutionState, VectorizedCoevolution
from .common import put_state, take_state
from .tree import TreeAlgorithm

__all__ = [
    "ClusteredAlgorithm",
    "Coevolution",
    "CoevolutionState",
    "RandomMaskAlgorithm",
    "RandomMaskState",
    "TreeAlgorithm",
    "VectorizedCoevolution",
    "put_state",
    "take_state",
]
