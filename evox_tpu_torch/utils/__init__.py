from .common import (
    TreeAndVector,
    dominate_relation,
    float_vector,
    fold_in_seed,
    generator,
    lexsort,
    pairwise_euclidean_dist,
    parse_opt_direction,
    rank_based_fitness,
    split_seed,
    tree_flatten,
    tree_map,
)
from .optimizers import SGD, Adam, AdamState, make_optimizer

__all__ = [
    "Adam",
    "AdamState",
    "SGD",
    "TreeAndVector",
    "dominate_relation",
    "float_vector",
    "fold_in_seed",
    "generator",
    "lexsort",
    "make_optimizer",
    "pairwise_euclidean_dist",
    "parse_opt_direction",
    "rank_based_fitness",
    "split_seed",
    "tree_flatten",
    "tree_map",
]
