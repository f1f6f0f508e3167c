from .common import (
    dominate_relation,
    fold_in_seed,
    generator,
    lexsort,
    pairwise_euclidean_dist,
    parse_opt_direction,
    rank_based_fitness,
    split_seed,
)
from .optimizers import SGD, Adam, AdamState, make_optimizer

__all__ = [
    "Adam",
    "AdamState",
    "SGD",
    "dominate_relation",
    "fold_in_seed",
    "generator",
    "lexsort",
    "make_optimizer",
    "pairwise_euclidean_dist",
    "parse_opt_direction",
    "rank_based_fitness",
    "split_seed",
]
