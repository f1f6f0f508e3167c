from .common import fold_in_seed, parse_opt_direction, rank_based_fitness, split_seed
from .optimizers import SGD, Adam, AdamState, make_optimizer

__all__ = [
    "Adam",
    "AdamState",
    "SGD",
    "fold_in_seed",
    "make_optimizer",
    "parse_opt_direction",
    "rank_based_fitness",
    "split_seed",
]
