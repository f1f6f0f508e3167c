from .basic import (
    roulette_wheel,
    select_rand_pbest,
    topk_fit,
    tournament,
    tournament_multifit,
    uniform_rand,
)
from .non_dominate import (
    NonDominate,
    crowding_distance,
    crowding_distance_sort,
    non_dominate,
    non_dominate_indices,
    non_dominated_sort,
    rank_crowding_truncate,
)
from .rvea_selection import ref_vec_guided, ref_vec_guided_indices

__all__ = [
    "NonDominate",
    "crowding_distance",
    "crowding_distance_sort",
    "non_dominate",
    "non_dominate_indices",
    "non_dominated_sort",
    "rank_crowding_truncate",
    "ref_vec_guided",
    "ref_vec_guided_indices",
    "roulette_wheel",
    "select_rand_pbest",
    "topk_fit",
    "tournament",
    "tournament_multifit",
    "uniform_rand",
]
