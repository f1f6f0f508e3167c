from .de_ops import (
    DifferentialEvolve,
    de_arith_recom,
    de_bin_cross,
    de_diff_sum,
    de_exp_cross,
    differential_evolve,
)
from .sbx import SimulatedBinary, simulated_binary
from .simple import OnePoint, UniformRand, one_point, uniform_rand_cross

__all__ = [
    "DifferentialEvolve",
    "OnePoint",
    "SimulatedBinary",
    "UniformRand",
    "de_arith_recom",
    "de_bin_cross",
    "de_diff_sum",
    "de_exp_cross",
    "differential_evolve",
    "one_point",
    "simulated_binary",
    "uniform_rand_cross",
]
