from .de_ops import (
    DifferentialEvolve,
    de_arith_recom,
    de_bin_cross,
    de_diff_sum,
    de_exp_cross,
    differential_evolve,
)
from .sbx import SimulatedBinary, simulated_binary

__all__ = [
    "DifferentialEvolve",
    "SimulatedBinary",
    "de_arith_recom",
    "de_bin_cross",
    "de_diff_sum",
    "de_exp_cross",
    "differential_evolve",
    "simulated_binary",
]
