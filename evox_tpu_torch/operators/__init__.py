from . import crossover, gaussian_process, mutation, sampling, sanitize, selection, surrogate
from .sanitize import BOUND_METHODS, sanitize_bounds, validate_bound_handling

__all__ = ["BOUND_METHODS", "crossover", "gaussian_process", "mutation", "sampling", "sanitize",
           "sanitize_bounds", "selection", "surrogate", "validate_bound_handling"]
