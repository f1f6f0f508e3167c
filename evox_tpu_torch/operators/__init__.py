from . import crossover, mutation, sampling, sanitize, selection
from .sanitize import BOUND_METHODS, sanitize_bounds, validate_bound_handling

__all__ = ["BOUND_METHODS", "crossover", "mutation", "sampling", "sanitize", "sanitize_bounds",
           "selection", "validate_bound_handling"]
