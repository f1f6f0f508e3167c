from . import crossover, mutation, sampling, selection

__all__ = ["crossover", "mutation", "sampling", "selection"]
