from .common import GAMOAlgorithm, MOState, uniform_init
from .nsga2 import NSGA2, NSGA2State

__all__ = ["GAMOAlgorithm", "MOState", "NSGA2", "NSGA2State", "uniform_init"]
