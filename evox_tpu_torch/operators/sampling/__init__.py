from .grid import GridSampling
from .latin_hypercube import LatinHypercubeSampling, latin_hypercube
from .uniform import UniformSampling

__all__ = ["GridSampling", "LatinHypercubeSampling", "UniformSampling", "latin_hypercube"]
