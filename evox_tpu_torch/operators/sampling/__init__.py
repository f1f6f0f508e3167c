from .uniform import UniformSampling

__all__ = ["UniformSampling"]
