from . import neuroevolution, numerical

__all__ = ["neuroevolution", "numerical"]
