from . import neuroevolution

__all__ = ["neuroevolution"]
