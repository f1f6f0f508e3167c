from .so import OpenES, OpenESState

__all__ = ["OpenES", "OpenESState"]
