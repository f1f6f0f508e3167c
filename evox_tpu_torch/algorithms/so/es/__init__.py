from .open_es import OpenES, OpenESState

__all__ = ["OpenES", "OpenESState"]
