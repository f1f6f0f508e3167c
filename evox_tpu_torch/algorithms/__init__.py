from .mo import NSGA2, NSGA2State
from .so import OpenES, OpenESState

__all__ = ["NSGA2", "NSGA2State", "OpenES", "OpenESState"]
