from .mo import NSGA2, NSGA2State
from .so import CSO, PSO, OpenES, OpenESState

__all__ = ["CSO", "NSGA2", "NSGA2State", "OpenES", "OpenESState", "PSO"]
