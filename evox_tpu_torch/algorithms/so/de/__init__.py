from .code import CoDE, CoDEState
from .de import DE, DEState, select_rand_indices
from .jade import JaDE, JaDEState
from .ode import ODE
from .sade import SaDE, SaDEState
from .shade import SHADE, SHADEState

__all__ = [
    "CoDE",
    "CoDEState",
    "DE",
    "DEState",
    "JaDE",
    "JaDEState",
    "ODE",
    "SHADE",
    "SHADEState",
    "SaDE",
    "SaDEState",
    "select_rand_indices",
]
