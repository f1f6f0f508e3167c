from . import topology
from .clpso import CLPSO, CLPSOState
from .cso import CSO, CSOPass, CSOState
from .dms_pso_el import DMSPSOEL, DMSPSOELState
from .fips import FIPS, FIPSState
from .fs_pso import FSPSO, FSPSOState
from .pso import PSO, PSOState
from .sl_pso import SLPSOGS, SLPSOUS, SLPSOState
from .swmmpso import SwmmPSO, SwmmPSOState

__all__ = [
    "SwmmPSO",
    "SwmmPSOState",
    "PSO",
    "PSOState",
    "CSO",
    "CSOState",
    "CLPSO",
    "SLPSOGS",
    "SLPSOUS",
    "FIPS",
    "DMSPSOEL",
    "FSPSO",
    "topology",
]
