from .common import GAMOAlgorithm, MOState, uniform_init
from .eag_moead import EAGMOEAD, EAGMOEADState
from .lmocso import LMOCSO, LMOCSOState
from .moead import MOEAD, MOEADState
from .moead_variants import MOEADDRA, MOEADM2M, MOEADDRAState, MOEADM2MState
from .nsga2 import NSGA2, NSGA2State
from .nsga3 import NSGA3
from .rvea import RVEA, RVEAState
from .rveaa import RVEAa
from .tdea import TDEA

__all__ = ["EAGMOEAD", "EAGMOEADState", "GAMOAlgorithm", "LMOCSO", "LMOCSOState", "MOEAD",
           "MOEADDRA", "MOEADDRAState", "MOEADM2M", "MOEADM2MState", "MOEADState", "MOState",
           "NSGA2", "NSGA2State", "NSGA3", "RVEA", "RVEAState", "RVEAa", "TDEA", "uniform_init"]
