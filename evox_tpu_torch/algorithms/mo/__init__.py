from .bce_ibea import BCEIBEA, BCEIBEAState
from .bige import BiGE
from .common import DrawnGAMOAlgorithm, GAMOAlgorithm, MOState, uniform_init
from .eag_moead import EAGMOEAD, EAGMOEADState
from .gde3 import GDE3
from .hype import HypE, HypEState
from .ibea import IBEA
from .im_moea import IMMOEA, IMMOEAState
from .knea import KnEA, KnEAState
from .lmocso import LMOCSO, LMOCSOState
from .moead import MOEAD, MOEADState
from .moead_variants import MOEADDRA, MOEADM2M, MOEADDRAState, MOEADM2MState
from .nsga2 import NSGA2, NSGA2State
from .nsga3 import NSGA3
from .rvea import RVEA, RVEAState
from .rveaa import RVEAa
from .spea2 import SPEA2
from .sra import SRA, SRAState
from .tdea import TDEA

__all__ = ["BCEIBEA", "BCEIBEAState", "BiGE", "DrawnGAMOAlgorithm", "EAGMOEAD", "EAGMOEADState",
           "GAMOAlgorithm", "GDE3", "HypE", "HypEState", "IBEA", "IMMOEA",
           "IMMOEAState", "KnEA", "KnEAState", "LMOCSO",
           "LMOCSOState", "MOEAD", "MOEADDRA", "MOEADDRAState", "MOEADM2M", "MOEADM2MState",
           "MOEADState", "MOState", "NSGA2", "NSGA2State", "NSGA3", "RVEA", "RVEAState", "RVEAa",
           "SPEA2", "SRA", "SRAState", "TDEA", "uniform_init"]
