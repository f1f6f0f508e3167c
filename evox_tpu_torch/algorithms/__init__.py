from .containers import (
    ClusteredAlgorithm,
    Coevolution,
    RandomMaskAlgorithm,
    TreeAlgorithm,
    VectorizedCoevolution,
)
from .mo import (
    BCEIBEA,
    GDE3,
    IBEA,
    NSGA2,
    SPEA2,
    SRA,
    BCEIBEAState,
    BiGE,
    HypE,
    HypEState,
    KnEA,
    KnEAState,
    NSGA2State,
    SRAState,
)
from .so import CSO, PSO, OpenES, OpenESState

__all__ = ["BCEIBEA", "BCEIBEAState", "BiGE", "CSO", "ClusteredAlgorithm", "Coevolution", "GDE3",
           "HypE", "HypEState", "IBEA", "KnEA", "KnEAState", "NSGA2", "NSGA2State", "OpenES",
           "OpenESState", "PSO", "RandomMaskAlgorithm", "SPEA2", "SRA", "SRAState", "TreeAlgorithm",
           "VectorizedCoevolution"]
