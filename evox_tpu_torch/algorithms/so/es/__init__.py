from .amalgam import AMaLGaM, AMaLGaMState, IndependentAMaLGaM
from .ars import ARS, ARSState
from .asebo import ASEBO, ASEBOState
from .cma_es import (
    BIPOPCMAES,
    CMAES,
    IPOPCMAES,
    CMAESState,
    RestartCMAESDriver,
    SepCMAES,
    SepCMAESState,
)
from .cr_fm_nes import CR_FM_NES, CRFMNESState
from .des import DES, DESState
from .esmc import ESMC, ESMCState
from .guided_es import GuidedES, GuidedESState
from .les import LES, LESState
from .ma_es import LMMAES, MAES, LMMAESState, MAESState
from .nes import XNES, SeparableNES, SeparableNESState, XNESState
from .open_es import OpenES, OpenESState
from .persistent_es import NoiseReuseES, NoiseReuseESState, PersistentES, PersistentESState
from .pgpe import PGPE, ClipUp, PGPEState
from .rmes import RMES, RMESState
from .snes import SNES, SNESState

__all__ = [
    "AMaLGaM",
    "AMaLGaMState",
    "ARS",
    "ARSState",
    "ASEBO",
    "ASEBOState",
    "BIPOPCMAES",
    "CMAES",
    "CMAESState",
    "CRFMNESState",
    "CR_FM_NES",
    "ClipUp",
    "DES",
    "DESState",
    "ESMC",
    "ESMCState",
    "GuidedES",
    "GuidedESState",
    "IPOPCMAES",
    "IndependentAMaLGaM",
    "LES",
    "LESState",
    "LMMAES",
    "LMMAESState",
    "MAES",
    "MAESState",
    "NoiseReuseES",
    "NoiseReuseESState",
    "OpenES",
    "OpenESState",
    "PGPE",
    "PGPEState",
    "PersistentES",
    "PersistentESState",
    "RMES",
    "RMESState",
    "RestartCMAESDriver",
    "SNES",
    "SNESState",
    "SepCMAES",
    "SepCMAESState",
    "SeparableNES",
    "SeparableNESState",
    "XNES",
    "XNESState",
]
