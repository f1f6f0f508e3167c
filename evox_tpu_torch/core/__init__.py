from .algorithm import Algorithm
from .device import resolve_device
from .guardrail import (
    TRIGGER_DIVERSITY,
    TRIGGER_NONFINITE,
    TRIGGER_SIGMA,
    TRIGGER_STAGNATION,
    GuardedAlgorithm,
    GuardedState,
    IPOPRestarts,
    recenter_state,
)
from .monitor import HOOK_NAMES, Monitor
from .problem import Problem
from .struct import PyTreeNode, field, pytree_dataclass, replace, static_field

__all__ = [
    "Algorithm",
    "GuardedAlgorithm",
    "GuardedState",
    "IPOPRestarts",
    "TRIGGER_DIVERSITY",
    "TRIGGER_NONFINITE",
    "TRIGGER_SIGMA",
    "TRIGGER_STAGNATION",
    "recenter_state",
    "HOOK_NAMES",
    "Monitor",
    "Problem",
    "PyTreeNode",
    "field",
    "pytree_dataclass",
    "replace",
    "resolve_device",
    "static_field",
]
