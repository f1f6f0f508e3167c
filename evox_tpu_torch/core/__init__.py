from .algorithm import Algorithm
from .device import resolve_device
from .monitor import HOOK_NAMES, Monitor
from .problem import Problem
from .struct import PyTreeNode, field, pytree_dataclass, replace, static_field

__all__ = [
    "Algorithm",
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
