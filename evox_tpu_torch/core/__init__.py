from .algorithm import Algorithm
from .attest import IntegrityError, StateAttestor, bisect_divergence, state_digest
from .cost import CHIP_CEILINGS, CostAnalyzer
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
from .instrument import (
    DispatchRecorder,
    RetraceError,
    instrument,
    run_report,
    write_chrome_trace,
    write_report_jsonl,
)
from .members import (
    MemberSeeds,
    member_call,
    member_route,
    member_rows,
    put_state,
    stack_states,
    take_state,
    unstack_states,
)
from .metrics import MetricsRegistry
from .monitor import HOOK_NAMES, Monitor
from .problem import Problem
from .struct import PyTreeNode, field, pytree_dataclass, replace, static_field

__all__ = [
    "Algorithm",
    "CHIP_CEILINGS",
    "CostAnalyzer",
    "DispatchRecorder",
    "RetraceError",
    "GuardedAlgorithm",
    "GuardedState",
    "IPOPRestarts",
    "TRIGGER_DIVERSITY",
    "TRIGGER_NONFINITE",
    "TRIGGER_SIGMA",
    "TRIGGER_STAGNATION",
    "recenter_state",
    "HOOK_NAMES",
    "IntegrityError",
    "MemberSeeds",
    "MetricsRegistry",
    "member_call",
    "member_route",
    "member_rows",
    "put_state",
    "stack_states",
    "take_state",
    "unstack_states",
    "StateAttestor",
    "bisect_divergence",
    "state_digest",
    "Monitor",
    "Problem",
    "PyTreeNode",
    "field",
    "instrument",
    "pytree_dataclass",
    "replace",
    "resolve_device",
    "run_report",
    "static_field",
    "write_chrome_trace",
    "write_report_jsonl",
]
