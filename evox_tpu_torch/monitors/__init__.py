from . import profiler
from .checkpoint_monitor import CheckpointMonitor
from .eval_monitor import EvalMonitor, EvalMonitorState
from .evoxvis_monitor import EvoXVisMonitor
from .lineage import LineageMonitor, LineageState
from .pop_monitor import PopMonitor
from .profiler import StepTimerMonitor
from .profiler import trace as profiler_trace
from .telemetry import TelemetryMonitor, TelemetryState

__all__ = ["CheckpointMonitor", "EvalMonitor", "EvalMonitorState", "EvoXVisMonitor",
           "LineageMonitor", "LineageState",
           "PopMonitor",
           "StepTimerMonitor", "TelemetryMonitor", "TelemetryState", "profiler", "profiler_trace"]
