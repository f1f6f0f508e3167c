from .checkpoint_monitor import CheckpointMonitor
from .eval_monitor import EvalMonitor, EvalMonitorState
from .telemetry import TelemetryMonitor, TelemetryState

__all__ = ["CheckpointMonitor", "EvalMonitor", "EvalMonitorState", "TelemetryMonitor",
           "TelemetryState"]
