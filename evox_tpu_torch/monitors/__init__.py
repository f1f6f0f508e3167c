from .checkpoint_monitor import CheckpointMonitor
from .eval_monitor import EvalMonitor, EvalMonitorState

__all__ = ["CheckpointMonitor", "EvalMonitor", "EvalMonitorState"]
