from .eval_monitor import EvalMonitor, EvalMonitorState

__all__ = ["EvalMonitor", "EvalMonitorState"]
