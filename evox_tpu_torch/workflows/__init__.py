from .std import StdWorkflow, StdWorkflowState

__all__ = ["StdWorkflow", "StdWorkflowState"]
