from .islands import IslandWorkflow, IslandWorkflowState
from .std import StdWorkflow, StdWorkflowState

__all__ = ["IslandWorkflow", "IslandWorkflowState", "StdWorkflow", "StdWorkflowState"]
