from .checkpoint import CheckpointConfigError, WorkflowCheckpointer
from .islands import IslandWorkflow, IslandWorkflowState
from .pipelined import chunked_evaluate, run_host_pipelined
from .std import StdWorkflow, StdWorkflowState

__all__ = [
    "CheckpointConfigError",
    "IslandWorkflow",
    "IslandWorkflowState",
    "StdWorkflow",
    "StdWorkflowState",
    "WorkflowCheckpointer",
    "chunked_evaluate",
    "run_host_pipelined",
]
