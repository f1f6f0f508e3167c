from .checkpoint import CheckpointConfigError, WorkflowCheckpointer
from .islands import IslandWorkflow, IslandWorkflowState
from .pipelined import chunked_evaluate, run_host_pipelined
from .std import StdWorkflow, StdWorkflowState
from .surrogate import SurrogateWorkflow, SurrogateWorkflowState

__all__ = [
    "CheckpointConfigError",
    "IslandWorkflow",
    "IslandWorkflowState",
    "StdWorkflow",
    "StdWorkflowState",
    "SurrogateWorkflow",
    "SurrogateWorkflowState",
    "WorkflowCheckpointer",
    "chunked_evaluate",
    "run_host_pipelined",
]
