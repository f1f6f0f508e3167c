from .checkpoint import CheckpointConfigError, WorkflowCheckpointer
from .control_plane import ControlLedger, ControlPlane, PodAutoscaler, PodRuntime
from .elastic import (
    BucketError,
    BucketShape,
    BucketTable,
    ElasticServer,
    ElasticSpec,
    ElasticWorkflow,
    PopAutoscaler,
    warm_fleet_cache,
)
from .fleet_health import FleetHealthPolicy, fleet_health_signals
from .flightrec import FlightRecorder, MetricsStream, merge_pod_streams, read_stream
from .islands import IslandWorkflow, IslandWorkflowState
from .journal import ChainedLog, JournalIntegrityError, RunJournal
from .multilevel import HyperSpec, MultiLevelES, MultiLevelState
from .pipelined import chunked_evaluate, run_host_pipelined
from .std import StdWorkflow, StdWorkflowState
from .supervisor import DispatchDeadlineError, RunAbortedError, RunSupervisor, classify_error
from .surrogate import SurrogateWorkflow, SurrogateWorkflowState
from .tenancy import (
    RunQueue,
    TenantSpec,
    TenantState,
    VectorizedWorkflow,
    VectorizedWorkflowState,
    bind_hyperparams,
)

__all__ = [
    "BucketError",
    "BucketShape",
    "BucketTable",
    "ElasticServer",
    "ElasticSpec",
    "ElasticWorkflow",
    "FleetHealthPolicy",
    "HyperSpec",
    "MultiLevelES",
    "MultiLevelState",
    "PopAutoscaler",
    "fleet_health_signals",
    "warm_fleet_cache",
    "ChainedLog",
    "ControlLedger",
    "ControlPlane",
    "PodAutoscaler",
    "PodRuntime",
    "DispatchDeadlineError",
    "RunAbortedError",
    "RunSupervisor",
    "classify_error",
    "CheckpointConfigError",
    "FlightRecorder",
    "IslandWorkflow",
    "IslandWorkflowState",
    "JournalIntegrityError",
    "MetricsStream",
    "RunJournal",
    "RunQueue",
    "StdWorkflow",
    "StdWorkflowState",
    "SurrogateWorkflow",
    "SurrogateWorkflowState",
    "TenantSpec",
    "TenantState",
    "VectorizedWorkflow",
    "VectorizedWorkflowState",
    "WorkflowCheckpointer",
    "bind_hyperparams",
    "chunked_evaluate",
    "merge_pod_streams",
    "read_stream",
    "run_host_pipelined",
]
