"""evox_tpu_torch — the PyTorch/CUDA port of evox_tpu.

The same ask–evaluate–tell surface as the JAX package (``evox_tpu``, which
stays the reference), written in PyTorch for one NVIDIA Hopper card. Plain
tensor code is PyTorch; every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (CUDA C++ under ``csrc/``), beside a plain
PyTorch version with the same contract.

Every entry point takes ``device=None``, which means ``"cuda"``; it raises
when CUDA is missing unless the caller passes ``device="cpu"``. A kernel
wrapper takes its plain version only for tensors that lie on the CPU.

This package imports neither ``jax`` nor anything of ``evox_tpu``.
"""

__version__ = "0.1.0"

from .core import (
    Algorithm,
    CostAnalyzer,
    DispatchRecorder,
    GuardedAlgorithm,
    IPOPRestarts,
    Monitor,
    Problem,
    PyTreeNode,
    RetraceError,
    ShardedES,
    create_mesh,
    field,
    instrument,
    member_call,
    stack_states,
    unstack_states,
    resolve_device,
    run_report,
    static_field,
    write_chrome_trace,
    write_report_jsonl,
)
from .workflows import (
    IslandWorkflow,
    IslandWorkflowState,
    RunQueue,
    RunSupervisor,
    StdWorkflow,
    StdWorkflowState,
    SurrogateWorkflow,
    SurrogateWorkflowState,
    TenantSpec,
    VectorizedWorkflow,
    VectorizedWorkflowState,
)

__all__ = [
    "Algorithm",
    "CostAnalyzer",
    "DispatchRecorder",
    "GuardedAlgorithm",
    "IPOPRestarts",
    "IslandWorkflow",
    "IslandWorkflowState",
    "Monitor",
    "Problem",
    "PyTreeNode",
    "RetraceError",
    "RunQueue",
    "RunSupervisor",
    "ShardedES",
    "StdWorkflow",
    "StdWorkflowState",
    "SurrogateWorkflow",
    "SurrogateWorkflowState",
    "TenantSpec",
    "VectorizedWorkflow",
    "VectorizedWorkflowState",
    "create_mesh",
    "field",
    "instrument",
    "member_call",
    "resolve_device",
    "run_report",
    "stack_states",
    "static_field",
    "unstack_states",
    "write_chrome_trace",
    "write_report_jsonl",
]
