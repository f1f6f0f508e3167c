"""CheckpointMonitor — the port of ``evox_tpu/monitors/checkpoint_monitor.py``:
periodic snapshots of the whole workflow state from a ``post_step`` hook.

The JAX monitor saves through ``io_callback`` from inside the compiled
step. PyTorch runs the step eagerly, so the port's hook saves directly,
through a :class:`~evox_tpu_torch.workflows.checkpoint.WorkflowCheckpointer`
on the same directory: every ``every`` generations it writes a snapshot
and its manifest durably and keeps the newest ``keep``. One snapshot
format serves both, with one integrity check. :meth:`latest` restores the
newest intact snapshot, also one left by an earlier process, as a host
state (``workflows.checkpoint.restore_layouts`` places it on a device). A
save blocks the step that makes it; the executor's background lane
(``wf.run(checkpointer=...)``) does not.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List

from ..core.monitor import Monitor
from ..workflows.checkpoint import WorkflowCheckpointer


class CheckpointMonitor(Monitor):
    # it reads the host each generation: a fleet (VectorizedWorkflow) refuses it
    uses_host_callbacks = True

    def __init__(self, directory: str, every: int = 10, keep: int = 3):
        self.checkpointer = WorkflowCheckpointer(directory, every=every, keep=keep)
        self.directory = self.checkpointer.directory
        self.every = every
        self.keep = keep

    @property
    def saved(self) -> List[Path]:
        """The committed snapshots in the directory, oldest to newest."""
        return self.checkpointer.snapshots()

    def hooks(self):
        return ("post_step",)

    def post_step(self, mstate: Any, wf_state: Any) -> Any:
        self.checkpointer.maybe_save(wf_state)
        return mstate

    def latest(self) -> Any:
        """The newest intact snapshot as a host state (``None`` when there
        is none); a torn or corrupt one is skipped with a warning."""
        return self.checkpointer.latest()
