"""Mixed-precision storage policy — the port of
``evox_tpu/core/dtype_policy.py``: bfloat16 at rest, float32 in flight.

Fields declare eligibility with ``field(storage=True)`` (the
population-leading float arrays: population, fitness, velocity,
offspring, per-individual noise) or opt out with ``storage=False``. An
annotation holds for everything below its field, until a field below it
says otherwise. Strategy parameters (CMA-ES's mean, covariance and
paths, step sizes) are never annotated, so they stay float32.

The workflow applies the policy at the state boundary: annotated leaves
are cast to ``policy.storage`` when the step's new algorithm state is
formed, and to ``policy.compute`` at step entry, so every reduction,
mean and covariance update runs in float32 and only the state carried
between generations (and into checkpoints) is narrow. Integer, bool and
seed leaves are never cast.

Eager PyTorch cannot fuse the casts into the step as XLA does: at step
entry ``apply_compute`` writes float32 copies of the storage leaves and
``apply_storage`` writes bfloat16 copies at its end, one more read and
write of each a generation (PERF.md §5 has the measured cost). The
bfloat16 cast writes NaN as XLA does (the sign and 0x7FC0), so the stored
bits are the JAX package's, on the CPU and on the card alike. A leaf held
resident on a mesh (``ShardedTensor``) is cast block by block where its
blocks lie, and stays resident.

Policy ``None`` (the workflow's default) returns the same state object
with no walk of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .distributed import ShardedTensor

__all__ = [
    "DtypePolicy",
    "BF16_STORAGE",
    "apply_storage",
    "apply_compute",
    "storage_eligible_fields",
    "policy_report",
]


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """``(storage, compute)`` dtype pair threaded through a workflow.

    ``storage``: dtype of storage-annotated leaves at rest (between
    generations and in checkpoints). ``compute``: the dtype they are cast
    to at step entry, in which every reduction therefore runs."""

    storage: torch.dtype = torch.float32
    compute: torch.dtype = torch.float32

    def __post_init__(self):
        for name in ("storage", "compute"):
            dt = getattr(self, name)
            if not (isinstance(dt, torch.dtype) and dt.is_floating_point):
                raise ValueError(f"DtypePolicy.{name} must be a floating torch dtype, got {dt}")

    @property
    def is_noop(self) -> bool:
        return self.storage == self.compute

    def report(self) -> dict:
        """JSON-serializable description."""
        return {
            "storage": str(self.storage).removeprefix("torch."),
            "compute": str(self.compute).removeprefix("torch."),
            "active": not self.is_noop,
        }


BF16_STORAGE = DtypePolicy(storage=torch.bfloat16, compute=torch.float32)


# NaN as XLA writes it in bfloat16: the sign and the quiet NaN 0x7FC0
# (PyTorch's vectorized CPU cast writes 0xFFFF for every NaN)
_BF16_NAN = torch.tensor([0x7FC0, -0x40], dtype=torch.int16).view(torch.bfloat16)


def _cast_leaf(t: torch.Tensor, target: torch.dtype) -> torch.Tensor:
    out = t.to(target)
    if target == torch.bfloat16 and t.dtype != torch.bfloat16:
        out = torch.where(torch.isnan(t), torch.where(torch.signbit(t), _BF16_NAN[1], _BF16_NAN[0]),
                          out)
    return out


def _cast(obj: Any, flag: bool, target: torch.dtype) -> Any:
    """``obj`` with its storage-eligible float tensors cast to ``target``;
    ``flag`` is the annotation in force above ``obj``."""
    if isinstance(obj, torch.Tensor):
        return _cast_leaf(obj, target) if flag and obj.is_floating_point() else obj
    if isinstance(obj, ShardedTensor):  # a resident leaf: cast block by block where it lies
        return obj.map_blocks(lambda b: _cast_leaf(b, target)) \
            if flag and obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            if f.metadata.get("static", False):
                continue
            value = getattr(obj, f.name)
            new = _cast(value, bool(f.metadata.get("storage", flag)), target)
            if new is not value:
                changes[f.name] = new
        return dataclasses.replace(obj, **changes) if changes else obj
    if isinstance(obj, dict):
        return {k: _cast(v, flag, target) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast(v, flag, target) for v in obj)
    return obj


def _apply(state: Any, policy: Optional[DtypePolicy], target_attr: str) -> Any:
    if policy is None or policy.is_noop:
        return state  # the same object: the default path is untouched
    return _cast(state, False, getattr(policy, target_attr))


def apply_storage(state: Any, policy: Optional[DtypePolicy]) -> Any:
    """Cast storage-annotated float leaves to the storage dtype: the at-rest
    form carried between generations and into checkpoints. The same
    object when ``policy`` is ``None`` or storage == compute."""
    return _apply(state, policy, "storage")


def apply_compute(state: Any, policy: Optional[DtypePolicy]) -> Any:
    """Cast storage-annotated float leaves to the compute dtype: the
    step-entry cast, so all algorithm math runs at full precision."""
    return _apply(state, policy, "compute")


def storage_eligible_fields(state: Any) -> dict:
    """``{field_path: bool}`` of every annotated dataclass field in
    ``state``, nested states included; unannotated fields are absent."""
    out: dict = {}

    def walk(obj: Any, prefix: str) -> None:
        if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
            return
        for f in dataclasses.fields(obj):
            path = f"{prefix}{f.name}"
            if "storage" in f.metadata:
                out[path] = bool(f.metadata["storage"])
            walk(getattr(obj, f.name), f"{path}.")

    walk(state, "")
    return out


def policy_report(workflow: Any) -> dict:
    """The ``dtype_policy`` section of a report, read off
    ``workflow.dtype_policy`` (absent means float32)."""
    policy = getattr(workflow, "dtype_policy", None)
    if policy is None:
        return {"storage": "float32", "compute": "float32", "active": False}
    return policy.report()
