"""Cost analysis and roofline attribution, all on the host — the port of
``evox_tpu/core/xla_cost.py``.

:mod:`~evox_tpu_torch.core.instrument` answers how long each call took;
this module answers why: is an entry point bound by the card's arithmetic,
by its memory, or by everything else (the host's enqueue of eager
operators, host reads, Python)?

- **Counting**: eager PyTorch has no ahead-of-time cost analysis, so
  :func:`analyze_callable` runs the entry once under a
  ``TorchDispatchMode`` counter and throws away what that run returns.
  FLOPs: the matmul family (mm, addmm, bmm, baddbmm, convolutions, SDPA)
  by ``torch.utils.flop_counter``'s formulas, one FLOP an output element
  for every other operator; bytes: every operator's tensor operands plus
  its outputs. Views and allocations do no work and count nothing. The
  hand kernels are called through ``ctypes`` and bypass the dispatcher,
  so each kernel wrapper charges its own work (:func:`charge`), counted
  as ``chip_smoke.py``'s bound column counts it (the ``*_work`` functions
  of ``kernels/``). Work that runs on the host in numpy (a host problem's
  ``evaluate``) is outside the count, as XLA's analysis leaves the host
  callback out.
- **Memory, per mesh position**: eager PyTorch has no
  ``memory_analysis()``, so the counter follows the bytes that are live
  while the entry runs, and keeps each mesh position's peak (a position
  is "a device" of a mesh whose devices repeat): the position's resident
  input blocks (``core/distributed.py``'s ``ShardedTensor``), the storages
  made while its per-shard function runs (``shard_map``'s context), each
  followed by a weak reference to its storage until it is freed, and the
  work outside any per-shard function, which counts at the controller's
  position (the first this process holds). Unlike XLA's static analysis
  of a compiled program, this is what one run allocates: a storage is
  counted at the position that made it, whatever device it lies on, and
  the caching allocator's rounding is not counted. ``memory`` reports the
  largest position's peak as ``peak_bytes_estimate`` (what
  ``run_report``'s ``roofline.sharding`` compares with the whole
  population's bytes), and ``output_shapes`` every shape an operator
  returned (a ``(pop, dim)`` output is a gather).
- **Per generation**: a workflow's ``run`` is analysed at one generation
  (``analysis_targets``), the unit of the recorder's differenced slope.
- **Roofline**: static FLOPs and bytes over the measured seconds a unit
  give achieved rates against :data:`CHIP_CEILINGS`; float32 (and integer)
  work against the card's float32 rate, bf16 and fp16 work against its
  tensor-core rate.

Dependency direction: this module imports only torch; it never
imports :mod:`~evox_tpu_torch.core.instrument` (which imports it),
monitors or workflows. Workflows opt in by exposing
``analysis_targets(state)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = [
    "CHIP_CEILINGS",
    "CostAnalyzer",
    "abstract_signature",
    "analysing",
    "analyze_callable",
    "charge",
    "roofline_section",
    "tensor_leaves",
]

# NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity), which
# assume the full 700 W power limit; a card set below it (nvidia-smi's
# power.limit) reaches less, so a fraction of these is a fraction of the
# published peak.
CHIP_CEILINGS: Dict[str, Any] = {
    "mxu_bf16_tflops": 989.0,
    "fp32_tflops": 67.0,
    "hbm_gbps": 3350.0,
    "provenance": (
        "NVIDIA H100 SXM 80 GB HBM3 data sheet at the full 700 W power "
        "limit, dense: 989 TFLOP/s bf16 on the tensor cores "
        "(mxu_bf16_tflops), 67 TFLOP/s float32 outside them (fp32_tflops), "
        "3350 GB/s HBM3; ratios against these are achieved-vs-published, "
        "and a card below 700 W reaches less"
    ),
}

# measured >= factor * ideal: the entry spends most of its time on neither
# FLOPs nor memory traffic; the host's enqueue, host reads and Python
# dominate -> "dispatch-bound"
DISPATCH_BOUND_FACTOR = 4.0

CLASSIFICATIONS = ("compute-bound", "memory-bound", "dispatch-bound")

# dtypes whose FLOPs are held against the tensor-core rate; every other
# dtype (float32, float64, integers, bool) against fp32_tflops
_TENSOR_CORE_DTYPES = ("bfloat16", "float16")


# --------------------------------------------------------------- signatures


def _walk(tree: Any, leaves: List[Any], parts: List[str]) -> None:
    """Leaves in the JAX package's pytree order (state fields in order,
    static fields into the structure, dict keys sorted, ``None`` a node)."""
    if tree is None:
        parts.append("None")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts.append(type(tree).__name__ + "(")
        for f in dataclasses.fields(tree):
            value = getattr(tree, f.name)
            if f.metadata.get("static", False):
                parts.append(f"{f.name}={value!r},")
            else:
                parts.append(f.name + ":")
                _walk(value, leaves, parts)
        parts.append(")")
    elif isinstance(tree, dict):
        parts.append("{")
        for k in sorted(tree):
            parts.append(f"{k!r}:")
            _walk(tree[k], leaves, parts)
        parts.append("}")
    elif isinstance(tree, (list, tuple)):
        parts.append("[" if isinstance(tree, list) else "(")
        for v in tree:
            _walk(v, leaves, parts)
        parts.append("]" if isinstance(tree, list) else ")")
    else:
        parts.append("*")
        leaves.append(tree)


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a state, dict, list or tuple tree; a resident leaf
    (``ShardedTensor``) gives its blocks."""
    from .distributed import ShardedTensor

    leaves: List[Any] = []
    _walk(tree, leaves, [])
    out: List[torch.Tensor] = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, ShardedTensor):
            out.extend(x.blocks)
    return out


def _positioned(tree: Any, outside: int) -> List[Tuple[torch.Tensor, int]]:
    """``[(tensor, position)]`` of a tree: a resident leaf's blocks at their
    positions, every other tensor at ``outside``."""
    from .distributed import ShardedTensor

    leaves: List[Any] = []
    _walk(tree, leaves, [])
    out: List[Tuple[torch.Tensor, int]] = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            out.append((x, outside))
        elif isinstance(x, ShardedTensor):
            out.extend(zip(x.blocks, x.positions))
    return out


def _outside_position(tree: Any) -> int:
    """Where work outside any per-shard function counts: the first position
    of the resident leaves in ``tree`` that this process holds (its
    controller), else 0."""
    from .distributed import ShardedTensor

    leaves: List[Any] = []
    _walk(tree, leaves, [])
    return min((p for x in leaves if isinstance(x, ShardedTensor) for p in x.positions),
               default=0)


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_sig(leaf: Any) -> str:
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return f"{_dtype_name(leaf.dtype)}[{','.join(map(str, leaf.shape))}]"
    # a Python number is its type, never its value: run(state, 100) and
    # run(state, 200) have one signature, as JAX's weak-typed scalars do
    return type(leaf).__name__


def abstract_signature(args: tuple, kwargs: Optional[dict] = None) -> Tuple[str, str]:
    """``(leaf_sig, static_sig)`` of a call's arguments.

    ``leaf_sig`` lists the tensor leaves' dtypes and shapes (Python
    numbers collapse to their type). Eager PyTorch compiles nothing, but a
    new ``leaf_sig`` for an entry already called is the change the JAX
    package flags as a retrace, and is flagged the same way. ``static_sig``
    hashes the structure with the static fields' values: it also changes
    on designed changes (``first_step`` flipping after the first
    generation), so the two are reported apart and only ``leaf_sig``
    changes flag."""
    leaves: List[Any] = []
    parts: List[str] = []
    _walk((tuple(args), kwargs or {}), leaves, parts)
    leaf_sig = ";".join(_leaf_sig(x) for x in leaves)
    static_sig = hashlib.sha1(("".join(parts) + "|" + leaf_sig).encode()).hexdigest()[:16]
    return leaf_sig, static_sig


# ----------------------------------------------------------------- counting

_ACTIVE: List["_OpCounter"] = []  # the counters of analyses in progress, innermost last

_ALLOCATIONS = frozenset(
    getattr(torch.ops.aten, name)
    for name in ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                 "lift_fresh", "detach", "alias")
)


def analysing() -> bool:
    """True while :func:`analyze_callable` runs an entry: monitors that
    record on the host (``PopMonitor``, ``StepTimerMonitor``) skip that
    run, so an analysis leaves no trace in them."""
    return bool(_ACTIVE)


def charge(name: str, flops: float, nbytes: float, dtype: str = "float32",
           launches: int = 1) -> None:
    """Charge a hand kernel's ``launches`` to the analysis in progress
    (none: nothing happens). The kernel wrappers call it where they launch,
    with the work ``chip_smoke.py``'s bound column counts."""
    if _ACTIVE:
        _ACTIVE[-1].add(flops, nbytes, dtype, kernel=name, launches=launches)


class _OpCounter(TorchDispatchMode):
    """FLOPs and bytes of every aten operator dispatched inside it, the
    shapes of their outputs, and each mesh position's live and peak bytes
    (module docstring): a storage counts at the position whose per-shard
    function made it (``outside`` when none runs) from its first output
    until a weak reference sees it freed."""

    def __init__(self, outside: int = 0) -> None:
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, dict] = {}
        self.outside = outside
        self.live: Dict[int, int] = {}
        self.peak: Dict[int, int] = {}
        self.output_shapes: Dict[Tuple[int, ...], int] = {}
        self._storages: Dict[tuple, tuple] = {}

    def hold(self, t: torch.Tensor, position: int) -> None:
        """Count ``t``'s storage at ``position`` until it is freed (once: a
        storage already held stays where it was first counted)."""
        storage = t.untyped_storage()
        nbytes = storage.nbytes()
        key = (t.device.type, t.device.index, storage.data_ptr())
        if nbytes == 0 or key in self._storages:
            return

        def freed(_ref: Any, key: tuple = key) -> None:
            entry = self._storages.pop(key, None)
            if entry is not None:
                self.live[entry[1]] -= entry[2]

        self._storages[key] = (weakref.ref(storage, freed), position, nbytes)
        live = self.live.get(position, 0) + nbytes
        self.live[position] = live
        if live > self.peak.get(position, 0):
            self.peak[position] = live

    def add(self, flops: float, nbytes: float, dtype: str, kernel: Optional[str] = None,
            launches: int = 1) -> None:
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + float(flops)
        self.bytes += float(nbytes)
        if kernel is not None:
            k = self.kernels.setdefault(kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += launches
            k["flops"] += float(flops)
            k["bytes"] += float(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from .distributed import current_position

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out
        outs = tensor_leaves(out)
        position = current_position()
        for t in outs:
            self.hold(t, self.outside if position is None else position)
            shape = tuple(t.shape)
            self.output_shapes[shape] = self.output_shapes.get(shape, 0) + 1
        if func.overloadpacket in _ALLOCATIONS:
            return out
        ins = tensor_leaves((args, kwargs))
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            flops = sum(t.numel() for t in outs)
        typed = [t for t in outs + ins if t.is_floating_point()] or outs + ins
        dtype = _dtype_name(typed[0].dtype) if typed else "float32"
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        self.ops += 1
        self.add(flops, nbytes, dtype)
        return out


def _bytes_of(tree: Any) -> int:
    seen, total = set(), 0
    for t in tensor_leaves(tree):
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def analyze_callable(fn: Callable, *args: Any, **kwargs: Any) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the operator counter and
    return its static cost: ``{"flops", "bytes_accessed", "flops_by_dtype",
    "ops", "kernels", "memory", "signature"}``, or ``{"error": ...}`` when
    the call raises (an analysis never sinks the run it describes). What
    ``fn`` returns is thrown away; ``fn`` must not change its arguments in
    place (the port's entry points never do). ``memory`` holds the
    argument and output bytes, each mesh position's peak of live bytes
    (``per_position_peak_bytes``) and the largest (``peak_bytes_estimate``);
    ``output_shapes`` counts the operators' outputs by shape, and
    ``gathers`` the resident leaves gathered (``ShardedTensor.gather``)."""
    from .distributed import gather_counts

    outside = _outside_position((args, kwargs))
    counter = _OpCounter(outside)
    for t, position in _positioned((args, kwargs), outside):
        counter.hold(t, position)
    gathers = gather_counts()["calls"]
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    except Exception as e:  # an analysis never sinks the run it describes
        return {"error": f"{type(e).__name__}: {e}"}
    finally:
        _ACTIVE.remove(counter)
    flops = sum(counter.flops_by_dtype.values())
    peaks = {str(p): int(v) for p, v in sorted(counter.peak.items())}
    return {
        "flops": float(flops),
        "bytes_accessed": float(counter.bytes),
        "flops_by_dtype": {k: float(v) for k, v in sorted(counter.flops_by_dtype.items())},
        "ops": counter.ops,
        "kernels": counter.kernels,
        "memory": {"argument_bytes": _bytes_of((args, kwargs)), "output_bytes": _bytes_of(out),
                   "peak_bytes_estimate": max(peaks.values(), default=0),
                   "per_position_peak_bytes": peaks},
        "output_shapes": {"x".join(map(str, k)): v for k, v in counter.output_shapes.items()},
        "gathers": gather_counts()["calls"] - gathers,
        "signature": abstract_signature(args, kwargs)[0],
    }


class CostAnalyzer:
    """Per-entry-point analysis cache: one counted run per ``(entry,
    leaf_signature)``, so :func:`~evox_tpu_torch.core.instrument.run_report`
    can call :meth:`analyze_workflow` on every report without running an
    entry again."""

    def __init__(self, ceilings: Optional[dict] = None):
        self.ceilings = dict(ceilings if ceilings is not None else CHIP_CEILINGS)
        self.analyses: Dict[str, dict] = {}
        self._cache: Dict[Tuple[str, str], dict] = {}

    def analyze(self, name: str, fn: Callable, *args: Any, **kwargs: Any) -> dict:
        key = (name, abstract_signature(args, kwargs)[0])
        if key not in self._cache:
            self._cache[key] = analyze_callable(fn, *args, **kwargs)
        self.analyses[name] = self._cache[key]
        return self.analyses[name]

    def analyze_workflow(self, workflow: Any, state: Any) -> Dict[str, dict]:
        """Analyse every entry point the workflow advertises through
        ``analysis_targets(state)`` (workflows without it contribute
        nothing): ``{name: (callable, example_args)}``, the code the entry
        point runs, unwrapped by any recorder."""
        targets = getattr(workflow, "analysis_targets", None)
        if targets is None:
            return {}
        # what preparing the targets runs (a host problem's pipeline_ask
        # for the tell's ctx) is counted nowhere, and host-recording
        # monitors skip it as they skip the analyses
        scratch = _OpCounter()
        _ACTIVE.append(scratch)
        try:
            prepared = targets(state)
        finally:
            _ACTIVE.remove(scratch)
        for name, (fn, args) in prepared.items():
            self.analyze(name, fn, *args)
        return self.analyses


# ----------------------------------------------------------------- roofline


def _ideal_compute_s(analysis: dict, ceilings: dict) -> float:
    """FLOPs over the card's rate for their dtype: float32 and integer work
    at ``fp32_tflops``, bf16 and fp16 at ``mxu_bf16_tflops``. An analysis
    without a dtype split (or ceilings without ``fp32_tflops``) is held
    against ``mxu_bf16_tflops`` alone, the JAX package's rule."""
    tensor_core = float(ceilings["mxu_bf16_tflops"]) * 1e12
    by_dtype = analysis.get("flops_by_dtype")
    if not by_dtype or "fp32_tflops" not in ceilings:
        return (analysis.get("flops") or 0.0) / tensor_core
    fp32 = float(ceilings["fp32_tflops"]) * 1e12
    return sum(f / (tensor_core if d in _TENSOR_CORE_DTYPES else fp32)
               for d, f in by_dtype.items())


def roofline_section(
    analyses: Dict[str, dict],
    dispatch_summary: Optional[dict] = None,
    ceilings: Optional[dict] = None,
    dispatch_bound_factor: float = DISPATCH_BOUND_FACTOR,
) -> dict:
    """Merge the static analyses with the measured seconds a work unit into
    the ``roofline`` section of ``run_report()``.

    Per entry: the static FLOPs and bytes, the measured seconds a unit
    (the differenced slope when the recorder saw two trip counts, else the
    steady median, flagged ``latency_confounded``), achieved TF/s and GB/s,
    their fractions of the ceilings, and a classification:

    - ``dispatch-bound``: the measured time exceeds
      ``dispatch_bound_factor`` times the roofline's ideal time;
    - ``compute-bound`` / ``memory-bound``: whichever of the FLOP and the
      memory ideal times is larger, when the measurement is near the
      roofline.

    Entries with an analysis error or no timing keep their static half and
    classify ``None``: the report never invents a rate.
    """
    ceilings = dict(ceilings if ceilings is not None else CHIP_CEILINGS)
    peak_bytes = float(ceilings["hbm_gbps"]) * 1e9
    entry_stats = (dispatch_summary or {}).get("entry_points", {})
    entries: Dict[str, dict] = {}
    for name, analysis in sorted(analyses.items()):
        # the shapes stay with the analysis (the gather-free check reads
        # them); the report carries the rest
        static = {k: v for k, v in analysis.items() if k != "output_shapes"}
        entry: dict = {"static": static, "classification": None}
        if "error" in analysis:
            entries[name] = entry
            continue
        per_work = (entry_stats.get(name) or {}).get("per_work_s") or {}
        t = per_work.get("seconds")
        flops = analysis.get("flops")
        nbytes = analysis.get("bytes_accessed")
        if not t or t <= 0:
            entries[name] = entry
            continue
        if flops is None and nbytes is None:
            # no static evidence at all: keep the measurement, no verdict
            entry.update(
                measured_s_per_unit=t,
                timing_method=per_work.get("method"),
                latency_confounded=bool(per_work.get("latency_confounded")),
            )
            entries[name] = entry
            continue
        ideal_compute_s = _ideal_compute_s(analysis, ceilings)
        ideal_memory_s = (nbytes or 0.0) / peak_bytes
        ideal_s = max(ideal_compute_s, ideal_memory_s)
        if ideal_s <= 0 or t > dispatch_bound_factor * ideal_s:
            classification = "dispatch-bound"
        elif ideal_compute_s >= ideal_memory_s:
            classification = "compute-bound"
        else:
            classification = "memory-bound"
        entry.update(
            measured_s_per_unit=t,
            timing_method=per_work.get("method"),
            latency_confounded=bool(per_work.get("latency_confounded")),
            achieved_tflops=round(flops / t / 1e12, 6) if flops is not None else None,
            achieved_gbps=round(nbytes / t / 1e9, 6) if nbytes is not None else None,
            frac_peak_compute=round(ideal_compute_s / t, 6) if flops is not None else None,
            frac_peak_bandwidth=round(nbytes / t / peak_bytes, 6) if nbytes is not None else None,
            ideal_s=round(ideal_s, 9),
            dispatch_overhead_frac=round(max(0.0, 1.0 - ideal_s / t), 6),
            classification=classification,
        )
        entries[name] = entry
    return {
        "ceilings": ceilings,
        "dispatch_bound_factor": dispatch_bound_factor,
        "entries": entries,
    }
