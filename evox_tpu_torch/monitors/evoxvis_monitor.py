"""EvoXVisMonitor — generations streamed to Apache Arrow IPC files for the
EvoXVis GUI; the port of ``evox_tpu/monitors/evoxvis_monitor.py``, with the
same wire format.

One record batch every ``batch_size`` generations, columns ``generation``
(uint64), ``fitness`` (variable-width binary of the raw array bytes), an
optional ``population`` (the first leaf of the candidates, its raw bytes)
and an optional ``duration`` (float64 seconds since the first record); the
schema metadata holds ``population_size``, ``fitness_dtype``,
``population_dtype`` and ``begin_time``, taken at the first write.

The JAX package ships each generation out of the compiled step with an
ordered ``io_callback``. Here the ``post_eval`` hook queues non-blocking
copies of the two arrays into pinned host buffers, records one CUDA event
after them, and returns without waiting. A batch is turned into Arrow
columns and written once every event of its rows has completed (checked
without blocking at each hook), or at :meth:`flush`/:meth:`close`, which
wait. Each row takes fresh pinned buffers (PyTorch's host allocator
caches freed pinned blocks, so a buffer of a written batch is handed out
again without a new ``cudaHostAlloc``), and the queue holds at most
``2 * batch_size`` rows before the hook waits for the oldest batch, so the
pinned memory stays bounded by the batch size. On the CPU the arrays are
copied into plain buffers.

A bf16 array is written as its raw two-byte words under the dtype name
``"bfloat16"``, the name the JAX package writes through ml_dtypes; a dtype
numpy cannot name otherwise is refused.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from pathlib import Path
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from ..core.cost import analysing
from ..core.monitor import Monitor
from ..utils.common import tree_flatten


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy dtype name the JAX package writes for this dtype."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    try:
        return str(torch.empty((), dtype=dtype).numpy().dtype)
    except TypeError as e:
        raise TypeError(f"EvoXVisMonitor cannot write {dtype}: numpy has no such dtype") from e


def _byte_view(buf: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous host tensor as a flat uint8 array."""
    flat = buf.reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return flat.numpy().view(np.uint8)


class _Row:
    """One generation's queued copies."""

    __slots__ = ("generation", "population", "fitness", "event", "duration")

    def __init__(self, generation, population, fitness, event, duration):
        self.generation = generation
        self.population = population
        self.fitness = fitness
        self.event = event
        self.duration = duration

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class EvoXVisMonitor(Monitor):
    """Args:
        base_filename: output files are ``<base>_<i>.arrow`` in ``out_dir``
            (``i`` = the first unused index).
        out_dir: defaults to ``./evox_vis``.
        batch_size: generations a record batch.
        record_population: also store the decision-space arrays.
        record_time: store each generation's wall-clock offset.
        compression: ``None``, ``"lz4"`` or ``"zstd"``.

    pyarrow is optional, as in the JAX package: without it the constructor
    raises ``ImportError``. The cost analysis's extra run of an entry
    (``core/cost.py``) records nothing.
    """

    # it reads the host each generation: a fleet (VectorizedWorkflow) refuses it
    uses_host_callbacks = True

    def __init__(
        self,
        base_filename: str = "evox",
        out_dir: Optional[str] = None,
        batch_size: int = 64,
        record_population: bool = False,
        record_time: bool = True,
        compression: Optional[str] = None,
    ):
        import pyarrow as pa

        self.pa = pa
        base = Path(out_dir) if out_dir is not None else Path("evox_vis")
        base.mkdir(parents=True, exist_ok=True)
        i = 0
        while (base / f"{base_filename}_{i}.arrow").exists():
            i += 1
        self.path = base / f"{base_filename}_{i}.arrow"
        self.sink = pa.OSFile(str(self.path), "wb")
        self.batch_size = batch_size
        self.record_population = record_population
        self.record_time_enabled = record_time
        self.compression = compression

        self.schema = None
        self.writer = None
        self.is_closed = False
        self.generation_counter = 0
        self.start_time: Optional[float] = None
        self.ref_time: Optional[float] = None
        self._rows: Deque[_Row] = deque()

    def hooks(self):
        return ("post_eval",)

    # --------------------------------------------------------------- device side
    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        pinned = t.is_cuda
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        buf.copy_(t, non_blocking=pinned)
        return buf

    def post_eval(self, mstate: Any, cand: Any, fitness: torch.Tensor) -> Any:
        if self.is_closed or analysing():
            return mstate  # after close() the workflow may keep stepping: drop quietly
        duration = None
        if self.record_time_enabled:
            if self.start_time is None:
                self.start_time = time.time()
                self.ref_time = time.monotonic()
            duration = time.monotonic() - self.ref_time
        pop = self._copy(tree_flatten(cand)[0][0]) if self.record_population else None
        fit = self._copy(fitness)
        event = None
        if fitness.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(fitness.device))
        self._rows.append(_Row(self.generation_counter, pop, fit, event, duration))
        self.generation_counter += 1
        self._write_ready(wait=len(self._rows) >= 2 * self.batch_size)
        return mstate

    # ----------------------------------------------------------------- host side
    def _write_ready(self, wait: bool) -> None:
        """Write every full batch at the queue's head whose copies have
        completed; with ``wait``, wait for the oldest full batch first."""
        while len(self._rows) >= self.batch_size:
            head = [self._rows[i] for i in range(self.batch_size)]
            if wait:
                head[-1].wait()
                wait = False
            elif not all(r.ready() for r in head):
                return
            self._write(self.batch_size)

    def _binary(self, bufs: List[torch.Tensor]) -> Any:
        """A pyarrow ``binary`` array whose values are the buffers' raw bytes."""
        views = [_byte_view(b) for b in bufs]
        offsets = np.zeros(len(views) + 1, dtype=np.int32)
        np.cumsum([v.size for v in views], out=offsets[1:])
        data = np.concatenate(views) if views else np.zeros(0, np.uint8)
        pa = self.pa
        return pa.Array.from_buffers(pa.binary(), len(views),
                                     [None, pa.py_buffer(offsets), pa.py_buffer(data)])

    def _fixed(self, values: np.ndarray, typ: Any) -> Any:
        """A pyarrow array of a fixed-width type over a numpy array's buffer
        (``pa.array`` would import pandas at its first call: seconds)."""
        return self.pa.Array.from_buffers(typ, len(values), [None, self.pa.py_buffer(values)])

    def _build_schema(self, last: _Row) -> None:
        # variable-width binary, not pa.binary(n): algorithms with an init
        # ask/tell (CSO) evaluate another count in the first generation
        pa = self.pa
        fields = [("generation", pa.uint64()), ("fitness", pa.binary())]
        metadata = {
            "population_size": str(last.fitness.shape[0]),
            "fitness_dtype": _dtype_name(last.fitness.dtype),
        }
        if last.population is not None:
            fields.append(("population", pa.binary()))
            metadata["population_dtype"] = _dtype_name(last.population.dtype)
        if last.duration is not None:
            fields.append(("duration", pa.float64()))
            metadata["begin_time"] = str(self.start_time)
        self.schema = pa.schema(fields, metadata=metadata)
        self.writer = pa.ipc.new_file(
            self.sink, self.schema, options=pa.ipc.IpcWriteOptions(compression=self.compression)
        )

    def _write(self, n: int) -> None:
        """Write the queue's first ``n`` rows (their copies complete) as one
        record batch."""
        rows = [self._rows.popleft() for _ in range(n)]
        if self.schema is None:
            self._build_schema(rows[-1])
        pa = self.pa
        cols = [self._fixed(np.array([r.generation for r in rows], dtype=np.uint64), pa.uint64()),
                self._binary([r.fitness for r in rows])]
        if "population" in self.schema.names:
            cols.append(self._binary([r.population for r in rows]))
        if "duration" in self.schema.names:
            cols.append(self._fixed(np.array([r.duration for r in rows], dtype=np.float64),
                                    pa.float64()))
        self.writer.write_batch(pa.record_batch(cols, schema=self.schema))

    def flush(self) -> None:
        """Wait for every queued copy and write it: full batches, then the
        rest as one batch."""
        for r in self._rows:
            r.wait()
        while self._rows:
            self._write(min(self.batch_size, len(self._rows)))

    def close(self, flush: bool = True) -> None:
        if self.is_closed:
            return
        try:
            if flush:
                self.flush()
        finally:
            # even if the flush raises, write the Arrow footer so the file
            # stays readable, and only then mark the monitor closed
            self.is_closed = True
            self._rows.clear()
            if self.writer is not None:
                self.writer.close()
            self.sink.close()

    def __del__(self):
        try:  # interpreter teardown may have cleared module globals
            if not self.is_closed:
                warnings.warn(
                    "EvoXVisMonitor was garbage-collected without close(); "
                    "trailing generations were not flushed"
                )
                self.close(flush=False)
        except Exception:
            pass
