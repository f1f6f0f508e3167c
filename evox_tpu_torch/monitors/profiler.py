"""Profiling hooks — the port of ``evox_tpu/monitors/profiler.py``.

- :class:`StepTimerMonitor`: the duration of every generation. On the card
  it records a CUDA event in ``pre_step`` and another in ``post_step`` on
  the current stream, so a duration is the card's time from the start of
  the generation's work to its end (the JAX package's ordered host
  callbacks fire when the device reaches them; a host clock in eager
  PyTorch would time the enqueue). No generation waits: the events are
  read at :meth:`StepTimerMonitor.flush`, which the getters call. On the
  CPU it reads the host's clock.
- :func:`trace`: ``torch.profiler`` around a region, written as a Chrome
  trace into a directory: ``with trace(dir): state = wf.run(state, 100)``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List

import numpy as np
import torch

from ..core.cost import analysing
from ..core.device import DeviceLike, resolve_device
from ..core.monitor import Monitor


class StepTimerMonitor(Monitor):
    """Records the duration of every generation (seconds).

    Args:
        device: the workflow's device; ``None`` means ``"cuda"``. On
            ``cuda`` a generation is timed by CUDA events on the device's
            current stream, on ``cpu`` by ``time.perf_counter``.

    The cost analysis's extra run of an entry (``core/cost.py``) is not
    timed.
    """

    # it reads the host each generation: a fleet (VectorizedWorkflow) refuses it
    uses_host_callbacks = True

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.start_times: List[Any] = []  # CUDA events, or host seconds
        self.end_times: List[Any] = []
        self._seconds: List[float] = []  # durations read so far

    def hooks(self):
        return ("pre_step", "post_step")

    def _mark(self) -> Any:
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def pre_step(self, mstate: Any) -> Any:
        if not analysing():
            self.start_times.append(self._mark())
        return mstate

    def post_step(self, mstate: Any, wf_state: Any) -> Any:
        if not analysing():
            self.end_times.append(self._mark())
        return mstate

    def flush(self) -> None:
        """Read the durations of the generations that have ended (on the
        card: wait for the last recorded event)."""
        n = min(len(self.start_times), len(self.end_times))
        pairs = list(zip(self.start_times[:n], self.end_times[:n]))
        del self.start_times[:n], self.end_times[:n]
        if self.device.type == "cuda" and pairs:
            pairs[-1][1].synchronize()
            self._seconds += [a.elapsed_time(b) / 1e3 for a, b in pairs]
        else:
            self._seconds += [b - a for a, b in pairs]

    def get_step_times(self) -> np.ndarray:
        """``(n_generations,)`` seconds a generation."""
        self.flush()
        return np.asarray(self._seconds, dtype=np.float64)

    def summary(self) -> dict:
        t = self.get_step_times()
        if t.size == 0:
            return {"steps": 0}
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p99_s": float(np.percentile(t, 99)),
            "total_s": float(t.sum()),
        }


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[Any]:
    """Profile the region with ``torch.profiler`` (host operators, and the
    card's kernels when CUDA is present) and write it as a Chrome trace
    (``trace_<pid>_<ms>.json``) into ``log_dir``; yields the profiler.
    Open the file in Perfetto or chrome://tracing.

    ``create_perfetto_link=True`` raises ``ValueError``: the JAX package
    serves the trace to Perfetto's web UI through a local server and a
    link, which needs a network; open the written file by hand instead.
    """
    if create_perfetto_link:
        raise ValueError(
            "trace(create_perfetto_link=True) needs a network and a server for "
            "Perfetto's web UI; open the written trace file by hand instead"
        )
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
