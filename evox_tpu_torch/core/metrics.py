"""Host-side metrics registry: counters, gauges, histograms — the port of
``evox_tpu/core/metrics.py``.

A small, dependency-free map of named metrics that the executor and the
flight recorder increment at their host boundaries (the Prometheus
trinity):

- :class:`Counter` — monotonically non-decreasing totals (dispatches,
  integrity heals). The stream validator (``tools/check_report.py``)
  enforces the monotonicity across samples.
- :class:`Gauge` — last-write-wins levels (queue depth).
- :class:`Histogram` — fixed-bucket distributions (dispatch
  milliseconds). Buckets are fixed at creation, so two samples of one
  stream stay comparable; re-creating a histogram with other buckets
  raises.

Everything here is host Python on values already on the host: no tensor
is read. The registry knows nothing of files or streams:
:class:`~evox_tpu_torch.workflows.flightrec.FlightRecorder` owns
durability and samples this registry at chunk boundaries, and
``snapshot()`` is the hand-off, a plain strict-JSON dict.

This is ``evox_tpu_torch.core.metrics``, the run's metrics plane; the
top-level ``evox_tpu_torch.metrics`` package (IGD and hypervolume) is
unrelated.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "METRIC_KINDS",
    "DEFAULT_MS_BUCKETS",
]

#: the closed set of metric kinds a stream may carry; the stream
#: validator rejects anything else (the EVENT_KINDS discipline)
METRIC_KINDS = ("counter", "gauge", "histogram")

#: default latency buckets (milliseconds): sub-ms host work up to
#: multi-second first calls
DEFAULT_MS_BUCKETS = (1.0, 5.0, 20.0, 50.0, 100.0, 250.0, 1000.0, 5000.0)


def _finite(value: Any) -> float:
    v = float(value)
    if not math.isfinite(v):
        raise ValueError(f"metrics are strict-JSON: non-finite value {value!r}")
    return v


class Counter:
    """Monotonically non-decreasing total. ``inc`` rejects negative
    deltas — a counter that can go down is a gauge wearing the wrong
    uniform, and the stream validator's monotonicity law would flag the
    decrease as corruption."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        n = _finite(n)
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc({n})) — use a "
                "gauge for levels"
            )
        self.value += n

    def snapshot(self) -> float:
        # ints stay ints through JSON (counters are almost always counts)
        return int(self.value) if self.value == int(self.value) else self.value


class Gauge:
    """Last-write-wins level (queue depth, live process count)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = _finite(v)

    def snapshot(self) -> float:
        return int(self.value) if self.value == int(self.value) else self.value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: bucket i
    counts observations ``<= le[i]``; a final implicit +Inf bucket is
    ``count``). ``sum``/``count`` ride along so rates and means are
    derivable from any single sample."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        if not buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        le = [float(b) for b in buckets]
        if le != sorted(le) or len(set(le)) != len(le):
            raise ValueError(
                f"histogram {name!r} buckets must be strictly increasing, "
                f"got {buckets}"
            )
        self.name = name
        self.le: Tuple[float, ...] = tuple(le)
        self.counts: List[int] = [0] * len(le)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = _finite(v)
        self.count += 1
        self.sum += v
        for i, bound in enumerate(self.le):
            if v <= bound:
                self.counts[i] += 1

    def snapshot(self) -> Dict[str, Any]:
        return {
            "le": list(self.le),
            "counts": list(self.counts),
            "count": self.count,
            "sum": round(self.sum, 6),
        }


class MetricsRegistry:
    """Thread-safe named-metric registry.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name, buckets)``
    get-or-create (the Prometheus client idiom, so producers never
    coordinate creation); re-creating under a different kind — or a
    histogram under different buckets — raises, because one name must
    mean one thing for the life of a stream. Shorthand mutators
    (:meth:`count` / :meth:`set` / :meth:`observe`) keep producer call
    sites one line.

    Thread safety matters here: the executor's background lanes
    (checkpoint, monitor fetch) and the queue's caller thread all
    produce into one registry.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    # ------------------------------------------------------------ get/create
    def _get(self, name: str, cls, *args) -> Any:
        if not name or not isinstance(name, str):
            raise ValueError(f"metric name must be a non-empty str, got {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        h = self._get(name, Histogram, buckets)
        if h.le != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.le}, requested {tuple(buckets)} — fixed buckets are "
                "what keep two samples of one stream comparable"
            )
        return h

    # ------------------------------------------------------------- shorthand
    def count(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(
        self, name: str, v: float, buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> None:
        self.histogram(name, buckets).observe(v)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0) -> float:
        """Current scalar value of a counter/gauge (0 when absent) —
        producers use this for read-modify checks, tests for asserts."""
        m = self.get(name)
        return default if m is None or isinstance(m, Histogram) else m.snapshot()

    def values(self, prefix: str) -> Dict[str, float]:
        """Every counter/gauge scalar under a dotted-name prefix, e.g.
        ``values("control.")`` -> the multi-pod gateway's own family.
        Histograms are skipped (their snapshot is a dict, not a scalar);
        consumers wanting them take the full :meth:`snapshot`."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {
            m.name: m.snapshot()
            for m in metrics
            if m.name.startswith(prefix) and not isinstance(m, Histogram)
        }

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The registry as one strict-JSON dict, kinds separated so a
        consumer (stream sample, validator) never guesses:
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for m in metrics:
            out[m.kind + "s"][m.name] = m.snapshot()
        return out

    def to_openmetrics(self) -> str:
        """Prometheus/OpenMetrics text exposition of the current state
        (dots in names become underscores — the Prometheus charset).
        Host-side string building only; any scrape endpoint uses this one
        serializer."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, v in sorted(snap["counters"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn}_total {_prom_num(v)}")
        for name, v in sorted(snap["gauges"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_num(v)}")
        for name, h in sorted(snap["histograms"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            for le, c in zip(h["le"], h["counts"]):
                lines.append(f'{pn}_bucket{{le="{_prom_num(le)}"}} {c}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{pn}_sum {_prom_num(h['sum'])}")
            lines.append(f"{pn}_count {h['count']}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name
    ).strip("_")


def _prom_num(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)
