"""The serving cache: warm entries in memory, a durable manifest on disk —
the port of ``evox_tpu/core/exec_cache.py``.

The JAX package AOT-compiles each serving entry point once per key and
serializes the executable, so a cold process deserializes instead of
recompiling. Eager PyTorch has no executable to serialize, and capturing a
fleet's ``run`` as a CUDA graph waits for ROADMAP A3 (the per-generation
seed splits run on the host and each draw builds a ``torch.Generator``).
So the port's :class:`ExecutableCache` keeps the JAX API and key anatomy
and holds this instead:

- **A manifest entry per key**, written to ``directory``: the entry's
  label, bucket and abstract signature (the payload file), and the
  provenance (the manifest file): the card's name and compute capability,
  the torch and CUDA versions and a digest of the ``csrc/`` kernel
  sources (:func:`topology_fingerprint`), the payload's size and SHA-256,
  and the warm-up's seconds. Each file is written tmp + fsync + atomic
  rename + directory fsync, the manifest last: it is the commit record.
- **A warm mark in memory** once the entry has been dispatched at its
  exact shapes on a throwaway state. That dispatch puts the caching
  allocator's blocks, the lazily loaded CUDA modules (the port's kernels,
  cuBLAS, cuRAND) and the library handles in place, so the first real
  dispatch at those shapes pays none of it.

:meth:`ExecutableCache.get_or_compile` returns the eager callable and
records the entry: a memory hit is free; a key the manifest lists (a
*disk hit*, e.g. in a cold process) and a key it does not (a *miss*) are
both warmed by one dispatch. What the manifest buys a cold process is the
list of what to warm before it serves
(:meth:`~evox_tpu_torch.workflows.elastic.ElasticServer.prewarm`), so a
first request into a listed bucket does not pay the warm-up on its own
path. The manifest moves the warm-up off the request's path; it does not
remove it: a disk hit pays the same warm-up dispatch as a miss. A manifest
written under another topology raises :class:`ExecCacheError`; a torn or
corrupt entry is skipped with a warning and warmed again; ``strict=True``
or :meth:`~ExecutableCache.freeze` turns an unplanned miss into
:class:`ExecCacheMissError`, a subclass of the port's ``RetraceError``.
``report()`` keeps the JAX counters: ``compile_s_paid`` is the seconds of
every warm-up dispatch, a disk hit's included; ``compile_s_saved`` is
always 0, since a disk hit saves no warm-up; ``load_s`` is the manifest
reads.

What the cache does **not** do: it stores no compiled code (nothing is
compiled: the port's CUDA kernels are built once per checkout into
``_build/`` by ``kernels/_build.py``), it makes no dispatch cheaper than
the eager dispatch it warmed, and it cannot detect a dispatch at shapes
it never saw except where a caller routes that dispatch through
``get_or_compile`` (the elastic layer routes each admission's solo peel
and each chunk's ``run``).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .cost import abstract_signature
from .instrument import RetraceError

__all__ = ["ExecCacheError", "ExecCacheMissError", "ExecutableCache", "topology_fingerprint"]

_SCHEMA = "evox_tpu_torch.exec_cache/v1"
_CSRC = Path(__file__).resolve().parent.parent / "csrc"


class ExecCacheError(RuntimeError):
    """A manifest entry exists for the requested key but was written under
    another topology (card, compute capability, torch or CUDA version,
    kernel sources) or carries another key: refused loudly, never warmed
    over silently. Delete the entry and warm again on this topology."""


class ExecCacheMissError(RetraceError):
    """A frozen or strict cache was asked for an entry it has not warmed:
    a warm-up is about to land on the serving path. Raised instead of
    warming; warm the entry explicitly (``planned=True``) or drop
    ``strict``."""


@functools.lru_cache(maxsize=1)
def _csrc_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*")):
        if path.is_file():
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def topology_fingerprint(device: Any = None, mesh: Any = None) -> Dict[str, Any]:
    """What a warm entry is valid on: the device's name and compute
    capability, the torch and CUDA versions, the kernel sources' digest,
    and a mesh's axes and shape. Recorded in every manifest and checked,
    not keyed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        capability = ".".join(map(str, torch.cuda.get_device_capability(index)))
    else:
        name, capability = dev.type, None
    fp: Dict[str, Any] = {"device": name, "capability": capability, "torch": torch.__version__,
                          "cuda": torch.version.cuda, "csrc": _csrc_digest()}
    if mesh is not None:
        fp["mesh_axes"] = list(mesh.axis_names)
        fp["mesh_shape"] = [int(mesh.shape[a]) for a in mesh.axis_names]
    return fp


def _fsync_path(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: Path, payload: bytes) -> None:
    """tmp + fsync + atomic rename + directory fsync."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(path.parent)


def _synchronize(device: Any) -> None:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ExecutableCache:
    """Warm serving entries, keyed as the JAX package keys its executables.

    Args:
        directory: the manifest store (created if missing). ``None`` keeps
            the cache in memory: a cold process then knows nothing to
            pre-warm.
        strict: promote any unplanned miss to :class:`ExecCacheMissError`
            (usually set by :meth:`freeze` after the buckets are warm).
        max_entries: warm marks kept (least recently used dropped first,
            preferring entries the manifest lists); ``None`` keeps all.

    Counters (``report()["counters"]``): ``hits`` (warm in memory),
    ``disk_hits`` (listed by the manifest, warmed), ``misses`` (warmed and
    written), ``saves``, ``evictions``.
    """

    def __init__(self, directory: Optional[str] = None, strict: bool = False,
                 max_entries: Optional[int] = None):
        self.directory = Path(directory) if directory is not None else None
        if self.directory is not None:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.strict = strict
        self.max_entries = max_entries
        self._warm: Dict[str, Callable] = {}  # key -> the warmed callable (insertion = LRU)
        self._on_disk: set = set()
        self.counters = {"hits": 0, "disk_hits": 0, "misses": 0, "saves": 0, "evictions": 0}
        self.compile_s_paid = 0.0  # every warm-up dispatch's seconds, disk hits' too
        self.load_s = 0.0  # manifest reads
        self.bytes_written = 0
        self.bytes_read = 0
        self.entries: List[dict] = []
        # a FlightRecorder (a RunQueue threads its own) mirroring hits,
        # misses and warm-up ms into the metrics plane
        self.metrics: Any = None

    def close(self) -> None:
        """Drop the warm marks (the manifest and the counters stay)."""
        self._warm.clear()

    # -------------------------------------------------------------- keying
    @staticmethod
    def cache_key(label: str, config_fingerprint: str, args: tuple,
                  kwargs: Optional[dict] = None, bucket: Optional[Tuple[int, ...]] = None,
                  mesh: Any = None) -> str:
        """sha256 over the label, the caller's static-config fingerprint,
        the abstract argument signature, the bucket and the mesh's axes and
        shape. The topology is checked, not keyed."""
        aval, static = abstract_signature(args, kwargs or {})
        parts = [label, config_fingerprint, aval, static]
        if bucket is not None:
            parts.append("bucket:" + ",".join(str(int(b)) for b in bucket))
        if mesh is not None:
            parts.append("mesh:" + ",".join(f"{a}={int(mesh.shape[a])}" for a in mesh.axis_names))
        return hashlib.sha256("|".join(parts).encode()).hexdigest()

    # ------------------------------------------------------------ manifest
    def _paths(self, key: str) -> Tuple[Path, Path]:
        return self.directory / f"{key}.exec", self.directory / f"{key}.manifest.json"

    def _mark_warm(self, key: str, fn: Callable) -> None:
        self._warm[key] = fn
        if self.max_entries is not None:
            while len(self._warm) > self.max_entries:
                victim = next((k for k in self._warm if k in self._on_disk), next(iter(self._warm)))
                del self._warm[victim]
                self.counters["evictions"] += 1

    def _load_disk(self, key: str, device: Any, mesh: Any) -> Optional[dict]:
        """The manifest of ``key``: ``None`` when there is none or the entry
        is torn or corrupt (warned; warmed again), :class:`ExecCacheError`
        when it is intact but written under another topology or key."""
        exec_path, man_path = self._paths(key)
        if not man_path.exists():
            return None
        t0 = time.perf_counter()
        try:
            manifest = json.loads(man_path.read_text())
            payload = exec_path.read_bytes()
            if len(payload) != manifest["bytes"]:
                raise ValueError(f"size mismatch: {len(payload)} != {manifest['bytes']}")
            if hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
                raise ValueError("sha256 mismatch")
            json.loads(payload)
        except Exception as e:
            warnings.warn(f"skipping corrupt serving-cache entry {key[:12]}…: {e}", stacklevel=3)
            return None
        finally:
            self.load_s += time.perf_counter() - t0
        if manifest.get("key") != key:
            raise ExecCacheError(
                f"serving-cache entry {key[:12]}… carries manifest key "
                f"{str(manifest.get('key'))[:12]}…: the store was rewritten or copied "
                "inconsistently; delete the entry and warm again")
        recorded = manifest.get("topology") or {}
        current = topology_fingerprint(device, mesh)
        mismatched = {k: (recorded.get(k), current[k]) for k in current
                      if recorded.get(k) != current[k]}
        if mismatched:
            raise ExecCacheError(
                f"serving-cache entry {key[:12]}… was written under another topology "
                f"({mismatched}): delete the stale entry and warm the store again on this "
                "topology")
        self.bytes_read += len(payload)
        self._on_disk.add(key)
        return manifest

    def _save_disk(self, key: str, label: str, signature: Tuple[str, str],
                   bucket: Optional[Tuple[int, ...]], device: Any, mesh: Any,
                   compile_s: float) -> int:
        payload = json.dumps({"key": key, "label": label,
                              "bucket": list(bucket) if bucket is not None else None,
                              "signature": list(signature)}).encode()
        exec_path, man_path = self._paths(key)
        _write_durable(exec_path, payload)
        manifest = {"schema": _SCHEMA, "key": key, "label": label,
                    "bucket": list(bucket) if bucket is not None else None,
                    "bytes": len(payload), "sha256": hashlib.sha256(payload).hexdigest(),
                    "topology": topology_fingerprint(device, mesh),
                    "compile_s": round(compile_s, 6), "created": round(time.time(), 3)}
        # the manifest last: it is the commit record
        _write_durable(man_path, json.dumps(manifest).encode())
        self.counters["saves"] += 1
        self._on_disk.add(key)
        self.bytes_written += len(payload)
        return len(payload)

    def listed(self) -> List[dict]:
        """The manifest's entries (label, bucket, key) in key order, torn or
        unreadable ones left out: what a cold process pre-warms."""
        if self.directory is None:
            return []
        out = []
        for path in sorted(self.directory.glob("*.manifest.json")):
            try:
                m = json.loads(path.read_text())
                out.append({"key": m["key"], "label": m["label"], "bucket": m.get("bucket")})
            except Exception:
                continue
        return out

    # ----------------------------------------------------------------- get
    def _warm_up(self, fn: Callable, args: tuple, kwargs: dict, device: Any) -> float:
        """One dispatch at the entry's exact shapes (on a throwaway state),
        synchronized; its seconds."""
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _synchronize(device)
        return time.perf_counter() - t0

    def get_or_compile(self, label: str, config_fingerprint: str, fn: Callable, args: tuple,
                       kwargs: Optional[dict] = None, bucket: Optional[Tuple[int, ...]] = None,
                       mesh: Any = None, planned: bool = False, device: Any = None) -> Callable:
        """The one lookup: warm in memory, listed by the manifest (warmed
        now), or a miss (warmed and written). ``args`` are throwaway
        arguments at the entry's exact shapes: they are dispatched once and
        dropped. ``planned=True`` marks a warm-up that must not trip the
        strict-miss alarm. Returns ``fn``."""
        kwargs = kwargs or {}
        key = self.cache_key(label, config_fingerprint, args, kwargs, bucket, mesh)
        if key in self._warm:
            self._warm[key] = self._warm.pop(key)  # LRU position
            self.counters["hits"] += 1
            if self.metrics is not None:
                self.metrics.count("exec_cache.hits")
            return fn
        manifest = self._load_disk(key, device, mesh) if self.directory is not None else None
        if manifest is None and self.strict and not planned:
            raise ExecCacheMissError(
                f"serving-cache miss for entry {label!r} (key {key[:12]}…) on a frozen cache: "
                "an unplanned warm-up was about to land on the serving path. Warm the bucket "
                "explicitly (planned=True) or drop strict.")
        seconds = self._warm_up(fn, args, kwargs, device)
        self.compile_s_paid += seconds
        entry = {"key": key[:16], "label": label,
                 "bucket": list(bucket) if bucket is not None else None}
        if manifest is not None:
            self.counters["disk_hits"] += 1
            if self.metrics is not None:
                self.metrics.count("exec_cache.disk_hits")
            self._note_entry({**entry, "source": "disk", "bytes": int(manifest["bytes"]),
                              "warm_s": round(seconds, 6)})
        else:
            self.counters["misses"] += 1
            if self.metrics is not None:
                self.metrics.count("exec_cache.misses")
                self.metrics.observe("exec_cache.compile_ms", seconds * 1e3)
            nbytes = None
            if self.directory is not None:
                nbytes = self._save_disk(key, label, abstract_signature(args, kwargs), bucket,
                                         device, mesh, seconds)
            self._note_entry({**entry, "source": "compiled", "bytes": nbytes,
                              "compile_s": round(seconds, 6)})
        self._mark_warm(key, fn)
        return fn

    def is_warm(self, label: str, config_fingerprint: str, args: tuple,
                kwargs: Optional[dict] = None, bucket: Optional[Tuple[int, ...]] = None,
                mesh: Any = None) -> bool:
        """Whether the entry at these arguments' shapes is warm in memory."""
        return self.cache_key(label, config_fingerprint, args, kwargs, bucket, mesh) in self._warm

    def _note_entry(self, entry: dict) -> None:
        """Per-key provenance; repeat events for one (key, source) count in
        the existing record's ``repeats``, so the list stays bounded."""
        for e in self.entries:
            if e["key"] == entry["key"] and e["source"] == entry["source"]:
                e["repeats"] = int(e.get("repeats", 1)) + 1
                return
        self.entries.append(entry)

    def freeze(self) -> "ExecutableCache":
        """Arm the miss alarm: any later unplanned miss raises
        :class:`ExecCacheMissError`."""
        self.strict = True
        return self

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """``run_report``'s ``serving.cache`` section (the JAX schema:
        every miss is one warm-up, every disk hit one listed entry)."""
        return {
            "directory": str(self.directory) if self.directory else None,
            "strict": bool(self.strict),
            "counters": dict(self.counters),
            "compile_s_paid": round(self.compile_s_paid, 6),
            "compile_s_saved": 0.0,  # a disk hit pays its warm-up: nothing is saved
            "load_s": round(self.load_s, 6),
            "bytes_written": int(self.bytes_written),
            "bytes_read": int(self.bytes_read),
            "entries": list(self.entries),
        }
