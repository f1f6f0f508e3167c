"""Crash-safe run checkpointing — the port of
``evox_tpu/workflows/checkpoint.py``.

:class:`WorkflowCheckpointer` snapshots a workflow state on the host
between generations. Durability:

- The data file and then its JSON manifest are each written to a tmp
  file, fsynced, renamed over the target with ``os.replace`` and the
  directory fsynced. The manifest is the commit record: a crash at any
  byte leaves a complete snapshot or an ignorable partial one.
- The manifest holds the payload's byte count and SHA-256 and the
  attest digest (``core/attest.py``) of the state it unpickles to.
  :meth:`WorkflowCheckpointer.latest` walks snapshots newest to oldest and
  skips, with a warning, any whose manifest is missing or garbled, whose
  payload fails its size or SHA-256 check, or whose state digests
  differently.
- Each manifest carries the state's structure (every leaf's path, shape
  and dtype, and the algorithm state's type) and its hash: restoring a
  snapshot written under another algorithm, population size, storage
  policy or monitor set raises :class:`CheckpointConfigError` unless
  ``allow_config_mismatch=True``. A leaf that is ``None`` in the
  restoring run's reference state (a monitor's buffers, a guarded
  state's candidate batch: sized at the first step) matches whatever the
  snapshot holds there.

A snapshot is the state with every tensor copied to the host (CPU
tensors: a bfloat16 leaf keeps its dtype and bits);
:func:`restore_layouts` places it on the workflow's device. Every random
draw of the port comes from an integer seed in the state, so a snapshot
carries the draws to come: a run resumed from generation K reproduces
the straight run's final state bit for bit. The manifest records the
saving device, the process count and, for provenance, each leaf's
non-replicated ``field(sharding=...)`` annotation; the snapshot itself is
mesh-free host data (a leaf held resident on a mesh is gathered into it,
``core/state_io.py``), and :func:`restore_layouts` places it on the
restoring workflow's mesh (or by an explicit tree of shardings), so a run
saved on an 8-shard mesh resumes on 4 or on 1, or on a mesh that spans
processes, where each process keeps its own blocks.

In a process group (``core/distributed.py``) every process calls
``save`` (the gathers of resident leaves are collectives), only process 0
writes, and a store barrier holds the others until the manifest, the
commit record, is durable. So a run saved by two processes resumes in one,
and one saved by one resumes in two.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import warnings
from pathlib import Path
from typing import Any, List, Optional

import torch

from ..core.attest import IntegrityError, digest_hex, host_state_digest
from ..core.device import DeviceLike, resolve_device
from ..core.state_io import host_copy
from ..core.struct import map_tensors, named_leaves

_SCHEMA = "evox_tpu_torch.workflow_checkpoint/v1"


def attest_digest_hex(state: Any) -> str:
    """Hex attestation of a host state (``core/attest.py``)."""
    return digest_hex(host_state_digest(state))


class CheckpointConfigError(RuntimeError):
    """A snapshot's config fingerprint does not match the run asking to
    restore it: another algorithm, population size, monitor set or state
    structure. Pass ``allow_config_mismatch=True`` to restore it anyway."""


_LAZY = "None"  # the signature of a leaf not sized yet


def _leaf_signature(leaf: Any) -> str:
    if leaf is None:
        return _LAZY
    shape = tuple(getattr(leaf, "shape", ()))
    dtype = getattr(leaf, "dtype", None)
    dtype = type(leaf).__name__ if dtype is None else str(dtype).removeprefix("torch.")
    return f"{shape}:{dtype}"


def state_config(state: Any) -> dict:
    """The state's structure: the algorithm state's type name and each
    leaf's ``shape:dtype`` by path (``None`` leaves included). The same for
    a state on the card and its host snapshot; static fields (the
    ``first_step`` flag) are left out, since they differ between a fresh
    state and a mid-run one."""
    return {
        "algo": type(getattr(state, "algo", state)).__name__,
        "leaves": {path: _leaf_signature(leaf)
                   for path, leaf in named_leaves(state, keep_none=True)},
    }


def state_config_fingerprint(state: Any) -> str:
    """SHA-256 of :func:`state_config`."""
    return hashlib.sha256(json.dumps(state_config(state), sort_keys=True).encode()).hexdigest()


def _config_matches(recorded: dict, expected: dict) -> bool:
    """Whether a snapshot's structure fits the restoring run's reference:
    the same algorithm state type, and every leaf equal by path, except
    that where the reference holds ``None`` the snapshot may hold anything
    (but must hold the path)."""
    if recorded["algo"] != expected["algo"]:
        return False
    lazy = [p for p, sig in expected["leaves"].items() if sig == _LAZY]

    def under(path: str, p: str) -> bool:
        return path == p or path.startswith((p + ".", p + "["))

    if not all(any(under(path, p) for path in recorded["leaves"]) for p in lazy):
        return False
    rec = {path: sig for path, sig in recorded["leaves"].items()
           if not any(under(path, p) for p in lazy)}
    exp = {path: sig for path, sig in expected["leaves"].items() if sig != _LAZY}
    return rec == exp


def _fsync_path(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: Path, payload: bytes, tmp_suffix: str) -> None:
    """tmp + flush + fsync(file) + atomic rename + fsync(directory): a
    rename alone is atomic against crashes but not durable against power
    loss until the directory entry is synced."""
    tmp = path.with_suffix(tmp_suffix)
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(path.parent)


def _device_name(state: Any) -> str:
    """The name of the device that holds ``state``'s first tensor."""
    for _, leaf in named_leaves(state):
        if isinstance(leaf, torch.Tensor):
            dev = leaf.device
            return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return "cpu"


def restore_layouts(state: Any, device: DeviceLike = None, mesh: Any = None,
                    state_sharding: Any = None) -> Any:
    """A restored host snapshot with every tensor placed on ``device``
    (``None`` means ``"cuda"``), dtypes and bits unchanged; then, with
    ``state_sharding`` (a tree of ``NamedSharding`` over the state's
    leaves), each leaf on its sharding's mesh, else with ``mesh`` each leaf
    where its ``field(sharding=...)`` annotation puts it on that mesh
    (``core/distributed.py``'s ``place_state``)."""
    from ..core.distributed import place_by_sharding, place_state

    dev = resolve_device(device)
    state = map_tensors(lambda t: t.to(dev), state)
    if state_sharding is not None:
        return place_by_sharding(state, state_sharding)
    return place_state(state, mesh)


def leaf_shardings(state: Any) -> dict:
    """``{path: spec}`` of the leaves whose ``field(sharding=...)``
    annotation splits them: the manifest's provenance record."""
    from ..core.distributed import annotation_specs

    specs = dict(_named_specs(annotation_specs(state)))
    return {path: repr(spec) for path, spec in specs.items() if any(a is not None for a in spec)}


def _named_specs(tree: Any, prefix: str = "") -> list:
    import dataclasses

    from ..core.distributed import P

    if isinstance(tree, P):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _named_specs(getattr(tree, f.name), f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_specs(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_specs(v, f"{prefix}[{i}]")]
    return []


def chunk_to_boundary(state: Any, checkpointer: Optional["WorkflowCheckpointer"],
                      chunk: Optional[int] = None) -> int:
    """Generations from ``state.generation`` to the next boundary of the
    checkpoint cadence (or of ``chunk`` without a checkpointer; unbounded
    without either). Boundaries lie on a global grid, so they are the same
    generations across a crash and its resume."""
    every = checkpointer.every if checkpointer is not None else chunk
    if every is None:
        return 1 << 30
    return every - int(state.generation) % every


class WorkflowCheckpointer:
    """Periodic host snapshots of a workflow state.

    Args:
        directory: snapshot directory (created if missing). Snapshots of an
            earlier process there are adopted: that is how a crashed run
            resumes.
        every: cadence in generations. ``wf.run(..., checkpointer=)`` runs
            in chunks that end on multiples of ``every`` and snapshots
            between them; ``run_host_pipelined`` snapshots whenever
            ``state.generation`` reaches a multiple of ``every``. The final
            state is always snapshotted.
        keep: newest snapshots retained (older ones pruned after each save).
    """

    _CONFIG = "checkpointer.json"

    def __init__(self, directory: str, every: int = 10, keep: int = 3,
                 barrier_timeout_s: Optional[float] = None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.keep = keep
        self.barrier_timeout_s = barrier_timeout_s

    def _commit_barrier(self) -> None:
        from ..core.distributed import process_barrier

        if self.barrier_timeout_s is None:
            process_barrier()
        else:
            process_barrier(timeout_s=self.barrier_timeout_s)

    def _write_config(self) -> None:
        """Persist (every, keep) beside the snapshots, so that a resume that
        names only the directory takes the run's cadence."""
        payload = json.dumps({"every": self.every, "keep": self.keep}).encode()
        _write_durable(self.directory / self._CONFIG, payload, ".json.tmp")

    # ------------------------------------------------------------------ save
    def save(self, state: Any) -> Path:
        """Snapshot ``state``: copy it to the host, then :meth:`write`."""
        return self.write(host_copy(state), _device_name(state))

    def write(self, host_state: Any, device_name: str = "cpu") -> Path:
        """Write a host state as ``ckpt_GGGGGGGG.pkl`` and then its
        ``.manifest.json`` (schema, generation, byte count, SHA-256, attest
        digest, config fingerprint, the saving device and the leaves'
        sharding annotations), each durably; then prune to ``keep``. It
        touches no device, so the executor runs it on its background
        checkpoint lane. In a process group only process 0 writes; every
        process meets at a barrier after the manifest is durable."""
        from ..core.distributed import process_count, process_id

        gen = int(host_state.generation)
        path = self.directory / f"ckpt_{gen:08d}.pkl"
        multiproc = process_count() > 1
        if multiproc and process_id() != 0:
            self._commit_barrier()  # wait for the writer's commit
            return path
        payload = pickle.dumps(host_state, protocol=pickle.HIGHEST_PROTOCOL)
        _write_durable(path, payload, ".pkl.tmp")
        manifest = {
            "schema": _SCHEMA,
            "generation": gen,
            "bytes": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
            "file": path.name,
            "attest": {"digest": attest_digest_hex(host_state), "generation": gen},
            "config_sha": state_config_fingerprint(host_state),
            "config": state_config(host_state),
            "save_topology": {"device": device_name, "process_count": process_count(),
                              "leaf_shardings": leaf_shardings(host_state)},
        }
        _write_durable(self._manifest_path(path), json.dumps(manifest).encode(), ".json.tmp")
        self._write_config()
        self._prune()
        if multiproc:
            self._commit_barrier()  # the others go on only after the commit
        return path

    def maybe_save(self, state: Any) -> Optional[Path]:
        """Snapshot iff ``state.generation`` is a multiple of ``every``. It
        always rewrites: a file already there for the generation may be a
        torn leftover or another run's."""
        if int(state.generation) % self.every != 0:
            return None
        return self.save(state)

    # ------------------------------------------------------------------ load
    def snapshots(self) -> List[Path]:
        """Committed snapshot data files (those with a manifest), oldest to
        newest; their contents are checked at restore."""
        tail = len(".manifest.json")
        return sorted(
            p.parent / p.name[:-tail]
            for p in self.directory.glob("ckpt_????????.pkl.manifest.json")
        )

    def latest(self, expect_like: Any = None, allow_config_mismatch: bool = False) -> Optional[Any]:
        """The newest intact snapshot as a host state (``None`` when there
        is none). Torn or corrupt snapshots are skipped with a warning.
        ``expect_like`` (a state of the restoring run) arms the config
        guard: a snapshot with another fingerprint raises
        :class:`CheckpointConfigError`."""
        expected = None if expect_like is None else state_config(expect_like)
        for path in reversed(self.snapshots()):
            got = self._load_validated(path)
            if got is None:
                continue
            manifest, state = got
            self._check_config(manifest, expected, path, allow_config_mismatch)
            return state
        return None

    @staticmethod
    def _check_config(manifest: dict, expected: Optional[dict], path: Path,
                      allow_config_mismatch: bool) -> None:
        recorded = manifest.get("config")
        if (expected is not None and recorded is not None and not allow_config_mismatch
                and recorded["algo"] == "tuple" and expected["algo"] != "tuple"):
            raise CheckpointConfigError(
                f"checkpoint {path.name} holds its member states as a tuple, one state a "
                "member (the layout of the port before its stacked member form); this run "
                f"holds them stacked on a leading member axis ({expected['algo']}). The "
                "snapshot cannot be read as a stacked state: rerun from a fresh state or "
                "restack its members with core.members.stack_states.")
        if (expected is not None and recorded is not None and not allow_config_mismatch
                and not _config_matches(recorded, expected)):
            want = hashlib.sha256(json.dumps(expected, sort_keys=True).encode()).hexdigest()
            raise CheckpointConfigError(
                f"checkpoint {path.name} was written under a different run config "
                f"(snapshot config_sha {manifest['config_sha'][:12]}… != expected {want[:12]}…): "
                "algorithm, population size, or monitor set changed. Rebuild the "
                "matching workflow, point at the right directory, or pass "
                "allow_config_mismatch=True to restore anyway."
            )

    def load(self, generation: int, expect_like: Any = None,
             allow_config_mismatch: bool = False) -> Optional[Any]:
        """The snapshot of one generation, or ``None`` when it is absent,
        uncommitted or torn (the same checks as :meth:`latest`)."""
        path = self.directory / f"ckpt_{int(generation):08d}.pkl"
        if not self._manifest_path(path).exists():
            return None
        got = self._load_validated(path)
        if got is None:
            return None
        manifest, state = got
        expected = None if expect_like is None else state_config(expect_like)
        self._check_config(manifest, expected, path, allow_config_mismatch)
        return state

    def _manifest_path(self, path: Path) -> Path:
        return path.with_suffix(".pkl.manifest.json")

    def _load_validated(self, path: Path) -> Optional[tuple]:
        try:
            with open(self._manifest_path(path)) as f:
                manifest = json.load(f)
            payload = path.read_bytes()
            if len(payload) != manifest["bytes"]:
                raise ValueError(f"size mismatch: {len(payload)} != {manifest['bytes']}")
            if hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
                raise ValueError("sha256 mismatch")
            state = pickle.loads(payload)  # bytes this program wrote, checked above
            att = manifest.get("attest")
            if isinstance(att, dict) and "digest" in att:
                got = attest_digest_hex(state)
                if got != att["digest"]:
                    raise IntegrityError(
                        f"state digest {got} != manifest attestation {att['digest']}",
                        generation=manifest.get("generation"),
                        where=path.name,
                    )
            return manifest, state
        except Exception as e:  # any torn or corrupt snapshot: fall back one
            warnings.warn(f"skipping corrupt checkpoint {path.name}: {e}", stacklevel=2)
            return None

    def _prune(self) -> None:
        snaps = self.snapshots()
        for old in snaps[: max(len(snaps) - self.keep, 0)]:
            for p in (old, self._manifest_path(old)):
                try:
                    p.unlink()
                except FileNotFoundError:
                    pass


def snapshot_dir_intact(directory: Any) -> bool:
    """Does ``directory`` hold at least one committed snapshot whose payload
    matches its manifest's size and SHA-256? File I/O only, nothing is
    unpickled."""
    directory = Path(directory)
    tail = len(".manifest.json")
    for mpath in sorted(directory.glob("ckpt_????????.pkl.manifest.json"), reverse=True):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            payload = (mpath.parent / mpath.name[:-tail]).read_bytes()
        except (OSError, ValueError):
            continue
        if (len(payload) == manifest.get("bytes")
                and hashlib.sha256(payload).hexdigest() == manifest.get("sha256")):
            return True
    return False


def _as_checkpointer(resume_from: Any) -> WorkflowCheckpointer:
    if isinstance(resume_from, WorkflowCheckpointer):
        return resume_from
    # a directory: take the crashed run's persisted cadence
    kw = {}
    try:
        with open(Path(resume_from) / WorkflowCheckpointer._CONFIG) as f:
            cfg = json.load(f)
        kw = {"every": int(cfg["every"]), "keep": int(cfg["keep"])}
    except (OSError, ValueError, KeyError, TypeError):
        pass  # no or garbled config: the defaults
    return WorkflowCheckpointer(str(resume_from), **kw)


def resolve_resume(resume_from: Any, state: Any, n_steps: int, expect_like: Any = None,
                   allow_config_mismatch: bool = False, device: DeviceLike = None):
    """``resume_from`` (a :class:`WorkflowCheckpointer` or a directory)
    replaces ``state`` by its newest intact snapshot, placed on ``device``,
    when there is one; ``n_steps`` then counts total generations. Returns
    ``(state, remaining_steps)``."""
    loaded = _as_checkpointer(resume_from).latest(
        expect_like=expect_like, allow_config_mismatch=allow_config_mismatch
    )
    if loaded is not None:
        state = restore_layouts(loaded, device)
    return state, max(n_steps - int(state.generation), 0)


def enter_run(state: Any, n_steps: int, checkpointer: Optional[WorkflowCheckpointer] = None,
              resume_from: Any = None, expect_like: Any = None,
              allow_config_mismatch: bool = False, device: DeviceLike = None):
    """The shared run prologue: resolve ``resume_from`` into (restored
    state, remaining generations) and default the checkpointer to the
    resumed directory, so that a resumed run stays crash-safe. Returns
    ``(state, remaining_steps, checkpointer)``; with no ``resume_from`` the
    arguments pass through."""
    if resume_from is not None:
        state, n_steps = resolve_resume(resume_from, state, n_steps, expect_like=expect_like,
                                        allow_config_mismatch=allow_config_mismatch,
                                        device=device)
        if checkpointer is None:
            checkpointer = _as_checkpointer(resume_from)
    return state, n_steps, checkpointer


def checkpointed_run(wf: Any, state: Any, n_steps: int, checkpointer: WorkflowCheckpointer) -> Any:
    """``wf.run`` with snapshots between chunks that end on multiples of
    ``checkpointer.every`` (and at the end): the executor's ``run_fused``,
    whose background lane pickles and fsyncs while the next chunk runs."""
    from ..core.executor import GenerationExecutor

    return GenerationExecutor().run_fused(wf, state, n_steps, checkpointer=checkpointer)
