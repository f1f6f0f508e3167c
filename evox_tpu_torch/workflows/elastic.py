"""Elastic serving: bucketed fleet shapes, warm admission, population
autoscaling — the port of ``evox_tpu/workflows/elastic.py``.

- :class:`BucketTable` rounds a request's ``pop`` and fleet ``width`` up to
  rungs (powers of two by default); ``dim`` keys buckets exactly, never
  padded (padding the search space would change the objective).
- :class:`ElasticWorkflow` pads admission: a tenant asking for ``pop=p`` in
  a ``pop=B`` bucket runs the bucket's shape with its last ``B - p``
  fitness rows replaced by the worst finite fitness of its live rows
  (:func:`pad_inert_rows`), so the inert rows lose every comparison and
  never reach best-so-far or telemetry. The live-row count rides as the
  reserved per-tenant hyperparameter ``ACTIVE_ROWS``, so one bucket serves
  every requested pop up to ``B``. Width padding is idle filler tenants.
- :class:`ElasticServer` keeps one :class:`ElasticWorkflow` and
  :class:`~evox_tpu_torch.workflows.tenancy.RunQueue` per bucket, warms
  each bucket's entries through the serving cache
  (:class:`~evox_tpu_torch.core.exec_cache.ExecutableCache`,
  :func:`warm_fleet_cache`) and routes every :class:`ElasticSpec` to its
  bucket. Admission into a warm bucket is state surgery
  (``insert_tenant``) at the warmed shapes; a cold process pre-warms the
  buckets its cache's manifest lists before it serves
  (:meth:`ElasticServer.prewarm`).
- :class:`PopAutoscaler` grows a guarded tenant that shows the restart or
  stagnation escalation signal into the next pop rung's bucket when that
  bucket has room: ``workflows/ipop.py``'s ``grow_guarded`` surgery,
  journaled as an ``autoscale`` close-out in the source bucket after the
  continuation is durable in the target's.

Correctness contract: a padded tenant equals its
:meth:`ElasticWorkflow.solo_workflow` run at the bucket's shape with the
same mask; inert rows and filler neighbours never change a healthy
tenant's telemetry ring.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import warnings
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.exec_cache import ExecutableCache
from ..core.members import take_state
from ..core.struct import named_leaves
from ..utils.common import fold_in_seed
from .common import step_loop
from .fleet_health import _host_column
from .tenancy import RunQueue, TenantSpec, VectorizedWorkflow

__all__ = [
    "ACTIVE_ROWS",
    "BucketError",
    "BucketShape",
    "BucketTable",
    "ElasticServer",
    "ElasticSpec",
    "ElasticWorkflow",
    "PopAutoscaler",
    "fleet_fingerprint",
    "pad_inert_rows",
    "warm_fleet_cache",
]

# the reserved per-tenant hyperparameter: the tenant's live population rows
# (requested pop <= bucket pop); consumed by ElasticWorkflow, never bound
# onto the algorithm
ACTIVE_ROWS = "_elastic_active_rows"


def pad_inert_rows(fitness: torch.Tensor, active: Any) -> torch.Tensor:
    """Fitness rows at index ``>= active`` replaced by the worst finite
    fitness of the live rows (per objective column, the
    ``quarantine_nonfinite`` fill law); a live set with no finite entry
    falls back to the dtype's largest finite value. ``active`` is a 0-d
    tensor (a tenant's binding) or an int; ``active == pop`` is the
    identity, bit for bit."""
    n = fitness.shape[0]
    if isinstance(active, torch.Tensor):
        active = active.to(fitness.device)
    live = torch.arange(n, device=fitness.device) < active
    live_b = live if fitness.ndim == 1 else live[:, None]
    finite_live = torch.isfinite(fitness) & live_b
    worst = torch.amax(torch.where(finite_live, fitness, torch.full_like(fitness, -float("inf"))),
                       dim=0)
    worst = torch.where(torch.isfinite(worst), worst,
                        torch.full_like(worst, torch.finfo(fitness.dtype).max))
    return torch.where(live_b, fitness, worst)


# ------------------------------------------------------------------ buckets


class BucketError(ValueError):
    """A request cannot be mapped onto the bucket lattice (beyond the top
    rung, or a non-positive shape)."""


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """One canonical fleet shape: every tenant runs ``pop`` candidates over
    ``dim`` dimensions in a ``width``-wide fleet."""

    pop: int
    dim: int
    width: int

    @property
    def key(self) -> str:
        return f"pop{self.pop}_dim{self.dim}_w{self.width}"

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.pop, self.dim, self.width)


def _pow2_rungs(lo: int, hi: int) -> Tuple[int, ...]:
    rungs, v = [], max(int(lo), 1)
    while v < hi:
        rungs.append(v)
        v *= 2
    rungs.append(int(hi))
    return tuple(rungs)


class BucketTable:
    """The lattice of shapes requests are rounded up onto.

    Args:
        pop_rungs / width_rungs: explicit rungs (sorted here); default
            powers of two from ``min_pop`` to ``max_pop`` and from 1 to
            ``max_width``.

    A request beyond the top rung raises :class:`BucketError`: elastic
    serving rounds up, it never truncates a search."""

    def __init__(self, pop_rungs: Optional[Sequence[int]] = None,
                 width_rungs: Optional[Sequence[int]] = None, min_pop: int = 8,
                 max_pop: int = 1 << 16, max_width: int = 256):
        self.pop_rungs = (tuple(sorted(int(r) for r in pop_rungs)) if pop_rungs
                          else _pow2_rungs(min_pop, max_pop))
        self.width_rungs = (tuple(sorted(int(r) for r in width_rungs)) if width_rungs
                            else _pow2_rungs(1, max_width))
        if any(r < 1 for r in self.pop_rungs + self.width_rungs):
            raise BucketError("bucket rungs must be positive")

    @staticmethod
    def _round_up(value: int, rungs: Tuple[int, ...], what: str) -> int:
        if value < 1:
            raise BucketError(f"requested {what} must be >= 1, got {value}")
        for r in rungs:
            if r >= value:
                return r
        raise BucketError(
            f"requested {what}={value} exceeds the lattice's top rung {rungs[-1]}; extend the "
            f"{what} rungs (BucketTable({what}_rungs=...)) or shrink the request")

    def bucket_for(self, pop: int, dim: int, width: int = 1) -> BucketShape:
        """Pop and width round up to their rungs, dim passes through."""
        if dim < 1:
            raise BucketError(f"requested dim must be >= 1, got {dim}")
        return BucketShape(pop=self._round_up(int(pop), self.pop_rungs, "pop"), dim=int(dim),
                           width=self._round_up(int(width), self.width_rungs, "width"))

    def next_pop_rung(self, pop: int) -> Optional[int]:
        """The smallest rung above ``pop`` (the autoscaler's target), or
        None at the top."""
        for r in self.pop_rungs:
            if r > pop:
                return r
        return None

    def report(self) -> dict:
        return {"pop_rungs": list(self.pop_rungs), "width_rungs": list(self.width_rungs),
                "dim": "exact"}


# ----------------------------------------------------------- padded fleets


class ElasticWorkflow(VectorizedWorkflow):
    """A :class:`VectorizedWorkflow` that reads the reserved ``ACTIVE_ROWS``
    hyperparameter: each tenant's fitness rows beyond its requested pop get
    the inert fill (:func:`pad_inert_rows`) between the quarantine and the
    fit transforms. Tenants without the binding run as in the parent."""

    def _check_hp_name(self, name: str) -> None:
        if name == ACTIVE_ROWS:
            return  # reserved: consumed here, never bound
        super()._check_hp_name(name)

    def _bind(self, hp: Dict[str, Any]):
        if ACTIVE_ROWS in hp:
            hp = {k: v for k, v in hp.items() if k != ACTIVE_ROWS}
        return super()._bind(hp)

    def _filter_fitness(self, t, fitness: torch.Tensor) -> torch.Tensor:
        active = t.hyperparams.get(ACTIVE_ROWS)
        if active is None:
            return fitness
        return pad_inert_rows(fitness, active)

    def solo_workflow(self, index: Optional[int] = None,
                      hyperparams: Optional[Dict[str, Any]] = None, mesh: Any = None,
                      state: Any = None):
        """The solo reference and resume workflow of a padded tenant: the
        parent's ``StdWorkflow`` at the bucket's shape with the tenant's
        inert-row mask first in ``fit_transforms``, where the fleet applies
        it (after the quarantine, before the user's transforms)."""
        if hyperparams is None:
            hyperparams = self.tenant_hyperparams(index, state=state) if index is not None else {}
        hp = dict(hyperparams)
        active = hp.pop(ACTIVE_ROWS, None)
        wf = super().solo_workflow(hyperparams=hp, mesh=mesh)
        if active is not None:
            wf.fit_transforms = (partial(pad_inert_rows, active=int(np.asarray(active))),
                                 ) + tuple(wf.fit_transforms)
        return wf


# ------------------------------------------------------------- identities


def _as_array(v: Any) -> Optional[np.ndarray]:
    """``v`` as a numpy array for hashing by bytes, or None when it is not
    array-like (a tensor of any dtype or device included)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    if isinstance(v, (list, tuple, dict)) or callable(v):
        return None
    try:
        arr = np.asarray(v)
    except Exception:
        return None
    return None if arr.dtype == object else arr


def _value_digest(v: Any) -> str:
    """The identity of a baked constant (a closure cell, a partial's bound
    argument, an attribute): arrays and tensors by dtype, shape and bytes
    (a repr truncates large ones), containers element by element,
    callables by :func:`_transform_identity`, the rest by a repr without
    process-local ``0x`` addresses."""
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value_digest(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k!r}:{_value_digest(x)}"
                              for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))) + "}"
    if callable(v) and not isinstance(v, type):
        return _transform_identity(v)
    arr = _as_array(v)
    if arr is not None:
        return f"ndarray({arr.dtype},{arr.shape})#" + hashlib.sha256(arr.tobytes()).hexdigest()[:16]
    return re.sub(r" at 0x[0-9a-f]+", "", repr(v))


def _transform_identity(t: Any) -> str:
    """A content-addressed identity of a pop or fit transform: functions by
    module, qualname and a digest of their bytecode and closure values;
    partials by their function and bound arguments' values; other callables
    by type and an address-free repr."""
    if isinstance(t, partial):
        args = ",".join(_value_digest(a) for a in t.args)
        kw = ",".join(f"{k}={_value_digest(v)}" for k, v in sorted(t.keywords.items()))
        return f"partial({_transform_identity(t.func)},args=({args}),kw=({kw}))"
    code = getattr(t, "__code__", None)
    if code is not None:
        body = hashlib.sha256(code.co_code + repr(code.co_consts).encode()).hexdigest()[:16]
        cells = []
        for c in getattr(t, "__closure__", None) or ():
            try:
                cells.append(_value_digest(c.cell_contents))
            except ValueError:  # an empty cell
                cells.append("<empty>")
        name = getattr(t, "__qualname__", getattr(t, "__name__", "?"))
        return f"{getattr(t, '__module__', '?')}.{name}#{body}({','.join(cells)})"
    return (f"{type(t).__module__}.{type(t).__qualname__}:"
            + re.sub(r" at 0x[0-9a-f]+", "", repr(t)))


def _instance_identity(obj: Any, depth: int = 0) -> str:
    """A content digest of an algorithm's, problem's or monitor's
    configuration: public attributes by value (tensors and arrays by
    bytes, nested objects by recursion, callables by
    :func:`_transform_identity`), so two fleets differing only in a
    constant key apart."""
    name = f"{type(obj).__module__}.{type(obj).__qualname__}"
    if depth > 4 or not hasattr(obj, "__dict__"):
        return name
    h = hashlib.sha256(name.encode())
    for k, v in sorted(vars(obj).items()):
        if k.startswith("_"):
            continue
        h.update(k.encode())
        if callable(v) and not hasattr(v, "__dict__"):
            h.update(_transform_identity(v).encode())
            continue
        arr = _as_array(v)
        if arr is not None:
            h.update(str(arr.dtype).encode() + str(arr.shape).encode() + arr.tobytes())
        elif hasattr(v, "__dict__") and not callable(v):
            h.update(_instance_identity(v, depth + 1).encode())
        else:
            h.update(_value_digest(v).encode())
    return f"{name}#{h.hexdigest()[:16]}"


def fleet_fingerprint(wf: VectorizedWorkflow) -> str:
    """The static-configuration half of a serving-cache key: the
    algorithm's, problem's and monitors' configurations by value, the
    fleet's width, direction, quarantine, dtype policy and donation, the
    transforms' identities and the hyperparameter names. Leaf shapes and
    dtypes are keyed apart by the abstract signature."""
    parts = [
        type(wf).__qualname__,
        _instance_identity(wf.algorithm),
        _instance_identity(wf.problem),
        f"n={wf.n_tenants}",
        f"dir={wf.opt_direction.tolist()}",
        f"q={wf.quarantine_nonfinite}",
        f"donate={wf.donate_carries}",
        f"policy={wf.dtype_policy}",
        "pt:" + ",".join(_transform_identity(t) for t in wf.pop_transforms),
        "ft:" + ",".join(_transform_identity(t) for t in wf.fit_transforms),
        "mon:" + ",".join(_instance_identity(m) for m in wf.monitors),
        "hp:" + ",".join(sorted(wf.hyperparams)),
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


# ------------------------------------------------------------------ warm

_ENTRIES = ("fleet_step_first", "fleet_step", "fleet_run_loop", "fleet_solo_peel")


def warm_fleet_cache(wf: VectorizedWorkflow, cache: ExecutableCache,
                     bucket: Optional[BucketShape] = None, seed: int = 0,
                     planned: bool = True) -> Dict[str, Any]:
    """Warm the fleet's four serving entries through ``cache``, each by one
    dispatch at its exact shapes on a throwaway state: the first step (the
    ``init_ask`` peel), the steady step, the run loop (one generation; the
    trip count is a Python integer, so one entry covers every chunk
    length), and the single-tenant admission peel. Every later admission's
    peel and every ``run`` (one lookup a chunk: the first-step entry while
    the fleet is fresh, else the run loop's) go through the cache's lookup,
    so under a frozen cache a peel or a chunk at unwarmed shapes raises
    ``ExecCacheMissError`` before it dispatches. Idempotent (a re-warm is
    all memory hits). The cache is advertised as ``wf._exec_cache``
    (``run_report``'s ``serving`` section). Returns ``{"fingerprint",
    "entries"}``."""
    fp = fleet_fingerprint(wf)
    originals = getattr(wf, "_exec_cache_originals", None)
    if originals is None:
        originals = {"solo_peel": wf._solo_peel, "run": wf.run}
        wf._exec_cache_originals = originals
    bt = bucket.as_tuple() if bucket is not None else None
    get = partial(cache.get_or_compile, bucket=bt, mesh=wf.mesh, planned=planned,
                  device=wf.device)
    state0 = wf.init(seed)
    has_init = wf.algorithm.has_init_ask or wf.algorithm.has_init_tell
    get("fleet_step_first", fp, wf.step, (state0,))
    steady = wf.step(state0) if has_init else state0.replace(first_step=False)
    get("fleet_step", fp, wf.step, (steady,))
    get("fleet_run_loop", fp, lambda s, n: step_loop(wf, s, n), (steady, 1))
    hp0 = {k: v[0] for k, v in wf.hyperparams.items()}
    tenant0 = wf.init_tenant(seed, hp0)
    get("fleet_solo_peel", fp, originals["solo_peel"], (tenant0,))
    del state0, steady, tenant0

    # every lookup below is a memory hit at the warmed shapes (counted in
    # ``hits``); a miss warms the entry, or raises under a frozen cache
    def solo_peel(t):
        get("fleet_solo_peel", fp, originals["solo_peel"], (t,), planned=False)
        return originals["solo_peel"](t)

    def warm_generation(state, n=1):
        # on a copy: the warm-up of a live chunk's entry leaves it untouched
        copy = torch.utils._pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
        return originals["run"](copy, 1)

    def run(state, n_steps, *args, **kwargs):
        if n_steps > 0:
            if state.first_step:
                get("fleet_step_first", fp, warm_generation, (state,), planned=False)
            else:
                get("fleet_run_loop", fp, warm_generation, (state, 1), planned=False)
        return originals["run"](state, n_steps, *args, **kwargs)

    wf._solo_peel = solo_peel
    wf.run = run
    wf._exec_cache = cache
    return {"fingerprint": fp, "entries": list(_ENTRIES)}


# ------------------------------------------------------------- autoscaler


@dataclasses.dataclass
class PopAutoscaler:
    """IPOP as a serving policy: grow a struggling guarded run into the
    next pop rung's bucket when it has room. The trigger is the guard's
    escalation signal (``restarts`` past ``checked_restarts``, optionally a
    stagnation floor).

    Args:
        stagnation_limit: also trigger when a tenant's guarded
            ``stagnation`` reaches this (None: the restart signal only).
        max_grows: rungs one run may climb.
    """

    stagnation_limit: Optional[int] = None
    max_grows: int = 1

    def triggered(self, restarts: int, checked: int, stagnation: int) -> bool:
        trig = restarts > checked
        if self.stagnation_limit is not None:
            trig = trig or stagnation >= self.stagnation_limit
        return trig

    def report(self) -> dict:
        return {"stagnation_limit": self.stagnation_limit, "max_grows": self.max_grows}


# ----------------------------------------------------------------- server


@dataclasses.dataclass
class ElasticSpec:
    """One elastic request: any (pop, dim), rounded onto the lattice by the
    server. ``deadline`` is in the bucket's fleet generations (see
    :class:`~evox_tpu_torch.workflows.tenancy.TenantSpec`)."""

    seed: int
    n_steps: int
    pop: int
    dim: int
    hyperparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tag: Optional[str] = None
    deadline: Optional[int] = None


@dataclasses.dataclass
class _Bucket:
    shape: BucketShape
    workflow: ElasticWorkflow
    queue: RunQueue
    fillers: int = 0


class ElasticServer:
    """The elastic serving front end: submit any (pop, dim) search; the
    server buckets it, warms the bucket through the serving cache, pads
    admission and drives every bucket's RunQueue (SLA order, preemption and
    journal durability are the queue's).

    Args:
        factory: ``factory(bucket) -> ElasticWorkflow`` at the bucket's
            shape, with ``n_tenants == bucket.width`` and ``ACTIVE_ROWS`` in
            its constructor's hyperparameters.
        table: the :class:`BucketTable` (default powers of two).
        cache / cache_dir: an :class:`ExecutableCache` (or its directory).
        width: the fleet width asked of every bucket.
        chunk: generations a dispatch chunk.
        journal_dir / checkpoint_dir: per-bucket subdirectories
            (``<dir>/<bucket.key>``).
        autoscaler: a :class:`PopAutoscaler`, run after every serve round.
        supervisor: a RunSupervisor shared by every bucket queue.
        strict_after_warm: freeze the cache once a bucket is warm.

    The constructor pre-warms every bucket the cache's manifest lists
    (:meth:`prewarm`); a server that should start cold is given a cache
    without a directory.
    """

    def __init__(self, factory: Callable[[BucketShape], ElasticWorkflow],
                 table: Optional[BucketTable] = None, cache: Optional[ExecutableCache] = None,
                 cache_dir: Optional[str] = None, width: int = 4, chunk: int = 5,
                 journal_dir: Optional[str] = None, checkpoint_dir: Optional[str] = None,
                 autoscaler: Optional[PopAutoscaler] = None, supervisor: Any = None,
                 strict_after_warm: bool = False, metrics: Any = None, executor: Any = None):
        self.factory = factory
        self.table = table if table is not None else BucketTable()
        self.cache = cache if cache is not None else ExecutableCache(directory=cache_dir)
        self.width = width
        self.chunk = chunk
        self.journal_dir = Path(journal_dir) if journal_dir else None
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.autoscaler = autoscaler
        self.supervisor = supervisor
        self.strict_after_warm = strict_after_warm
        self.executor = executor
        if isinstance(metrics, (str, Path)):
            from .flightrec import FlightRecorder

            metrics = FlightRecorder(directory=str(metrics))
        self.metrics = metrics
        if metrics is not None and getattr(self.cache, "metrics", None) is None:
            self.cache.metrics = metrics
        self._buckets: Dict[str, _Bucket] = {}
        self._filler_seq = 0
        self.autoscale_events: List[dict] = []
        self.prewarmed: List[str] = self.prewarm()

    # ------------------------------------------------------------- buckets
    def bucket_for(self, spec: ElasticSpec) -> BucketShape:
        return self.table.bucket_for(spec.pop, spec.dim, self.width)

    def prewarm(self) -> List[str]:
        """Build and warm every bucket the cache's manifest lists (on this
        server's lattice), before any request: the cold process's warm
        start. Returns the bucket keys."""
        keys = []
        for entry in self.cache.listed():
            b = entry.get("bucket")
            if not b or len(b) != 3:
                continue
            shape = BucketShape(*(int(x) for x in b))
            try:
                on_lattice = self.table.bucket_for(shape.pop, shape.dim, shape.width) == shape
            except BucketError:
                on_lattice = False
            if on_lattice and shape.key not in keys:
                self._get_bucket(shape)
                keys.append(shape.key)
        return keys

    def _get_bucket(self, shape: BucketShape, recover: bool = False) -> _Bucket:
        b = self._buckets.get(shape.key)
        if b is not None:
            return b
        wf = self.factory(shape)
        if not isinstance(wf, ElasticWorkflow):
            raise TypeError("ElasticServer factory must return an ElasticWorkflow (got "
                            f"{type(wf).__name__}): the padded-admission mask lives there")
        if wf.n_tenants != shape.width:
            raise ValueError(f"factory built a {wf.n_tenants}-wide fleet for bucket {shape.key} "
                             f"(width {shape.width})")
        if ACTIVE_ROWS not in wf.hyperparams:
            raise ValueError(
                f"bucket workflow must declare the reserved {ACTIVE_ROWS!r} hyperparam in its "
                f"constructor stack (e.g. hyperparams={{{ACTIVE_ROWS!r}: np.full((width,), pop, "
                "np.int32)}}): it carries each tenant's live-row count")
        if self.autoscaler is not None and not hasattr(wf.algorithm, "health_report"):
            raise ValueError("PopAutoscaler needs the guarded escalation signal: the bucket "
                             "factory must wrap its algorithm in GuardedAlgorithm "
                             "(core/guardrail.py)")
        warm_fleet_cache(wf, self.cache, bucket=shape, planned=True)
        wf._bucket_table = self.table  # run_report's serving.buckets
        if recover:
            if self.journal_dir is None:
                raise ValueError("recovering a bucket needs journal_dir: there is no journal to "
                                 "replay without one")
            q = RunQueue.recover(wf, str(self.journal_dir / shape.key), supervisor=self.supervisor,
                                 metrics=self.metrics, executor=self.executor)
        else:
            q = RunQueue(
                wf, chunk=self.chunk, supervisor=self.supervisor,
                journal=str(self.journal_dir / shape.key) if self.journal_dir else None,
                checkpoint_dir=(str(self.checkpoint_dir / shape.key) if self.checkpoint_dir
                                else None),
                metrics=self.metrics, executor=self.executor)
        b = _Bucket(shape=shape, workflow=wf, queue=q)
        self._buckets[shape.key] = b
        if self.strict_after_warm:
            self.cache.freeze()
        return b

    # -------------------------------------------------------------- submit
    def submit(self, spec: ElasticSpec) -> BucketShape:
        """Route a request onto the lattice and queue it in its bucket."""
        shape = self.bucket_for(spec)
        b = self._get_bucket(shape)
        b.queue.submit(TenantSpec(
            seed=spec.seed, n_steps=spec.n_steps,
            hyperparams={**spec.hyperparams, ACTIVE_ROWS: np.int32(spec.pop)},
            tag=spec.tag, pop=shape.pop, deadline=spec.deadline))
        return shape

    def _filler_spec(self, b: _Bucket) -> TenantSpec:
        """An inert width-padding tenant: all rows live, a one-generation
        budget, its result dropped."""
        self._filler_seq += 1
        b.fillers += 1
        hp0 = {name: stack[0].cpu().numpy() for name, stack in b.workflow.hyperparams.items()}
        hp0[ACTIVE_ROWS] = np.int32(b.shape.pop)
        return TenantSpec(seed=1_000_003 + self._filler_seq, n_steps=1, hyperparams=hp0,
                          tag=f"_pad_{self._filler_seq:04d}", pop=b.shape.pop)

    def _ensure_started(self, b: _Bucket) -> None:
        q = b.queue
        if q.state is not None or (not q.pending and not q.continuations):
            return
        # continuations fill slots too: top up only the real shortfall
        while len(q.pending) + len(q.continuations) < b.workflow.n_tenants:
            q.submit(self._filler_spec(b))
        q.start()

    # --------------------------------------------------------------- serve
    def has_work(self) -> bool:
        """Whether any bucket has pending, parked or running work."""
        for b in self._buckets.values():
            q = b.queue
            if q.pending or q.continuations:
                return True
            if q.state is not None and not q.finished:
                return True
        return False

    def serve_round(self) -> None:
        """One scheduling quantum: every bucket with work advances one
        chunk, then the autoscale pass."""
        for b in list(self._buckets.values()):
            self._ensure_started(b)
            q = b.queue
            if q.state is None or (q.finished and not (q.pending or q.continuations)):
                continue
            q.step_chunk()
        self._autoscale_pass()

    def serve(self, max_rounds: Optional[int] = None) -> List[dict]:
        """Drive every bucket to completion, round robin; returns the merged
        real-tenant results."""
        rounds = 0
        while self.has_work():
            self.serve_round()
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return self.results()

    def recover_bucket(self, shape: BucketShape) -> _Bucket:
        """Rebuild a dead bucket from its journal (``RunQueue.recover``);
        refuses a live one."""
        if shape.key in self._buckets:
            raise RuntimeError(f"bucket {shape.key} is already live in this server: "
                               "recover_bucket rebuilds dead buckets, it cannot replace a running "
                               "queue")
        return self._get_bucket(shape, recover=True)

    # ----------------------------------------------------------- autoscale
    def _autoscale_pass(self) -> None:
        """Grow triggered tenants into the next pop rung's bucket. The guard's
        counters are host integers in the port: the decision reads no
        device memory."""
        if self.autoscaler is None:
            return
        for b in list(self._buckets.values()):
            q = b.queue
            if q.state is None:
                continue
            astate = q.state.tenants.algo
            if not hasattr(astate, "restarts"):
                continue
            n = b.workflow.n_tenants
            restarts = _host_column(astate.restarts, n)
            checked = _host_column(astate.checked_restarts, n)
            stagnation = _host_column(astate.stagnation, n)
            for i, slot in enumerate(q.slots):
                if slot is None or not slot.active or slot.frozen:
                    continue
                spec = slot.spec
                if (spec.tag or "").startswith("_pad_"):
                    continue
                grows = getattr(spec, "_elastic_grows", 0)
                if grows >= self.autoscaler.max_grows:
                    continue
                if not self.autoscaler.triggered(restarts[i], checked[i], stagnation[i]):
                    continue
                new_pop = self.table.next_pop_rung(b.shape.pop)
                if new_pop is None:
                    continue
                tb = self._get_bucket(BucketShape(pop=new_pop, dim=b.shape.dim,
                                                  width=b.shape.width))
                if not self._has_capacity(tb):
                    continue
                self._grow(b, i, tb, grows)

    @staticmethod
    def _has_capacity(tb: _Bucket) -> bool:
        """An unstarted bucket has room; a started one needs a parked
        (inactive, unfrozen) slot and nothing pending that would claim
        it."""
        q = tb.queue
        if q.state is None:
            return True
        if q.pending or q.continuations:
            return False
        return any(s is None or (not s.active and not s.frozen) for s in q.slots)

    def _grow(self, b: _Bucket, index: int, tb: _Bucket, grows: int) -> None:
        """Move slot ``index`` of ``b`` into ``tb`` at the next rung: the
        grown tenant is built and made durable in the target queue first,
        then the source slot is closed out (write-ahead order: a crash
        between the two duplicates work, which recovery dedups, and never
        loses it)."""
        from .checkpoint import WorkflowCheckpointer
        from .ipop import grow_guarded
        from .std import StdWorkflowState

        q, twf = b.queue, tb.workflow
        spec = q.slots[index].spec
        old = take_state(q.state.tenants, index)
        hp2 = {**spec.hyperparams, ACTIVE_ROWS: np.int32(tb.shape.pop)}
        fresh = twf.init_tenant(fold_in_seed(int(spec.seed), grows + 1), hp2)
        fresh = fresh.replace(algo=grow_guarded(fresh.algo, old.algo))
        if twf.algorithm.has_init_ask or twf.algorithm.has_init_tell:
            # the first generation peels solo at the target rung after the
            # re-centre, as admission does
            fresh = twf._solo_peel(fresh)

        def sig(t):
            return [(tuple(getattr(x, "shape", ())), getattr(x, "dtype", None))
                    for _, x in named_leaves(t)]

        if sig(old.monitors) == sig(fresh.monitors):
            monitors = old.monitors  # the ring continues across the rung
        else:
            warnings.warn(f"autoscale growth {b.shape.key} -> {tb.shape.key}: monitor state is "
                          "population-shaped and cannot cross the rung; the grown tenant starts a "
                          "fresh ring (telemetry continuity lost for this tenant)")
            monitors = fresh.monitors
        grown = fresh.replace(generation=old.generation.clone(), monitors=monitors)
        # deadlines are on the owning queue's fleet clock: carry the slack
        # over, clamped to the submit-time floor (n_steps)
        deadline2 = spec.deadline
        if deadline2 is not None:
            sgen = int(q.state.generation)
            tgen = int(tb.queue.state.generation) if tb.queue.state is not None else 0
            deadline2 = max(tgen + (spec.deadline - sgen), spec.n_steps)
        spec2 = dataclasses.replace(spec, pop=tb.shape.pop, hyperparams=hp2, deadline=deadline2)
        spec2._elastic_grows = grows + 1
        cont_dir = None
        if tb.queue.checkpoint_dir is not None:
            cont_dir = Path(tb.queue.checkpoint_dir) / f"{spec.tag or 'tenant'}_grown{grows + 1}"
            ckpt = WorkflowCheckpointer(str(cont_dir), every=max(int(old.generation), 1),
                                        keep=tb.queue.keep)
            ckpt.save(StdWorkflowState(generation=int(grown.generation), algo=grown.algo,
                                       prob=grown.prob, monitors=grown.monitors,
                                       first_step=False))
        tb.queue.submit_resume(spec2, checkpoint=str(cont_dir) if cont_dir is not None else None,
                               state=grown, done=int(old.generation))
        q.counters["grown"] = q.counters.get("grown", 0) + 1
        entry = q._close_out(index, status="grown")
        if self.metrics is not None:
            self.metrics.count("elastic.grows")
            self.metrics.event("elastic.grow", tag=spec.tag, from_bucket=b.shape.key,
                               to_bucket=tb.shape.key)
        self.autoscale_events.append({
            "tag": spec.tag, "from": b.shape.key, "to": tb.shape.key,
            "generation": int(old.generation), "grows": grows + 1,
            "source_entry": {k: entry.get(k) for k in ("status", "generations")}})

    # -------------------------------------------------------------- results
    def results(self) -> List[dict]:
        """Real tenants' results across buckets (fillers dropped), each
        with its bucket key."""
        return [{**r, "bucket": key} for key, b in self._buckets.items() for r in b.queue.results
                if not (r.get("tag") or "").startswith("_pad_")]

    def report(self) -> dict:
        """The lattice, each bucket's queue report, the autoscale events and
        the shared cache."""
        return {
            "table": self.table.report(),
            "buckets": {key: b.queue.report() for key, b in self._buckets.items()},
            "autoscale": {"policy": self.autoscaler.report() if self.autoscaler else None,
                          "events": list(self.autoscale_events)},
            "cache": self.cache.report(),
        }
