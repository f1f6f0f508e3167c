"""Carry state from the JAX package into the port.

The functions here take the JAX package's states *as numpy arrays* — e.g.
``jax.tree.map(numpy.asarray, state)`` on the JAX side — and build the
port's states from them, so both packages can start from the same point.
They read attributes by name and never import the JAX package.

What crosses unchanged: OpenES centers, the optimizer state of every
port of an optax optimizer (field by field by optax's names, through
``optimizer_state``), the GA-skeleton MO states
(population, fitness, offspring; NSGA-II's rank and crowd too), the CSO
and PSO-family states (every field the two states share by name), the
EvalMonitor state, the states of the rest of the ES family (CMA-ES,
PGPE and the others, through ``es_state``; the ClipUp velocity too), the
DE family's (``de_state``: archives, memories and the ``attrib``
attribution included), LES's state (``les_state``) and its flax
parameter tree (``les_params``), the
decomposition and reference-vector MOEAs' states (MOEA/D and its
variants, EAG-MOEA/D, RVEA, RVEAa, LMOCSO; NSGA-III and TDEA through
``mo_state``), the workflow's generation and first-step flag, the rollout problem's
episode-length cap and observation statistics (``rollout_state``),
populations and genomes as ``(pop, dim)`` arrays, ``mlp_policy``
params trees, the decomposition containers' states (their stacked member
states split into the port's tuples), ``GuardedState`` (its inner state
and counters; ``numpy_fields`` carries a port state back as numpy fields
by name), and ``IslandWorkflowState`` (its island-stacked ``algo`` split
into the port's per-island states), IM-MOEA's state (``immoea_state``),
the TelemetryMonitor state (``telemetry_state``), a ``ShardedES``'s state
(``sharded_es_state``: the JAX package's ``P("pop")`` samples, given
whole as numpy, resident on the port's mesh) and the surrogate's
(``surrogate_state``: the archive, a ``GPModelState`` or the member-stacked
``EnsembleModelState``, the health readings and the ledger;
``surrogate_workflow_state`` carries a whole ``SurrogateWorkflowState``).
:func:`algorithm_state` picks the carry-over for any algorithm.

Constants an algorithm builds in its constructor can be replaced by the
JAX package's where a float tie decides them: ``set_neighbors`` (MOEA/D's
neighbour table, and its variants') and ``set_reference_vectors``
(NSGA-III's, TDEA's, RVEA's, LMOCSO's unit reference directions and
MOEA/D-M2M's subregion directions).

A state the JAX package holds under ``BF16_STORAGE`` has numpy bfloat16
leaves (ml_dtypes'). Fields carried by name (:func:`_carry_by_name`: the
CSO and PSO-family states, the ES and DE families) keep that dtype: such a
leaf crosses into a torch ``bfloat16`` tensor bit for bit through a
16-bit integer view (:func:`tensor_from_numpy`), and ``numpy_fields``
carries a ``bfloat16`` tensor back as its ``uint16`` bit pattern (view it
as ml_dtypes' bfloat16 on the JAX side).

What cannot cross: PRNG keys. JAX's threefry keys and the port's integer
seeds for ``torch.Generator`` name unrelated streams, so the port's states
get fresh seeds from ``seed``; a comparison that needs the same random
numbers hands both sides the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .algorithms import containers as _containers
from .algorithms import mo as _mo
from .algorithms.mo.common import GAMOAlgorithm, MOState
from .algorithms.mo.nsga2 import NSGA2, NSGA2State
from .algorithms.so import de as _de
from .algorithms.so import es as _es
from .algorithms.so.es import les_meta as _les_meta
from .algorithms.so.es.open_es import OpenES, OpenESState
from .algorithms.so.pso.common import SwarmAlgorithm
from .core.members import stack_states
from .core.device import DeviceLike, resolve_device
from .core.distributed import ShardedES, place_state
from .core.guardrail import GuardedAlgorithm, GuardedState
from .monitors.eval_monitor import EvalMonitor, EvalMonitorState
from .monitors.telemetry import TelemetryMonitor, TelemetryState
from .problems.neuroevolution.rollout import PolicyRolloutProblem, RolloutState
from .utils.common import split_seed, tree_map
from .workflows.islands import IslandWorkflow, IslandWorkflowState
from .workflows.std import StdWorkflow, StdWorkflowState
from .workflows.surrogate import SurrogateState, SurrogateWorkflow, SurrogateWorkflowState


def tensor_from_numpy(array: Any) -> torch.Tensor:
    """A copy of a numpy array as a CPU tensor, bit for bit; a bfloat16
    array (ml_dtypes', the JAX package's) crosses through a 16-bit integer
    view, since numpy itself has no bfloat16."""
    arr = np.asarray(array)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def population(array: Any, device: DeviceLike = None) -> torch.Tensor:
    """A ``(pop, dim)`` population or genome batch as a float32 tensor."""
    arr = np.asarray(array, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"expected a (pop, dim) array, got shape {arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def mlp_params(tree: Any, device: DeviceLike = None) -> list:
    """The port's ``mlp_policy`` params from the JAX package's (numpy leaves):
    a list of ``{"w": (..., fan_in, fan_out), "b": (..., fan_out)}`` layers,
    one policy or a batch with leading axes, as float32 tensors."""
    dev = resolve_device(device)
    if not (isinstance(tree, (list, tuple)) and all(
            isinstance(l, dict) and set(l) == {"w", "b"} for l in tree)):
        raise ValueError("expected an mlp_policy params tree: a list of {'w', 'b'} layers")
    out = []
    for i, layer in enumerate(tree):
        w = np.array(layer["w"], dtype=np.float32)
        b = np.array(layer["b"], dtype=np.float32)
        if w.ndim < 2 or b.shape != w.shape[:-2] + w.shape[-1:]:
            raise ValueError(f"layer {i}: w {w.shape} and b {b.shape} are not one MLP layer")
        out.append({"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)})
    return out


def _optax_fields(opt_state: Any, out: Optional[dict] = None) -> dict:
    """Every named field of an optax state (a chain's tuple of named
    tuples, masked states nested), first occurrence of a name kept."""
    out = {} if out is None else out
    if hasattr(opt_state, "_fields"):
        for name in opt_state._fields:
            value = getattr(opt_state, name)
            if hasattr(value, "_fields") or (isinstance(value, tuple) and value
                                             and hasattr(value[0], "_fields")):
                _optax_fields(value, out)  # a nested state, or a chain's states
            else:
                out.setdefault(name, value)
    elif isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            _optax_fields(part, out)
    return out


def optimizer_state(optimizer: Any, opt_state: Any, device: torch.device) -> Any:
    """The port's optimizer state for ``optimizer`` from an optax state
    (numpy leaves). The port's state fields carry optax's field names, so
    each is taken by name: arrays as float tensors (the port's dtype),
    counts as ints, flags as bools; SM3's one-axis accumulator list gives
    its one vector. A field optax has no counterpart of (``noisy_sgd``'s
    seed: optax holds a key) keeps the port's fresh value."""
    fields = _optax_fields(opt_state)
    vectors = [np.asarray(v) for v in fields.values()
               if not isinstance(v, (list, tuple)) and np.asarray(v).ndim >= 1]
    shape = vectors[0].shape if vectors else (0,)
    fresh = optimizer.init(torch.zeros(shape, device=device))
    if not dataclasses.is_dataclass(fresh):
        return fresh  # an empty state: sgd without momentum, sign_sgd, fromage
    carried = {}
    for f in dataclasses.fields(fresh):
        ours = getattr(fresh, f.name)
        if f.name not in fields or ours is None:
            continue
        theirs = fields[f.name]
        if isinstance(theirs, (list, tuple)):
            theirs = theirs[0]
        if isinstance(ours, torch.Tensor):
            carried[f.name] = torch.from_numpy(np.array(theirs, dtype=np.float32)).to(
                device=device, dtype=ours.dtype)
        elif isinstance(ours, bool):
            carried[f.name] = bool(np.asarray(theirs))
        else:
            carried[f.name] = int(np.asarray(theirs))
    return fresh.replace(**carried)


def open_es_state(algo: OpenES, jax_state: Any, seed: int = 0) -> OpenESState:
    """``OpenESState`` from the JAX package's ``OpenESState`` (numpy leaves:
    ``center``, ``opt_state``). The noise and key streams start from
    ``seed``."""
    center = torch.from_numpy(np.array(jax_state.center, dtype=np.float32)).to(algo.device)
    if center.shape != (algo.dim,):
        raise ValueError(f"center has shape {tuple(center.shape)}, expected ({algo.dim},)")
    fresh = algo.init(seed)
    return fresh.replace(
        center=center,
        opt_state=optimizer_state(algo.optimizer, jax_state.opt_state, algo.device),
    )


def _tensor(array: Any, dtype: Any, shape: tuple, name: str, device: torch.device) -> torch.Tensor:
    """A copy of numpy ``array`` as a tensor of numpy ``dtype`` on ``device``."""
    arr = np.array(array, dtype=dtype)
    if arr.shape != shape:
        raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
    return torch.from_numpy(arr).to(device)


def mo_state(algo: GAMOAlgorithm, jax_state: Any, seed: int = 0) -> MOState:
    """``MOState`` from the JAX package's (numpy leaves ``population``,
    ``fitness``, ``offspring``); the key does not cross, the port's seed
    starts from ``seed``."""
    n, d, m, dev = algo.pop_size, algo.dim, algo.n_objs, algo.device
    return algo.init(seed).replace(
        population=_tensor(jax_state.population, np.float32, (n, d), "population", dev),
        fitness=_tensor(jax_state.fitness, np.float32, (n, m), "fitness", dev),
        offspring=_tensor(jax_state.offspring, np.float32, (n, d), "offspring", dev),
    )


def nsga2_state(algo: NSGA2, jax_state: Any, seed: int = 0) -> NSGA2State:
    """``NSGA2State`` from the JAX package's: the ``MOState`` leaves, and the
    survivors' ``rank`` (int32) and ``crowd``."""
    n, dev = algo.pop_size, algo.device
    return mo_state(algo, jax_state, seed).replace(
        rank=_tensor(jax_state.rank, np.int32, (n,), "rank", dev),
        crowd=_tensor(jax_state.crowd, np.float32, (n,), "crowd", dev),
    )


def _carried(ours: Any, theirs: Any, name: str, algo: Any) -> Any:
    """One field of the JAX state at the port's shape and dtype: tensors as
    tensors, nested states (an ``Attribution``) field by field, host
    integers as ints, the optimizer state through
    :func:`optimizer_state`."""
    if name == "opt_state":
        return optimizer_state(algo.optimizer, theirs, algo.device)
    if isinstance(ours, torch.Tensor):
        theirs = tensor_from_numpy(theirs)
        if tuple(theirs.shape) != tuple(ours.shape):
            raise ValueError(f"{name} has shape {tuple(theirs.shape)}, expected {tuple(ours.shape)}")
        dtype = torch.bfloat16 if theirs.dtype == torch.bfloat16 else ours.dtype  # a bf16 leaf stays
        return theirs.to(device=ours.device, dtype=dtype)
    if dataclasses.is_dataclass(ours):
        return ours.replace(**{
            f.name: _carried(getattr(ours, f.name), getattr(theirs, f.name), f"{name}.{f.name}", algo)
            for f in dataclasses.fields(ours) if hasattr(theirs, f.name)})
    return int(np.asarray(theirs))


def _carry_by_name(algo: Any, jax_state: Any, seed: int) -> Any:
    """The port's fresh state for ``algo`` with each field that the JAX
    state has by the same name carried across (:func:`_carried`)."""
    fresh = algo.init(seed)
    return fresh.replace(**{
        f.name: _carried(getattr(fresh, f.name), getattr(jax_state, f.name), f.name, algo)
        for f in dataclasses.fields(fresh) if hasattr(jax_state, f.name)})


def swarm_state(algo: SwarmAlgorithm, jax_state: Any, seed: int = 0) -> Any:
    """A CSO or PSO-family state from the JAX package's (numpy leaves): each
    field of the port's state that the JAX state has by the same name, at
    the port's shape and dtype (DMS-PSO-EL's ``gen`` as an int). The keys
    do not cross: the port's seeds start from ``seed``, and a CSO state
    crosses between generations (no pending ``ask``)."""
    return _carry_by_name(algo, jax_state, seed)


def es_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """The state of any ES algorithm of the port but OpenES (CMA-ES and its
    variants, MA-ES, RM-ES, the NES family, PGPE, ARS, ASEBO, GuidedES,
    PersistentES, NoiseReuseES, ESMC, DES, AMaLGaM) from the JAX package's
    (numpy leaves): every field the two states share by name, the
    optimizer state included (sgd, adam, clipup), and the device counters
    (``iteration``, ``inner_step``) as the port's host integers. The keys do
    not cross: the port's seeds start from ``seed``; a state crosses between
    generations, or after ``ask`` where its stored samples (``z``,
    ``noise``, ``delta``, ``population``) cross with it."""
    return _carry_by_name(algo, jax_state, seed)


def sharded_es_state(algo: ShardedES, jax_state: Any, seed: int = 0) -> Any:
    """A ``ShardedES`` state from the JAX package's (numpy leaves, the
    ``P("pop")`` fields such as ``z`` given whole, as ``jax.device_get``
    returns them): the wrapped algorithm's state by :func:`es_state`, placed
    on the wrapper's mesh, its ``sharded_pop_fields`` resident there (on a
    mesh that spans processes, this process's blocks). Without a mesh, the
    wrapped algorithm's state."""
    return algo.resident(place_state(es_state(algo.algorithm, jax_state, seed), algo.mesh))


def mo_family_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """The state of MOEAD, MOEADDRA, MOEADM2M, EAGMOEAD, RVEA, RVEAa,
    LMOCSO, HypE, KnEA or BCEIBEA from the JAX package's (numpy leaves):
    every field the two states share by name (``ideal``, ``utility``,
    ``old_value``, ``success``, ``offspring_loc``, ``vectors``,
    ``velocity``, HypE's ``ref_point`` and ``rank``, KnEA's ``knee``,
    ``rank``, ``r`` and ``t``, BCE-IBEA's NPC and PC populations and
    ``n_nd``, and the rest), the device counters ``gen`` and BCE-IBEA's
    ``counter`` as the port's host integers. The key does not cross: the
    port's seed starts from ``seed``; a state crosses between generations
    (the draws ``ask`` keeps for ``tell`` do not cross)."""
    return _carry_by_name(algo, jax_state, seed)


def set_neighbors(algo: Any, table: Any) -> None:
    """Replace a MOEA/D-family algorithm's ``(n, T)`` neighbour table with
    ``table`` (the JAX package's ``algo.neighbors``, as numpy)."""
    arr = np.asarray(table)
    want = tuple(algo.neighbors.shape)
    if arr.shape != want:
        raise ValueError(f"neighbors has shape {arr.shape}, expected {want}")
    if arr.size and (arr.min() < 0 or arr.max() >= algo.pop_size):
        raise ValueError(f"neighbors index outside [0, {algo.pop_size})")
    algo.neighbors = torch.from_numpy(arr.astype(np.int64)).to(algo.device)


# algorithm class -> the attribute holding its unit reference directions
_REFERENCE_ATTRS = {_mo.NSGA3: "refs", _mo.TDEA: "refs", _mo.RVEA: "v0", _mo.RVEAa: "v0",
                    _mo.LMOCSO: "vectors", _mo.MOEADM2M: "dirs"}


def set_reference_vectors(algo: Any, vectors: Any) -> None:
    """Replace the unit reference directions an algorithm built from
    Das-Dennis points (NSGA3's and TDEA's ``refs``, RVEA's and RVEAa's
    ``v0``, LMOCSO's ``vectors``, MOEADM2M's ``dirs``) with the JAX
    package's, as numpy. Build the state after this call: RVEA's state
    starts from ``v0``."""
    name = _REFERENCE_ATTRS.get(type(algo))
    if name is None:
        raise NotImplementedError(f"{type(algo).__name__} has no reference vectors to set")
    ours = getattr(algo, name)
    setattr(algo, name, _tensor(vectors, np.float32, tuple(ours.shape), name, algo.device))


def de_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """The state of DE, ODE, CoDE, SaDE, JaDE or SHADE from the JAX
    package's (numpy leaves): every field the two states share by name,
    the ``attrib`` field by field, the archive and the memories included;
    SaDE's ``gen`` as the port's host integer, ``mem_pos`` and
    ``archive_size`` as 0-dim tensors. The key does not cross: the port's
    seed starts from ``seed``; a state crosses between generations."""
    return _carry_by_name(algo, jax_state, seed)


def les_params(jax_params: Any, device: DeviceLike = None) -> dict:
    """LES's parameter dict in the port's layout (``les.py``) from the JAX
    package's flax tree (numpy leaves, ``{"weights": {"params": {...}},
    "lr": {"params": {...}}}``): each ``Dense`` layer's ``kernel`` ``(in,
    out)`` and ``bias`` as float32 tensors."""
    dev = resolve_device(device)
    out: dict = {}
    for net, layer, fan_in, fan_out in _les_meta.LAYERS:
        tree = jax_params[net]["params"]
        if layer not in tree:
            raise ValueError(f"the LES parameters have no {net}.{layer}")
        out.setdefault(net, {})[layer] = {
            "bias": _tensor(tree[layer]["bias"], np.float32, (fan_out,), f"{net}.{layer}.bias", dev),
            "kernel": _tensor(tree[layer]["kernel"], np.float32, (fan_in, fan_out),
                              f"{net}.{layer}.kernel", dev),
        }
    return out


def les_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """``LESState`` from the JAX package's (numpy leaves: ``mean``,
    ``sigma``, the two paths and ``population``). The key does not
    cross."""
    return _carry_by_name(algo, jax_state, seed)


def rollout_state(problem: PolicyRolloutProblem, jax_state: Any, seed: int = 0) -> RolloutState:
    """``RolloutState`` from the JAX package's (numpy leaves ``cap``, the
    int32 episode-length cap, and ``norm``, the ``(count, mean, m2)``
    observation statistics; each ``None`` where the problem has no
    ``CapEpisode`` or ``ObsNormalizer``). The key does not cross: the
    episode seeds start from ``seed``."""
    dev = problem.device
    cap = norm = None
    if problem.cap_episode is not None:
        cap = _tensor(jax_state.cap, np.int32, (), "cap", dev)
    if problem.obs_normalizer is not None:
        d = problem.obs_normalizer.obs_dim
        count, mean, m2 = jax_state.norm
        norm = (_tensor(count, np.float32, (), "norm count", dev),
                _tensor(mean, np.float32, (d,), "norm mean", dev),
                _tensor(m2, np.float32, (d,), "norm m2", dev))
    return problem.init(seed).replace(cap=cap, norm=norm)


def eval_monitor_state(monitor: EvalMonitor, jax_state: Any) -> EvalMonitorState:
    """``EvalMonitorState`` from the JAX package's (numpy leaves; solutions
    may be trees of dicts and lists): every buffer in its own dtype on the
    monitor's device, ``hist_count`` as an int, unset buffers as ``None``."""
    as_t = lambda a: torch.from_numpy(np.array(a)).to(monitor.device)
    changes = {}
    for f in dataclasses.fields(EvalMonitorState):
        value = getattr(jax_state, f.name, None)
        if value is None:
            continue
        changes[f.name] = int(np.asarray(value)) if f.name == "hist_count" else tree_map(as_t, value)
    return EvalMonitorState(**changes)


def std_workflow_state(
    wf: StdWorkflow, jax_state: Any, seed: int = 0, prob_state: Optional[Any] = None
) -> StdWorkflowState:
    """``StdWorkflowState`` from the JAX package's (numpy leaves): the
    generation, the first-step flag and the algorithm state cross; the
    problem and monitor states are the port's own, seeded from ``seed``
    (or ``prob_state`` for the problem)."""
    fresh = wf.init(seed)
    algo_seed = split_seed(seed, 1)[0]
    return fresh.replace(
        generation=int(np.asarray(jax_state.generation)),
        algo=algorithm_state(wf.algorithm, jax_state.algo, algo_seed),
        prob=fresh.prob if prob_state is None else prob_state,
        first_step=bool(jax_state.first_step),
    )


def immoea_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """``IMMOEAState`` from the JAX package's (numpy leaves ``population``,
    ``fitness``, ``offspring``); the key does not cross."""
    return mo_state(algo, jax_state, seed)


def _like(fresh: Any, theirs: Any, name: str) -> Any:
    """The JAX leaves of a state (a tree of them) at the shapes and dtypes
    of the port's ``fresh`` state, field by field; host values from
    ``fresh``."""
    if isinstance(fresh, torch.Tensor):
        if fresh.dtype == torch.bfloat16:  # a leaf at rest under BF16_STORAGE
            return tensor_from_numpy(theirs).to(device=fresh.device, dtype=fresh.dtype)
        dtype = torch.empty((), dtype=fresh.dtype).numpy().dtype
        return _tensor(theirs, dtype, tuple(fresh.shape), name, fresh.device)
    if isinstance(fresh, dict):
        return {k: _like(v, theirs[k], f"{name}[{k!r}]") for k, v in fresh.items()}
    if dataclasses.is_dataclass(fresh):
        return fresh.replace(**{
            f.name: _like(getattr(fresh, f.name), getattr(theirs, f.name), f"{name}.{f.name}")
            for f in dataclasses.fields(fresh) if hasattr(theirs, f.name)})
    return fresh


def telemetry_state(monitor: TelemetryMonitor, jax_state: Any) -> TelemetryState:
    """``TelemetryState`` from the JAX package's (numpy leaves): every
    counter, the best key and the rings, each at the port's dtype and
    shape on the monitor's device."""
    return _like(monitor.init(), jax_state, "telemetry")


def surrogate_state(wf: SurrogateWorkflow, jax_sur: Any, seed: int = 0) -> SurrogateState:
    """The screening workflow's ``SurrogateState`` from the JAX package's
    (numpy leaves): the archive, the model (``GPModelState``, or
    ``EnsembleModelState`` with its member-stacked weights dict), the
    health readings, the ledger and the fallback ring. The refit key does
    not cross: the port's refit seed is the one ``wf.init(seed)`` derives."""
    if not wf._screening:
        raise ValueError("the workflow does not screen: it has no surrogate state")
    return _like(wf.init(seed).sur, jax_sur, "sur")


def surrogate_workflow_state(wf: SurrogateWorkflow, jax_state: Any, seed: int = 0,
                             prob_state: Optional[Any] = None) -> SurrogateWorkflowState:
    """``SurrogateWorkflowState`` from the JAX package's (numpy leaves): as
    :func:`std_workflow_state`, plus the surrogate state and each
    ``TelemetryMonitor``'s state (other monitors start fresh)."""
    base = std_workflow_state(wf, jax_state, seed, prob_state)
    monitors = tuple(
        telemetry_state(m, theirs) if isinstance(m, TelemetryMonitor) else ours
        for m, ours, theirs in zip(wf.monitors, base.monitors, jax_state.monitors))
    sur = None if jax_state.sur is None else surrogate_state(wf, jax_state.sur, seed)
    return base.replace(monitors=monitors, sur=sur)


# algorithm class -> the carry-over of its state
_ALGO_STATES = {OpenES: open_es_state, NSGA2: nsga2_state, _mo.IMMOEA: immoea_state}
_ALGO_STATES.update({cls: mo_state for cls in (_mo.NSGA3, _mo.TDEA, _mo.GDE3, _mo.IBEA, _mo.SRA,
                                               _mo.SPEA2, _mo.BiGE)})
_ALGO_STATES.update({
    cls: mo_family_state
    for cls in (_mo.MOEAD, _mo.MOEADDRA, _mo.MOEADM2M, _mo.EAGMOEAD, _mo.RVEA, _mo.RVEAa, _mo.LMOCSO,
                _mo.HypE, _mo.KnEA, _mo.BCEIBEA)
})
_ALGO_STATES.update({
    getattr(_es, name): es_state
    for name in _es.__all__
    if not name.endswith("State") and name not in ("OpenES", "ClipUp", "RestartCMAESDriver", "LES")
})
_ALGO_STATES[_es.LES] = les_state
_ALGO_STATES.update({getattr(_de, name): de_state for name in _de.__all__
                     if not name.endswith("State") and name != "select_rand_indices"})


def _as_tensor(array: Any, device: torch.device, dtype: Any = None) -> torch.Tensor:
    t = torch.from_numpy(np.array(array))
    return t.to(device=device, dtype=dtype or t.dtype)


def algorithm_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """The port's state for ``algo`` from the JAX package's state of the
    same algorithm (numpy leaves), by the carry-over of its class: the
    functions above, the containers' and :func:`guarded_state`."""
    if isinstance(algo, GuardedAlgorithm):
        return guarded_state(algo, jax_state, seed)
    if isinstance(algo, ShardedES):
        return sharded_es_state(algo, jax_state, seed)
    if isinstance(algo, (_containers.ClusteredAlgorithm, _containers.RandomMaskAlgorithm,
                         _containers.VectorizedCoevolution, _containers.Coevolution,
                         _containers.TreeAlgorithm)):
        return container_state(algo, jax_state, seed)
    carry = _ALGO_STATES.get(type(algo))
    if carry is None and isinstance(algo, SwarmAlgorithm):
        carry = swarm_state
    if carry is None:
        raise NotImplementedError(f"no carry-over for {type(algo).__name__} yet")
    return carry(algo, jax_state, seed)


def stacked_members(algo: Any, jax_stacked: Any, n: int, seed: int = 0) -> Any:
    """The port's stacked state of ``n`` members of ``algo`` from the JAX
    package's member states stacked on a leading axis (``vmap(init)``'s
    form: island states, cluster and block states, tenants), in the same
    layout: every leaf keeps its leading member axis. Each member's leaves
    cross by the carry-over of its class; member ``i``'s seed is
    ``split_seed(seed, n)[i]``."""
    seeds = split_seed(seed, n)
    return stack_states([algorithm_state(algo, _containers.take_state(jax_stacked, i), s)
                         for i, s in enumerate(seeds)])


def container_state(algo: Any, jax_state: Any, seed: int = 0) -> Any:
    """A decomposition container's state from the JAX package's: the
    stacked member states split into the port's tuple; RandomMask's cache
    (``None`` while the count is -1), active clusters and count, and
    co-evolution's best-so-far vector, block fitness, last batch, counter
    and permutation cross; the keys do not (the port's seeds start from
    ``seed``)."""
    s_self, s_members = split_seed(seed)
    if isinstance(algo, _containers.TreeAlgorithm):  # a tuple of unstacked states
        return tuple(algorithm_state(a, st, sd) for a, st, sd in
                     zip(algo.inner, jax_state, split_seed(s_members, len(algo.inner))))
    if isinstance(algo, _containers.ClusteredAlgorithm):
        return stacked_members(algo.base, jax_state, algo.num_clusters, s_members)
    dev = algo.base.device
    if isinstance(algo, _containers.RandomMaskAlgorithm):
        count = int(np.asarray(jax_state.count))
        return _containers.RandomMaskState(
            sub_states=stacked_members(algo.base, jax_state.sub_states, algo.num_clusters,
                                       s_members),
            sub_pops=None if count == -1 else _as_tensor(jax_state.sub_pops, dev, torch.float32),
            active=tuple(int(i) for i in np.asarray(jax_state.active)),
            count=count,
            seed=s_self,
        )
    perm = jax_state.permutation
    return _containers.CoevolutionState(
        sub_states=stacked_members(algo.base, jax_state.sub_states, algo.num_subpops, s_members),
        best_dec=_as_tensor(jax_state.best_dec, dev, torch.float32),
        best_fit=_as_tensor(jax_state.best_fit, dev, torch.float32),
        coop_pops=_as_tensor(jax_state.coop_pops, dev, torch.float32),
        iter_counter=int(np.asarray(jax_state.iter_counter)),
        permutation=None if perm is None else _as_tensor(perm, dev, torch.int64),
        seed=s_self,
    )


def guarded_state(algo: GuardedAlgorithm, jax_state: Any, seed: int = 0) -> GuardedState:
    """``GuardedState`` from the JAX package's (numpy leaves): the inner
    state through :func:`algorithm_state`, the candidate buffer, best-so-far
    and the counters (as host integers); the restart key does not cross
    (the port's restart seed is ``fold_in_seed(seed, 0x6A72)``, as
    ``init`` derives it)."""
    fresh = algo.init(seed)
    dev = fresh.best_fitness.device
    as_t = lambda a: None if a is None else tree_map(lambda x: _as_tensor(x, dev), a)
    return fresh.replace(
        inner=algorithm_state(algo.algorithm, jax_state.inner, seed),
        pop=as_t(jax_state.pop),
        best_x=as_t(jax_state.best_x),
        best_fitness=_as_tensor(jax_state.best_fitness, dev, torch.float32),
        **{name: int(np.asarray(getattr(jax_state, name)))
           for name in ("stagnation", "restarts", "checked_restarts", "last_trigger")},
        pop_size=int(jax_state.pop_size),
    )


def numpy_fields(state: Any) -> Any:
    """A port state carried back as plain data, field by field: tensors as
    numpy arrays, nested states as dicts, tuples and dicts walked, host
    values unchanged. What the JAX side's ``state.replace(**fields)`` takes
    (after ``jnp.asarray`` of the arrays), e.g. to hand a port
    ``GuardedState``'s counters and best-so-far to the JAX package. A
    ``bfloat16`` tensor comes back as its ``uint16`` bit pattern."""
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu()
        if state.dtype == torch.bfloat16:
            return state.view(torch.int16).numpy().view(np.uint16)
        return state.numpy()
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: numpy_fields(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: numpy_fields(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(numpy_fields(v) for v in state)
    return state


def island_workflow_state(wf: IslandWorkflow, jax_state: Any, seed: int = 0,
                          prob_state: Optional[Any] = None) -> IslandWorkflowState:
    """``IslandWorkflowState`` from the JAX package's (numpy leaves): the
    generation, the first-step flag and the island-stacked ``algo``, split
    into the port's per-island states (:func:`stacked_members`); the
    problem and monitor states are the port's own, seeded from ``seed`` (or
    ``prob_state`` for the problem)."""
    fresh = wf.init(seed)
    return fresh.replace(
        generation=int(np.asarray(jax_state.generation)),
        algo=stacked_members(wf.algorithm, jax_state.algo, wf.n_islands, split_seed(seed, 1)[0]),
        prob=fresh.prob if prob_state is None else prob_state,
        first_step=bool(jax_state.first_step),
    )
