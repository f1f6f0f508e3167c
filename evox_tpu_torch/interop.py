"""Carry state from the JAX package into the port.

The functions here take the JAX package's states *as numpy arrays* — e.g.
``jax.tree.map(numpy.asarray, state)`` on the JAX side — and build the
port's states from them, so both packages can start from the same point.
They read attributes by name and never import the JAX package.

What crosses unchanged: OpenES centers, the optimizer state (sgd's is
empty; adam's holds count, mu and nu), the GA-skeleton MO states
(population, fitness, offspring; NSGA-II's rank and crowd too), the CSO
and PSO-family states (every field the two states share by name), the
EvalMonitor state, the states of the rest of the ES family (CMA-ES,
PGPE and the others, through ``es_state``; the ClipUp velocity too), the
DE family's (``de_state``: archives, memories and the ``attrib``
attribution included), LES's state (``les_state``) and its flax
parameter tree (``les_params``), the
decomposition and reference-vector MOEAs' states (MOEA/D and its
variants, EAG-MOEA/D, RVEA, RVEAa, LMOCSO; NSGA-III and TDEA through
``mo_state``), the workflow's generation and first-step flag,
populations and genomes as ``(pop, dim)`` arrays, and ``mlp_policy``
params trees.

Constants an algorithm builds in its constructor can be replaced by the
JAX package's where a float tie decides them: ``set_neighbors`` (MOEA/D's
neighbour table, and its variants') and ``set_reference_vectors``
(NSGA-III's, TDEA's, RVEA's, LMOCSO's unit reference directions and
MOEA/D-M2M's subregion directions).

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

from .algorithms import mo as _mo
from .algorithms.mo.common import GAMOAlgorithm, MOState
from .algorithms.mo.nsga2 import NSGA2, NSGA2State
from .algorithms.so import de as _de
from .algorithms.so import es as _es
from .algorithms.so.es import les_meta as _les_meta
from .algorithms.so.es.open_es import OpenES, OpenESState
from .algorithms.so.pso.common import SwarmAlgorithm
from .core.device import DeviceLike, resolve_device
from .monitors.eval_monitor import EvalMonitor, EvalMonitorState
from .utils.common import split_seed, tree_map
from .utils.optimizers import SGD, Adam, AdamState, ClipUp, ClipUpState
from .workflows.std import StdWorkflow, StdWorkflowState


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


def _adam_leaf(opt_state: Any) -> Any:
    """optax's ScaleByAdamState inside an adam chain state."""
    for part in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        if all(hasattr(part, name) for name in ("count", "mu", "nu")):
            return part
    raise ValueError("no adam (count, mu, nu) state in the given optimizer state")


def optimizer_state(optimizer: Any, opt_state: Any, device: torch.device) -> Any:
    """The port's optimizer state for ``optimizer`` from an optax state."""
    if isinstance(optimizer, SGD):
        return ()
    if isinstance(optimizer, ClipUp):
        velocity = opt_state.velocity
        return ClipUpState(velocity=torch.from_numpy(np.array(velocity, dtype=np.float32)).to(device))
    if isinstance(optimizer, Adam):
        leaf = _adam_leaf(opt_state)
        as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        return AdamState(count=int(np.asarray(leaf.count)), mu=as_t(leaf.mu), nu=as_t(leaf.nu))
    raise NotImplementedError(f"no carry-over for {type(optimizer).__name__}")


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
        theirs = np.asarray(theirs)
        if theirs.shape != tuple(ours.shape):
            raise ValueError(f"{name} has shape {theirs.shape}, expected {tuple(ours.shape)}")
        return torch.from_numpy(np.array(theirs)).to(device=ours.device, dtype=ours.dtype)
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
    carry = _ALGO_STATES.get(type(wf.algorithm))
    if carry is None and isinstance(wf.algorithm, SwarmAlgorithm):
        carry = swarm_state
    if carry is None:
        raise NotImplementedError(
            f"no carry-over for {type(wf.algorithm).__name__} yet"
        )
    fresh = wf.init(seed)
    algo_seed = split_seed(seed, 1)[0]
    return fresh.replace(
        generation=int(np.asarray(jax_state.generation)),
        algo=carry(wf.algorithm, jax_state.algo, algo_seed),
        prob=fresh.prob if prob_state is None else prob_state,
        first_step=bool(jax_state.first_step),
    )


# algorithm class -> the carry-over of its state
_ALGO_STATES = {OpenES: open_es_state, NSGA2: nsga2_state}
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
