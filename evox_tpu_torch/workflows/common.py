"""Plumbing shared by the workflow implementations — the port of parts of
``evox_tpu/workflows/common.py``.

:class:`HostLink` and :func:`host_evaluate` are the counterpart of the
JAX package's ``callback_evaluate``: a host problem's candidates go to the
host as numpy, its ``evaluate`` runs there, and its fitness comes back as
a tensor on the workflow's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.monitor import HOOK_NAMES, Monitor
from ..utils.common import tree_flatten
from ..utils.io import to_x32_if_needed


def build_hook_table(monitors: Sequence[Monitor]) -> Dict[str, Tuple[int, ...]]:
    """name -> indices of the monitors implementing that hook."""
    return {
        name: tuple(i for i, m in enumerate(monitors) if name in m.hooks())
        for name in HOOK_NAMES
    }


def run_hooks(
    monitors: Sequence[Monitor],
    table: Dict[str, Tuple[int, ...]],
    name: str,
    mstates: list,
    *args: Any,
) -> None:
    """Dispatch one hook across monitors, updating ``mstates`` in place."""
    for i in table[name]:
        mstates[i] = getattr(monitors[i], name)(mstates[i], *args)


def finish_step(
    monitors: Sequence[Monitor],
    table: Dict[str, Tuple[int, ...]],
    new_state: Any,
) -> Any:
    """Run the ``post_step`` hooks against the otherwise-final workflow
    state, then fold their updated states back in."""
    mstates = list(new_state.monitors)
    run_hooks(monitors, table, "post_step", mstates, new_state)
    return new_state.replace(monitors=tuple(mstates))


def refuse_deferred(where: str, item: str, **arguments: Any) -> None:
    """Raise for each argument given whose port waits for the ROADMAP
    ``item`` that names it (``None`` and ``False`` mean not given)."""
    for name, value in arguments.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet (ROADMAP {item})"
            )


def check_mesh(mesh: Any, algorithm: Any, device: Any, external: bool, eval_shard_map: bool,
               allow_uneven_shards: bool) -> None:
    """A workflow's mesh arguments, checked as the JAX package checks them:
    ``eval_shard_map`` needs a mesh and a problem on the device; a host
    problem cannot run under a mesh that spans processes; the population
    must divide over the ``"pop"`` axis unless ``allow_uneven_shards``
    (never with ``eval_shard_map``); the mesh's first device is the
    workflow's."""
    from ..core.distributed import POP_AXIS, mesh_spans_processes, require_single_process

    if eval_shard_map and (mesh is None or external):
        raise ValueError("eval_shard_map requires a mesh and a problem on the device")
    if mesh is None:
        return
    if external and mesh_spans_processes(mesh):
        raise ValueError(
            "external (host) problems are single-process: under a mesh that spans processes "
            "each process would call the host evaluate on its own shard against "
            "unsynchronized host state; use a problem on the device for mesh parallelism")
    require_single_process(mesh, "a workflow's mesh")
    if mesh.controller.type != device.type:
        raise ValueError(f"the mesh's first device is {mesh.controller}, the workflow's {device}")
    n_shards = mesh.shape.get(POP_AXIS, 1)
    pop_size = getattr(algorithm, "pop_size", None)
    if pop_size is not None and pop_size % n_shards and (eval_shard_map or not allow_uneven_shards):
        raise ValueError(
            f"pop_size {pop_size} is not divisible by the mesh's 'pop' axis ({n_shards} "
            "shards); pad the population, resize the mesh, or pass allow_uneven_shards=True "
            "to accept unequal blocks")


def shard_map_evaluate(problem: Any, mesh: Any, pstate: Any, cand: Any) -> Tuple[Any, Any]:
    """``eval_shard_map``'s evaluation: each shard scores its block of the
    candidates on its own device (the problem state replicated in), and the
    fitness is gathered in mesh order; the problem state comes back
    unchanged (the problem must be stateless or pure, as in the JAX
    package)."""
    from ..core.distributed import POP_AXIS, P, shard_map
    from ..utils.common import tree_flatten

    n_cand = next(x for x in tree_flatten(cand)[0] if isinstance(x, torch.Tensor)).shape[0]
    n_shards = mesh.shape.get(POP_AXIS, 1)
    if n_cand % n_shards:
        raise ValueError(
            f"eval_shard_map: the evaluated candidate batch ({n_cand}) is not divisible by the "
            f"mesh's 'pop' axis ({n_shards} shards); evaluate without eval_shard_map for this "
            "algorithm or resize the population or the mesh")
    fitness = shard_map(lambda c: problem.evaluate(pstate, c)[0], mesh, (P(POP_AXIS),),
                        P(POP_AXIS))(cand)
    return fitness, pstate


def fused_run(wf: Any, state: Any, n_steps: int) -> Any:
    """Shared ``run()`` body: ``n_steps`` generations as a plain Python loop.
    The JAX package fuses them into one compiled ``fori_loop``
    (``make_run_loop``) after peeling the first generation through
    ``wf.step`` when the state is fresh or the carries are donated; the
    port peels the same generation through ``wf.step`` and runs the rest
    through :func:`step_loop`, so a recorder on ``step``
    (``core/instrument.py``) counts the calls the JAX package's counts.
    Capturing the loop as a CUDA graph is later work (ROADMAP A3)."""
    if n_steps <= 0:
        return state
    if state.first_step or getattr(wf, "donate_carries", False):
        state = wf.step(state)
        n_steps -= 1
    return step_loop(wf, state, n_steps)


def step_loop(wf: Any, state: Any, n_steps: int) -> Any:
    """``n_steps`` generations of ``wf._step_impl``: the loop body of
    ``run``, the counterpart of the JAX package's ``wf._run_loop``."""
    for _ in range(n_steps):
        state = wf._step_impl(state)
    return state


def ingest_fitness(
    wf: Any,
    astate: Any,
    mstates: list,
    fitness: torch.Tensor,
    use_init: bool,
) -> Any:
    """The tell half once the fitness is final (sign-flipped, quarantined):
    fit_transforms → pre_tell hook → ``init_tell``/``tell`` dispatch → the
    workflow's ``migrate_helper``, polled once a generation: when its
    ``do_migrate`` holds, the algorithm's ``migrate`` takes the foreign
    rows, their fitness sign-flipped to the internal minimisation (never
    fit-transformed). ``do_migrate`` is read on the host (the JAX package's
    ``lax.cond``)."""
    for t in wf.fit_transforms:
        fitness = t(fitness)
    run_hooks(wf.monitors, wf._hook_table, "pre_tell", mstates, fitness)
    if use_init:
        astate = wf.algorithm.init_tell(astate, fitness)
    else:
        astate = wf.algorithm.tell(astate, fitness)
    helper = getattr(wf, "migrate_helper", None)
    if helper is not None:
        do_migrate, foreign_pop, foreign_fit = helper()
        if bool(do_migrate):
            astate = wf.algorithm.migrate(astate, foreign_pop, wf._flip(foreign_fit))
    return astate


def quarantine_nonfinite(fitness: torch.Tensor) -> torch.Tensor:
    """Replace non-finite fitness entries with the worst FINITE value of the
    batch (internal minimization convention: the per-objective max). A
    column with no finite entry falls back to the dtype's largest finite
    value. Shape-preserving."""
    finite = torch.isfinite(fitness)
    neg_inf = torch.full_like(fitness, float("-inf"))
    worst = torch.amax(torch.where(finite, fitness, neg_inf), dim=0)
    big = torch.full_like(worst, torch.finfo(fitness.dtype).max)
    worst = torch.where(torch.isfinite(worst), worst, big)
    return torch.where(finite, fitness, worst)


class HostLink:
    """Copies between a workflow's device and a host problem.

    ``to_host`` copies the candidates (a tensor or a tree of them) into
    pinned host memory without blocking and records a CUDA event after the
    copies; the thread that evaluates waits on the event, and sees numpy
    arrays that view the pinned memory. Each generation takes fresh blocks
    from PyTorch's caching host allocator, which hands a block out again
    only when nothing holds it any more and the copies recorded on it have
    finished: a block that a copy is still writing, or that a problem
    still reads, is never reused (in a steady loop two blocks take turns).
    ``to_device`` coerces the fitness through ``to_x32_if_needed`` and
    copies it to the device through a pinned block. On the CPU the
    candidates are copied into fresh numpy arrays and no event is
    recorded.

    The bytes each way and the copies' device times (CUDA events) are
    counted; :meth:`report` sums them up.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.counts = {"d2h": 0, "h2d": 0, "d2h_bytes": 0, "h2d_bytes": 0}
        self._times = {"d2h": 0.0, "h2d": 0.0}
        self._open: List[Tuple[str, Any, Any]] = []  # copies whose time is not read yet

    def _event(self) -> Optional[torch.cuda.Event]:
        if not self.pinned:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _close_timed(self, wait: bool = False) -> None:
        still = []
        for kind, start, end in self._open:
            if wait:
                end.synchronize()
            if end.query():
                self._times[kind] += start.elapsed_time(end)
            else:
                still.append((kind, start, end))
        self._open = still

    def to_host(self, cand: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
        """``(numpy candidates, event)``; the event is ``None`` on the CPU."""
        leaves, rebuild = tree_flatten(cand)
        self.counts["d2h"] += 1
        self.counts["d2h_bytes"] += sum(t.numel() * t.element_size() for t in leaves)
        if not self.pinned:
            return rebuild([t.detach().cpu().numpy().copy() for t in leaves]), None
        self._close_timed()
        start = self._event()
        host = []
        for t in leaves:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t.detach(), non_blocking=True)
            host.append(buf.numpy())
        end = self._event()
        self._open.append(("d2h", start, end))
        return rebuild(host), end

    def to_device(self, fitness: Any) -> torch.Tensor:
        """A host array (numpy, or a tensor) as a tensor on the device,
        64-bit numpy coerced to 32 bits first: a host problem's fitness, a
        supervised problem's batch leaf."""
        if isinstance(fitness, torch.Tensor):
            return fitness.to(self.device)
        arr = to_x32_if_needed(np.asarray(fitness))
        # ascontiguousarray makes a 0-d array 1-d: keep the shape
        host = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
        self.counts["h2d"] += 1
        self.counts["h2d_bytes"] += host.numel() * host.element_size()
        if not self.pinned:
            return host.clone()
        start = self._event()
        buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        buf.copy_(host)
        out = buf.to(self.device, non_blocking=True)
        self._open.append(("h2d", start, self._event()))
        return out

    def report(self) -> dict:
        """Copies, bytes and device ms each way (a card waits for the copies
        still in flight), and whether the host buffers are pinned."""
        self._close_timed(wait=True)
        out = {"pinned": self.pinned, **self.counts}
        for kind in ("d2h", "h2d"):
            out[f"{kind}_ms"] = self._times[kind] if self.pinned else None
        return out


def host_candidates(link: HostLink, cand: Any) -> Any:
    """The candidates as numpy on the host, once their copy has landed."""
    host, ready = link.to_host(cand)
    if ready is not None:
        ready.synchronize()
    return host


def host_evaluate(problem: Any, link: HostLink, pstate: Any, cand: Any,
                  eval_chunk: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """One synchronous host evaluation (``wf.step`` with a host problem):
    candidates to the host, ``evaluate`` (in row slices of ``eval_chunk``),
    fitness back to the device. External problems are stateless from the
    device's side: the state passes through and any host update lives on
    the problem object."""
    from .pipelined import chunked_evaluate

    fitness, _ = chunked_evaluate(problem, pstate, host_candidates(link, cand), eval_chunk)
    return link.to_device(fitness), pstate
