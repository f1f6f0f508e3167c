"""EvalMonitor — elite and Pareto-front tracking; the port of
``evox_tpu/monitors/eval_monitor.py``.

The elite top-k buffer and the fixed-capacity Pareto archive are device
tensors in the monitor's state, updated without a host read:

- single objective: the ``topk`` smallest keys (fitness in the
  minimisation direction) of the previous elite and the new batch, by
  :func:`~evox_tpu_torch.kernels.topk.partial_topk` — the CUDA kernel on
  the card — which computes ``lax.top_k(-key, topk)`` exactly, ties to
  the lowest index;
- multi-objective: non-dominated sort of the previous archive and the new
  batch (``packed_dominance``, the CUDA kernel on the card), then the
  best (rank, -crowding) rows, with every row that is not a finite rank-0
  member inf-padded behind the live ones.

The elite and the archive store fitness in the user's direction. The
opt-in unbounded histories (``full_fit_history``/``full_sol_history``) are
host lists of CPU tensors, appended directly (the JAX package streams them
through a host callback); ``history_capacity=K`` keeps the last ``K``
generations in a device ring.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..core.device import DeviceLike, check_device, resolve_device
from ..core.monitor import Monitor
from ..core.struct import PyTreeNode
from ..kernels.topk import partial_topk
from ..operators.selection.non_dominate import crowding_distance, non_dominated_sort
from ..utils.common import lexsort, tree_flatten, tree_map
from .common import ring_slots, ring_write

INF = float("inf")


def _tree_map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    leaves_a, rebuild = tree_flatten(a)
    leaves_b, _ = tree_flatten(b)
    return rebuild([fn(x, y) for x, y in zip(leaves_a, leaves_b)])


def _pad_rows(x: torch.Tensor, width: int, value: float) -> torch.Tensor:
    n = x.shape[0]
    if n == width:
        return x
    return torch.cat([x, x.new_full((width - n,) + tuple(x.shape[1:]), value)])


class EvalMonitorState(PyTreeNode):
    topk_fitness: Optional[torch.Tensor] = None  # (k,) or (cap, m), user direction
    topk_solution: Any = None
    pf_count: Optional[torch.Tensor] = None  # () int32, multi-objective only
    # the device history ring (history_capacity > 0)
    hist_fit: Optional[torch.Tensor] = None  # (K, width[, m]) inf-padded
    hist_sol: Any = None  # (K, width, ...) with history_solutions
    hist_len: Optional[torch.Tensor] = None  # (K,) int32 valid rows of each slot
    hist_count: Optional[int] = None  # generations seen


class EvalMonitor(Monitor):
    """Tracks the best-so-far individuals seen at evaluation time.

    Single objective: a ``topk`` elite buffer. Multi-objective: a running
    Pareto archive of capacity ``pf_capacity`` (``multi_obj=True``).

    Generation history: ``full_fit_history``/``full_sol_history`` keep
    every generation on the host; ``history_capacity=K`` keeps the last
    ``K`` generations' fitness (and solutions, with
    ``history_solutions=True``) in a device ring, each slot with its true
    batch width (CSO's full-then-half batches read back exactly). The ring
    is sized by the first generation's batch; a wider one raises.

    ``device``: where the buffers live; ``None`` means ``"cuda"``. Fitness
    is float32: the elite goes through ``partial_topk``.
    """

    def __init__(
        self,
        topk: int = 1,
        multi_obj: bool = False,
        pf_capacity: int = 1024,
        full_fit_history: bool = False,
        full_sol_history: bool = False,
        history_capacity: int = 0,
        history_solutions: bool = False,
        device: DeviceLike = None,
    ):
        if history_solutions and not history_capacity:
            raise ValueError("history_solutions requires history_capacity > 0")
        self.device = resolve_device(device)
        self.topk = topk
        self.multi_obj = multi_obj
        self.pf_capacity = pf_capacity
        self.full_fit_history = full_fit_history
        # unbounded histories grow on the host: a fleet refuses them
        self.uses_host_callbacks = bool(full_fit_history or full_sol_history)
        self.full_sol_history = full_sol_history
        self.history_capacity = history_capacity
        self.history_solutions = history_solutions
        self.fitness_history: list = []
        self.solution_history: list = []
        self.opt_direction = torch.ones((1,), device=self.device)

    def hooks(self):
        return ("post_eval",)

    def init(self, seed: Optional[int] = None) -> EvalMonitorState:
        # the buffers take their shapes from the first post_eval
        return EvalMonitorState()

    # ------------------------------------------------------------------ hook
    def post_eval(self, mstate: EvalMonitorState, cand: Any, fitness: torch.Tensor) -> EvalMonitorState:
        check_device(fitness, self.device, "fitness")
        if self.full_fit_history:
            self.fitness_history.append(fitness.detach().cpu())
        if self.full_sol_history:
            self.solution_history.append(tree_map(lambda x: x.detach().cpu(), cand))
        hist = {}
        if self.history_capacity:
            hist = self._update_device_history(mstate, cand, fitness)
        if fitness.ndim == 1 and not self.multi_obj:
            return self._update_so(mstate, cand, fitness).replace(**hist)
        return self._update_mo(mstate, cand, fitness).replace(**hist)

    # ------------------------------------------------------ device history
    def _update_device_history(self, mstate: EvalMonitorState, cand: Any, fitness: torch.Tensor) -> dict:
        K = self.history_capacity
        if mstate.hist_fit is None:
            width = fitness.shape[0]
            hist_fit = fitness.new_full((K, width) + tuple(fitness.shape[1:]), INF)
            hist_sol = (
                tree_map(lambda x: x.new_zeros((K, width) + tuple(x.shape[1:])), cand)
                if self.history_solutions else None
            )
            hist_len = torch.zeros((K,), dtype=torch.int32, device=fitness.device)
            count = 0
        else:
            hist_fit, hist_sol = mstate.hist_fit, mstate.hist_sol
            hist_len, count = mstate.hist_len, mstate.hist_count
            width = hist_fit.shape[1]
        n = fitness.shape[0]
        if n > width:
            raise ValueError(
                f"history ring buffer was sized by the first generation "
                f"(batch {width}); cannot record a larger batch ({n}). "
                "Evaluate the widest batch first or disable history_capacity."
            )
        hist_fit = ring_write(hist_fit, _pad_rows(fitness, width, INF), count)
        if hist_sol is not None:
            hist_sol = _tree_map2(lambda buf, c: ring_write(buf, _pad_rows(c, width, 0), count),
                                  hist_sol, cand)
        return dict(
            hist_fit=hist_fit,
            hist_sol=hist_sol,
            hist_len=ring_write(hist_len, n, count),
            hist_count=count + 1,
        )

    # ---------------------------------------------------------- elite / PF
    def _update_so(self, mstate: EvalMonitorState, cand: Any, fitness: torch.Tensor) -> EvalMonitorState:
        sign = self.opt_direction[0]
        key_fit = fitness * sign  # minimise internally
        if mstate.topk_fitness is None:  # the first generation merges nothing
            merged_key, merged_fit, merged_sol = key_fit, fitness, cand
        else:
            merged_key = torch.cat([mstate.topk_fitness * sign, key_fit])
            merged_fit = torch.cat([mstate.topk_fitness, fitness])
            merged_sol = _tree_map2(lambda a, b: torch.cat([a, b]), mstate.topk_solution, cand)
        _, idx = partial_topk(merged_key, self.topk, device=merged_key.device)
        return EvalMonitorState(
            topk_fitness=merged_fit[idx],
            topk_solution=tree_map(lambda x: x[idx], merged_sol),
        )

    def _update_mo(self, mstate: EvalMonitorState, cand: Any, fitness: torch.Tensor) -> EvalMonitorState:
        cap = self.pf_capacity
        key_fit = fitness * self.opt_direction
        if mstate.topk_fitness is None:
            prev_fit = fitness.new_full((cap,) + tuple(fitness.shape[1:]), INF)
            prev_sol = tree_map(lambda x: x.new_zeros((cap,) + tuple(x.shape[1:])), cand)
        else:
            prev_fit = mstate.topk_fitness * self.opt_direction
            prev_sol = mstate.topk_solution
        merged_fit = torch.cat([prev_fit, key_fit])
        merged_sol = _tree_map2(lambda a, b: torch.cat([a, b]), prev_sol, cand)
        # rank once on the merged set, keep the best (rank, -crowding) rows,
        # then inf-pad every row that is not a FINITE rank-0 member: one
        # liveness criterion drives the padding, the count and get_pf_mask
        rank = non_dominated_sort(merged_fit, until=cap)
        worst = torch.sort(rank).values[cap - 1]
        crowd = crowding_distance(merged_fit, mask=rank == worst)
        order = lexsort([-crowd, rank])[:cap]
        sel_fit = merged_fit[order]
        live = (rank[order] == 0) & torch.all(torch.isfinite(sel_fit), dim=-1)
        # stable re-sort so live rows lead (a finite rank-0 block can be
        # interrupted by an inf-coordinate row)
        reorder = torch.argsort((~live).to(torch.uint8), stable=True)
        sel_fit = torch.where(live[reorder][:, None], sel_fit[reorder], INF)
        return EvalMonitorState(
            topk_fitness=sel_fit * self.opt_direction,  # store the user direction
            topk_solution=tree_map(lambda x: x[order][reorder], merged_sol),
            pf_count=torch.sum(live, dtype=torch.int32),
        )

    # --------------------------------------------------------------- getters
    def get_best_fitness(self, mstate: EvalMonitorState) -> torch.Tensor:
        return mstate.topk_fitness[0]

    def get_topk_fitness(self, mstate: EvalMonitorState) -> torch.Tensor:
        return mstate.topk_fitness

    def get_best_solution(self, mstate: EvalMonitorState) -> Any:
        return tree_map(lambda x: x[0], mstate.topk_solution)

    def get_topk_solutions(self, mstate: EvalMonitorState) -> Any:
        return mstate.topk_solution

    def get_pf_mask(self, mstate: EvalMonitorState) -> torch.Tensor:
        """(pf_capacity,) bool: which archive rows hold real front members."""
        return torch.all(torch.isfinite(mstate.topk_fitness), dim=-1)

    def get_pf_fitness(self, mstate: EvalMonitorState) -> torch.Tensor:
        """The archive's live rows (one host read of ``pf_count``)."""
        return mstate.topk_fitness[: int(mstate.pf_count)]

    def get_pf_solutions(self, mstate: EvalMonitorState) -> Any:
        n = int(mstate.pf_count)
        return tree_map(lambda x: x[:n], mstate.topk_solution)

    def get_fitness_history(self) -> list:
        return self.fitness_history

    def get_solution_history(self) -> list:
        return self.solution_history

    # ----------------------------------------- device-history ring getters
    def _ring_slots(self, mstate: EvalMonitorState) -> list:
        return ring_slots(mstate.hist_count, self.history_capacity)

    def get_device_fitness_history(self, mstate: EvalMonitorState) -> list:
        """The last ``min(count, history_capacity)`` generations' fitness,
        oldest first, each sliced to its true batch width."""
        if mstate.hist_fit is None:
            return []
        return [mstate.hist_fit[s][: int(mstate.hist_len[s])] for s in self._ring_slots(mstate)]

    def get_device_solution_history(self, mstate: EvalMonitorState) -> list:
        if mstate.hist_sol is None:
            return []
        return [
            tree_map(lambda x: x[s][: int(mstate.hist_len[s])], mstate.hist_sol)
            for s in self._ring_slots(mstate)
        ]
