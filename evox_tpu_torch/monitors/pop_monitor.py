"""PopMonitor — the algorithm's whole population and fitness every
generation; the port of ``evox_tpu/monitors/pop_monitor.py``.

The history is unbounded, so it lives on the host. The JAX package streams
it out of the compiled step with an ordered ``io_callback``; here
``post_step`` queues a copy of the two fields into pinned host memory
(non-blocking, one CUDA event after the copies) and returns without
waiting, so no generation blocks on a host read. The copies are turned
into numpy arrays at :meth:`PopMonitor.flush`, which every getter calls.
On the CPU the fields are cloned.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.cost import analysing
from ..core.monitor import Monitor


def _queue_copy(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t.detach().clone()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t.detach(), non_blocking=True)
    return buf


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class PopMonitor(Monitor):
    """Records ``state.algo.<population_name>`` and ``<fitness_name>`` after
    every generation; ``fitness_only=True`` skips the decision space. The
    cost analysis's extra run of an entry (``core/cost.py``) records
    nothing."""

    # it reads the host each generation: a fleet (VectorizedWorkflow) refuses it
    uses_host_callbacks = True

    def __init__(
        self,
        population_name: str = "population",
        fitness_name: str = "fitness",
        fitness_only: bool = False,
    ):
        self.population_name = population_name
        self.fitness_name = fitness_name
        self.fitness_only = fitness_only
        self.population_history: list = []
        self.fitness_history: list = []
        # copies queued on the card: (population or None, fitness, event or None)
        self._pending: List[Tuple[Optional[torch.Tensor], torch.Tensor, Any]] = []

    def hooks(self):
        return ("post_step",)

    def post_step(self, mstate: Any, wf_state: Any) -> Any:
        if analysing():
            return mstate
        algo = wf_state.algo
        fitness = getattr(algo, self.fitness_name)
        pop = None if self.fitness_only else _queue_copy(getattr(algo, self.population_name))
        fit = _queue_copy(fitness)
        event = None
        if fitness.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(fitness.device))
        self._pending.append((pop, fit, event))
        return mstate

    def flush(self) -> None:
        """Wait for the queued copies and move them into the histories."""
        pending, self._pending = self._pending, []
        for pop, fit, event in pending:
            if event is not None:
                event.synchronize()
            if pop is not None:
                self.population_history.append(_numpy(pop))
            self.fitness_history.append(_numpy(fit))

    # --------------------------------------------------------------- getters
    def get_latest_fitness(self) -> np.ndarray:
        self.flush()
        return self.fitness_history[-1]

    def get_latest_population(self) -> np.ndarray:
        self.flush()
        return self.population_history[-1]

    def get_population_history(self) -> list:
        self.flush()
        return self.population_history

    def get_fitness_history(self) -> list:
        self.flush()
        return self.fitness_history

    def plot(self, problem_pf: Optional[Any] = None, **kwargs):
        """The objective space over the generations through
        ``vis_tools.plot`` (matplotlib; ``animated=True`` for an
        animation): curves for one objective, a scatter for two or three.
        ``None``, with a warning, when nothing was recorded or the
        objectives are more than three."""
        self.flush()
        if not self.fitness_history:
            warnings.warn("no fitness history recorded, returning None")
            return None
        from ..vis_tools import plot

        n_objs = 1 if self.fitness_history[0].ndim == 1 else self.fitness_history[0].shape[1]
        if n_objs == 1:
            return plot.plot_obj_space_1d(self.fitness_history, **kwargs)
        if n_objs == 2:
            return plot.plot_obj_space_2d(self.fitness_history, problem_pf, **kwargs)
        if n_objs == 3:
            return plot.plot_obj_space_3d(self.fitness_history, problem_pf, **kwargs)
        warnings.warn(f"plotting {n_objs}-objective space is not supported")
        return None
