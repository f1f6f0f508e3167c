"""Monitor hook specification — the port of ``evox_tpu/core/monitor.py``.

The same 8 hooks, in the same order. Each hook receives the monitor state
plus step data and returns the updated monitor state; a monitor declares
which hooks it implements through ``hooks()`` so the workflow wires only
those.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

MonitorState = Any

HOOK_NAMES = (
    "pre_step",
    "pre_ask",
    "post_ask",
    "pre_eval",
    "post_eval",
    "pre_tell",
    "post_tell",
    "post_step",
)


class Monitor:
    """Base monitor. Subclasses override ``init``, ``hooks`` and hook methods.

    Hook signatures (all return the new monitor state):

    - ``pre_step(mstate)``
    - ``pre_ask(mstate)``
    - ``post_ask(mstate, cand)``
    - ``pre_eval(mstate, cand)``
    - ``post_eval(mstate, cand, fitness)`` — fitness in the *user's*
      direction convention (before the ``opt_direction`` flip).
    - ``pre_tell(mstate, transformed_fitness)``
    - ``post_tell(mstate)``
    - ``post_step(mstate, workflow_state)``
    """

    def init(self, seed: Optional[int] = None) -> MonitorState:
        return None

    def hooks(self) -> Sequence[str]:
        """Names of the hooks this monitor implements."""
        raise NotImplementedError

    def set_opt_direction(self, opt_direction: torch.Tensor) -> None:
        """Called once by the workflow with the ±1 direction vector."""
        self.opt_direction = opt_direction

    # -- hooks (default: identity) ------------------------------------------
    def pre_step(self, mstate: MonitorState) -> MonitorState:
        return mstate

    def pre_ask(self, mstate: MonitorState) -> MonitorState:
        return mstate

    def post_ask(self, mstate: MonitorState, cand: Any) -> MonitorState:
        return mstate

    def pre_eval(self, mstate: MonitorState, cand: Any) -> MonitorState:
        return mstate

    def post_eval(self, mstate: MonitorState, cand: Any, fitness: torch.Tensor) -> MonitorState:
        return mstate

    def pre_tell(self, mstate: MonitorState, fitness: torch.Tensor) -> MonitorState:
        return mstate

    def post_tell(self, mstate: MonitorState) -> MonitorState:
        return mstate

    def post_step(self, mstate: MonitorState, wf_state: Any) -> MonitorState:
        return mstate
