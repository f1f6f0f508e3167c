"""ODE, Opposition-based Differential Evolution (Rahnamayan et al. 2008) —
the port of ``evox_tpu/algorithms/so/de/ode.py``.

DE plus opposition-based generation jumping: when the generation's
uniform falls below ``jumping_rate`` it proposes the opposition population
(the population's own per-coordinate bounds) instead of DE trials. Both
are computed and the choice is one ``torch.where`` on the card: no host
read of the uniform.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ....utils.common import generator, split_seed
from .de import DE, DEState


class ODE(DE):
    def __init__(self, *args, jumping_rate: float = 0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self.jumping_rate = jumping_rate

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """DE's draws and ``u_jump``, a 0-dim uniform."""
        s_jump, s_mut = split_seed(seed)
        u_jump = torch.rand((), generator=generator(s_jump, self.device), device=self.device)
        return {**super()._draw(s_mut), "u_jump": u_jump}

    def ask(self, state: DEState) -> Tuple[torch.Tensor, DEState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop = state.population
        opposite = torch.amin(pop, dim=0) + torch.amax(pop, dim=0) - pop
        trials = torch.where(draws["u_jump"] < self.jumping_rate, opposite,
                             self._mutate(state, draws))
        return trials, state.replace(trials=trials, seed=seed)
