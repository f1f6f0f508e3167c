"""SRA (Li, Yang & Liu 2016): stochastic-ranking based many-objective EA
with two indicators, the additive epsilon (IBEA's) and the shift-based
density (SDE) — the port of ``evox_tpu/algorithms/mo/sra.py``.

Selection ranks the merged rows by ``sweeps`` odd-even transposition
passes (pop_size of them by default): in each pass every pair compares its
two rows by the epsilon indicator with probability ``pc``, else by SDE,
and the better moves left. The passes run one after another on the device;
the pairs of the two parities are fixed, so they are computed once. Every
draw of a generation comes from one ``_draw`` method: the mating
permutation, the variation's draws, and the selection's ``pc``, starting
permutation and ``(sweeps, n)`` table of per-pass uniforms, which ``ask``
keeps in the state for ``tell``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...core.device import DeviceLike
from ...utils.common import generator
from .common import DrawnGAMOAlgorithm, MOState, draw_variation
from .ibea import ibea_fitness
from .lmocso import sde_density


class SRAState(MOState):
    select_draws: Optional[Dict[str, Any]] = None  # the next tell's pc, perm and sweep uniforms


def sra_indicators(fit: torch.Tensor):
    """``(i_eps, sde)``, both lower = better: the negated IBEA fitness
    (kappa 0.05) and the negated shift-based density."""
    return -ibea_fitness(fit, 0.05), -sde_density(fit)


def stochastic_ranking(i_eps: torch.Tensor, sde: torch.Tensor, perm: torch.Tensor,
                       u: torch.Tensor, pc: Any) -> torch.Tensor:
    """The order after ``u.shape[0]`` odd-even transposition passes from
    ``perm``: pass ``s`` pairs positions ``(2i + s % 2, 2i + 1 + s % 2)``,
    compares by ``i_eps`` where ``u[s, left position] < pc``, else by
    ``sde``, and keeps the smaller value on the left (ties stay)."""
    n = perm.shape[0]
    dev = perm.device
    idx = torch.arange(n, device=dev)
    partners, signs, lefts = [], [], []
    for offset in (0, 1):
        is_left = (idx - offset) % 2 == 0
        partner = torch.where(is_left, idx + 1, idx - 1)
        valid = (idx >= offset) & (partner >= offset) & (partner < n)
        partner = torch.where(valid, partner, idx)
        partners.append(partner)
        lefts.append(torch.minimum(idx, partner))
        # take the partner where (mine - theirs) * sign > 0: the left keeps
        # the smaller, the right the larger; 0 for unpaired positions
        signs.append(torch.where(valid, torch.where(is_left, 1.0, -1.0), 0.0).to(i_eps.dtype))
    sweeps = u.shape[0]
    parity = torch.arange(sweeps, device=dev) % 2
    # each pass's choice of indicator per position, as a flat offset into
    # the stacked (sde, i_eps) values
    use_eps = (u < pc).gather(1, torch.stack(lefts)[parity])
    offsets = use_eps.to(torch.int64) * n
    values = torch.cat([sde, i_eps])
    order = perm
    for s in range(sweeps):
        partner, sign = partners[s % 2], signs[s % 2]
        mine = values[offsets[s] + order]
        take = (mine - mine[partner]) * sign > 0
        order = torch.where(take, order[partner], order)
    return order


class SRA(DrawnGAMOAlgorithm):

    # not under torch.func.vmap: its indicator terms are built through out=
    # arguments; stacked members run one by one
    stackable = False
    def __init__(self, lb: Any, ub: Any, n_objs: int, pop_size: int, pc: Optional[float] = None,
                 sweeps: Optional[int] = None, mesh: Any = None, device: DeviceLike = None):
        super().__init__(lb, ub, n_objs, pop_size, mesh=mesh, device=device)
        # the probability of comparing by the epsilon indicator; None: the
        # paper's draw from U(0.4, 0.6) at every generation
        self.pc = pc
        self.sweeps = sweeps or pop_size

    def init(self, seed: int) -> SRAState:
        base = super().init(seed)
        return SRAState(population=base.population, fitness=base.fitness,
                        offspring=base.offspring, seed=base.seed)

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """``perm_mate`` (the mating shuffle), the variation's draws, and the
        selection's: ``pc`` (a 0-dim uniform in [0.4, 0.6) unless fixed),
        ``perm`` of the merged ``2 pop`` rows and ``u_sweeps`` ``(sweeps, 2
        pop)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        g = generator(seed, dev)
        draws = {"perm_mate": torch.randperm(n, generator=g, device=dev),
                 **draw_variation(g, n // 2, n, d, dev)}
        u_pc = torch.rand((), generator=g, device=dev)
        draws["pc"] = u_pc * 0.2 + 0.4 if self.pc is None else self.pc
        draws["perm"] = torch.randperm(2 * n, generator=g, device=dev)
        draws["u_sweeps"] = torch.rand((self.sweeps, 2 * n), generator=g, device=dev)
        return draws

    def mate_with(self, state: MOState, draws: dict) -> torch.Tensor:
        return state.population[draws["perm_mate"]]

    def after_ask(self, state: SRAState, draws: dict) -> SRAState:
        return state.replace(select_draws={k: draws[k] for k in ("pc", "perm", "u_sweeps")})

    def select(self, state: SRAState, pop: torch.Tensor, fit: torch.Tensor):
        if state.select_draws is None:
            raise ValueError("SRA.tell needs the state that SRA.ask returned")
        draws = state.select_draws
        i_eps, sde = sra_indicators(fit)
        order = stochastic_ranking(i_eps, sde, draws["perm"], draws["u_sweeps"], draws["pc"])
        idx = order[: self.pop_size]
        return pop[idx], fit[idx]

    def tell(self, state: SRAState, fitness: torch.Tensor) -> SRAState:
        return super().tell(state, fitness).replace(select_draws=None)
