"""SHADE, Success-History based Adaptive DE (Tanabe & Fukunaga 2013) — the
port of ``evox_tpu/algorithms/so/de/shade.py``.

current-to-pbest/1 with an external archive; an H-slot success-history
memory of (M_F, M_CR) pairs updated with the weighted Lehmer and weighted
arithmetic means of the generation's successful parameters; a pbest rate
``p`` drawn per individual in ``[2/n, 0.2)``; a trial coordinate outside the
box goes halfway from its parent to the bound it crossed.

The pbest set, a stable ``argsort(fitness)`` in the JAX package, is
``partial_topk`` (B4) on ``common.sort_key``: only the first
``pbest_k`` ranks can be drawn, so only those are computed (one kernel
launch a generation on the card). The memory position and the archive's
size stay on the card: no host read in a generation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ....core.attribution import OP_DE_CUR_TO_PBEST_1, Attribution, slot_attribution, success_mask
from ....core.device import DeviceLike
from ....core.struct import PyTreeNode
from ....utils.common import generator, split_seed
from .common import DEAlgorithm, crossover_mask, greedy, pbest_cut, update_archive
from .de import select_rand_indices
from .jade import archive_partner, cauchy, current_to_pbest

P_MAX = 0.2  # the pbest rate's upper end


def pbest_k(n: int) -> int:
    """The most pbest ranks a generation of ``n`` can draw, so the cut need
    hold no more.

    ``p`` is a float32 uniform on ``[2/n, 0.2)``, computed as
    ``max(float32(2/n), fl(fl(u * span) + float32(2/n)))`` with ``u < 1``
    and ``span = fl(0.2 - 2/n)``, as ``jax.random.uniform`` computes it.
    For ``n >= 10`` each rounding is at most half an ulp, so ``p`` lies at
    most one ulp above ``float32(0.2)``; for ``n < 10`` the span is negative
    and the clamp makes every ``p`` equal ``float32(2/n)``. So ``p <=
    max(succ(float32(0.2)), float32(2/n))``. Rounding is monotone, so
    ``p_num = max(1, int32(fl(p * n)))`` is at most that bound's, computed
    here in float32 as the ask computes it, and every drawn rank
    ``int32(u * p_num)``, ``u < 1``, lies below ``p_num``. At n 4096 that
    is 819 (``tests/test_torch_de.py`` draws the largest rank there), at n
    2-9 it is 2."""
    p_top = max(np.nextafter(np.float32(P_MAX), np.float32(1.0)), np.float32(2.0 / n))
    return min(n, max(1, int(p_top * np.float32(n))))


class SHADEState(PyTreeNode):
    population: torch.Tensor
    fitness: torch.Tensor
    trials: torch.Tensor
    F: torch.Tensor
    CR: torch.Tensor
    M_F: torch.Tensor  # (H,)
    M_CR: torch.Tensor
    mem_pos: torch.Tensor  # 0-dim int64
    archive: torch.Tensor
    archive_size: torch.Tensor  # 0-dim int64
    attrib: Attribution
    seed: int
    slots: Optional[torch.Tensor] = None  # the archive's random slots for the next tell


class SHADE(DEAlgorithm):
    def __init__(self, lb: Any, ub: Any, pop_size: int, memory_size: int = 100,
                 device: DeviceLike = None):
        super().__init__(lb, ub, pop_size, device)
        self.H = memory_size
        self.pbest_k = pbest_k(pop_size)

    def init(self, seed: int) -> SHADEState:
        seed, pop_seed = split_seed(seed)
        pop = self._uniform_population(pop_seed)
        n, dev = self.pop_size, self.device
        return SHADEState(
            population=pop,
            fitness=self._inf_fitness(),
            trials=pop,
            F=torch.full((n,), 0.5, device=dev),
            CR=torch.full((n,), 0.5, device=dev),
            M_F=torch.full((self.H,), 0.5, device=dev),
            M_CR=torch.full((self.H,), 0.5, device=dev),
            mem_pos=torch.zeros((), dtype=torch.int64, device=dev),
            archive=pop,
            archive_size=torch.zeros((), dtype=torch.int64, device=dev),
            attrib=Attribution.empty(n, dev),
            seed=seed,
        )

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """A generation's draws, each ``(pop,)`` unless said: ``h`` memory
        slots in ``[0, H)``, ``cauchy``, ``z_CR`` standard normals, ``p`` in
        ``[2/n, 0.2)`` (every ``p`` is ``2/n`` when ``2/n > 0.2``, as the JAX
        package's clamped uniform gives it), ``u_pbest`` uniforms, ``r1`` other rows, ``r2_raw`` in
        ``[0, 2 pop)``, ``u_cr`` ``(pop, dim)``, ``j_rand`` ``(pop, 1)``, and
        the tell's ``slots`` in ``[0, pop)``."""
        n, d, dev = self.pop_size, self.dim, self.device
        s_idx, s = split_seed(seed)
        g = generator(s, dev)
        lo = np.float32(2.0 / n)
        return {
            "h": torch.randint(0, self.H, (n,), generator=g, device=dev),
            "cauchy": cauchy(g, (n,), dev),
            "z_CR": torch.randn((n,), generator=g, device=dev),
            "p": torch.clamp_min(torch.rand((n,), generator=g, device=dev) * float(np.float32(P_MAX) - lo)
                                 + float(lo), float(lo)),
            "u_pbest": torch.rand((n,), generator=g, device=dev),
            "r1": select_rand_indices(s_idx, n, 1, dev)[:, 0],
            "r2_raw": torch.randint(0, 2 * n, (n,), generator=g, device=dev),
            "u_cr": torch.rand((n, d), generator=g, device=dev),
            "j_rand": torch.randint(0, d, (n, 1), generator=g, device=dev),
            "slots": torch.randint(0, n, (n,), generator=g, device=dev),
        }

    def pbest_indices(self, fitness: torch.Tensor, p: torch.Tensor,
                      u_pbest: torch.Tensor) -> torch.Tensor:
        """Each individual's pbest row: rank ``int32(u * p_num)`` of the
        stable order of ``fitness``, ``p_num = max(1, int32(p * n))``."""
        p_num = torch.clamp_min((p * self.pop_size).to(torch.int32), 1)
        rank = (u_pbest * p_num).to(torch.int32)
        return pbest_cut(fitness, self.pbest_k)[rank]

    def ask(self, state: SHADEState) -> Tuple[torch.Tensor, SHADEState]:
        seed, k = split_seed(state.seed)
        draws = self._draw(k)
        pop, h = state.population, draws["h"]
        F = torch.clamp(state.M_F[h] + 0.1 * draws["cauchy"], 0.0, 1.0)
        F = torch.where(F <= 0.0, 0.1, F)
        CR = torch.clamp(state.M_CR[h] + 0.1 * draws["z_CR"], 0.0, 1.0)
        pbest = pop[self.pbest_indices(state.fitness, draws["p"], draws["u_pbest"])]
        x_r2 = archive_partner(pop, state.archive, state.archive_size, draws["r2_raw"])
        mutant = current_to_pbest(pop, pbest, pop[draws["r1"]], x_r2, F)
        trials = torch.where(crossover_mask(draws["u_cr"], CR[:, None], draws["j_rand"]), mutant, pop)
        # SHADE's repair: halfway from the parent to the violated bound
        trials = torch.where(trials < self.lb, (pop + self.lb) / 2, trials)
        trials = torch.where(trials > self.ub, (pop + self.ub) / 2, trials)
        return trials, state.replace(trials=trials, F=F, CR=CR, seed=seed, slots=draws["slots"])

    def tell(self, state: SHADEState, fitness: torch.Tensor) -> SHADEState:
        if state.slots is None:
            raise ValueError("SHADE.tell needs the state that SHADE.ask returned")
        improved = success_mask(fitness, state.fitness)
        n_success = torch.sum(improved)
        # weighted by the fitness improvement (SHADE eq. 7-9)
        w_raw = torch.where(improved, state.fitness - fitness, 0.0)
        w = w_raw / torch.clamp_min(torch.sum(w_raw), 1e-12)
        mF = torch.sum(w * state.F**2) / torch.clamp_min(torch.sum(w * state.F), 1e-12)
        mCR = torch.sum(w * state.CR)
        any_s = n_success > 0
        at = state.mem_pos.view(1)
        M_F = torch.where(any_s, state.M_F.index_put((at,), mF.view(1)), state.M_F)
        M_CR = torch.where(any_s, state.M_CR.index_put((at,), mCR.view(1)), state.M_CR)
        mem_pos = torch.where(any_s, torch.remainder(state.mem_pos + 1, self.H), state.mem_pos)
        archive, archive_size = update_archive(state.archive, state.archive_size, state.population,
                                               improved, state.slots)
        return state.replace(
            population=greedy(improved, state.trials, state.population),
            fitness=greedy(improved, fitness, state.fitness),
            M_F=M_F,
            M_CR=M_CR,
            mem_pos=mem_pos,
            archive=archive,
            archive_size=archive_size,
            attrib=slot_attribution(fitness, state.fitness, OP_DE_CUR_TO_PBEST_1),
            slots=None,
        )
