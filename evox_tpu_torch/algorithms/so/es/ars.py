"""ARS, Augmented Random Search (Mania, Guy & Recht 2018, arXiv:1803.07055),
the V1-t / V2-t "top directions" variant — the port of
``evox_tpu/algorithms/so/es/ars.py``.

The JAX ``tell`` picks its top directions with ``lax.top_k(-score, k)``:
the k smallest scores, ties to the lowest index. The port calls the
``partial_topk`` kernel wrapper for that (B4, ``kernels/topk.py``): its
plain route on a CPU tensor, the CUDA kernel on a CUDA tensor.
``torch.topk`` is not used, since its tie order is unspecified.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode
from ....kernels.topk import partial_topk
from ....utils.common import float_vector, split_seed
from .common import standard_normal


class ARSState(PyTreeNode):
    center: torch.Tensor
    delta: torch.Tensor
    seed: int


class ARS(Algorithm):
    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        elite_ratio: float = 0.1,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.03,
        device: DeviceLike = None,
    ):
        if pop_size % 2:
            raise ValueError("ARS evaluates +/- direction pairs: pop_size must be even")
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.pop_size = pop_size
        self.n_dirs = pop_size // 2
        self.top_k = max(1, int(self.n_dirs * elite_ratio))
        self.learning_rate = learning_rate
        self.noise_stdev = noise_stdev

    def init(self, seed: int) -> ARSState:
        return ARSState(
            center=self.center_init.clone(),
            delta=torch.zeros((self.n_dirs, self.dim), device=self.device),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        return standard_normal(seed, (self.n_dirs, self.dim), self.device)

    def ask(self, state: ARSState) -> Tuple[torch.Tensor, ARSState]:
        seed, k = split_seed(state.seed)
        delta = self._draw(k)
        step = self.noise_stdev * delta
        pop = torch.cat([state.center + step, state.center - step], dim=0)
        return pop, state.replace(delta=delta, seed=seed)

    def tell(self, state: ARSState, fitness: torch.Tensor) -> ARSState:
        f_pos, f_neg = fitness[: self.n_dirs], fitness[self.n_dirs :]
        # the best direction has the smallest min(f+, f-) under minimisation
        score = torch.minimum(f_pos, f_neg)
        _, top = partial_topk(score, self.top_k, device=self.device)
        top = top.long()
        fp, fn, d = f_pos[top], f_neg[top], state.delta[top]
        sigma_r = torch.std(torch.cat([fp, fn]), correction=0) + 1e-8
        grad = (fp - fn) @ d / self.top_k  # a descent direction
        center = state.center - self.learning_rate / sigma_r * grad
        return state.replace(center=center)
