"""OpenAI Evolution Strategy (Salimans et al. 2017, arXiv:1703.03864).

The port of ``evox_tpu/algorithms/so/es/open_es.py``: mirrored sampling,
sgd (default) or adam steps on the center, and ``lr_scale``, a multiplier
on the optimizer's updates that a fleet binds per tenant
(``workflows/tenancy.py``'s hyperparameters): the optimizer's own learning
rate is fixed at construction. At its default 1.0 the multiply is skipped,
so the updates are the unscaled ones bit for bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode
from ....utils.common import generator, split_seed
from ....utils.optimizers import make_optimizer


class OpenESState(PyTreeNode):
    # The (pop, dim) noise batch is NOT stored, as in the JAX package: ask
    # and tell each rebuild the same draw from ``noise_seed`` (a seeded
    # torch.Generator is deterministic), so the dominant buffer of the
    # algorithm lives only as a transient inside ask and tell.
    center: torch.Tensor
    opt_state: Any
    noise_seed: int
    seed: int


class OpenES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        pop_size: int,
        learning_rate: float = 0.05,
        noise_stdev: float = 0.02,
        optimizer: Any = None,
        mirrored_sampling: bool = True,
        device: DeviceLike = None,
    ):
        if not (pop_size > 0 and learning_rate > 0 and noise_stdev > 0):
            raise ValueError("pop_size, learning_rate and noise_stdev must be > 0")
        if mirrored_sampling and pop_size % 2:
            raise ValueError("mirrored sampling needs an even pop_size")
        self.device = resolve_device(device)
        self.center_init = torch.as_tensor(
            center_init, dtype=torch.float32
        ).to(self.device)
        self.dim = self.center_init.shape[0]
        self.pop_size = pop_size
        self.learning_rate = learning_rate
        self.noise_stdev = noise_stdev
        self.mirrored = mirrored_sampling
        self.optimizer = make_optimizer(optimizer, learning_rate)
        self.lr_scale = 1.0

    def init(self, seed: int) -> OpenESState:
        seed, noise_seed = split_seed(seed)
        return OpenESState(
            center=self.center_init.clone(),
            opt_state=self.optimizer.init(self.center_init),
            noise_seed=noise_seed,
            seed=seed,
        )

    def _draw_noise(self, seed: int) -> torch.Tensor:
        """The one draw of a generation: ``(pop/2, dim)`` standard normals
        when mirrored, else ``(pop, dim)``. ``ask`` and ``tell`` both call
        this with the generation's ``noise_seed``."""
        rows = self.pop_size // 2 if self.mirrored else self.pop_size
        return torch.randn(
            (rows, self.dim), generator=generator(seed, self.device), device=self.device,
            dtype=torch.float32,
        )

    def ask(self, state: OpenESState) -> Tuple[torch.Tensor, OpenESState]:
        seed, noise_seed = split_seed(state.seed)
        noise = self._draw_noise(noise_seed)
        if self.mirrored:
            noise = torch.cat([noise, -noise], dim=0)
        pop = state.center + self.noise_stdev * noise
        return pop, state.replace(noise_seed=noise_seed, seed=seed)

    def tell(self, state: OpenESState, fitness: torch.Tensor) -> OpenESState:
        # minimize: estimated gradient of E[f] wrt center. Mirrored sampling
        # folds: noise.T @ f == half.T @ (f_pos - f_neg), so the transient
        # is (pop/2, dim), not (pop, dim).
        noise = self._draw_noise(state.noise_seed)
        if self.mirrored:
            m = self.pop_size // 2
            grad = noise.T @ (fitness[:m] - fitness[m:])
        else:
            grad = noise.T @ fitness
        grad = grad / (self.pop_size * self.noise_stdev)
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.center)
        if not (isinstance(self.lr_scale, float) and self.lr_scale == 1.0):
            # a rebound lr_scale: a tenant's 0-d binding, or another float
            updates = updates * self.lr_scale
        return state.replace(center=state.center + updates, opt_state=opt_state)
