"""LES, Learned Evolution Strategy (Lange et al. 2023, arXiv:2211.11260) —
the port of ``evox_tpu/algorithms/so/es/les.py``, without flax.

Fitness features (z-score, centred rank, best flag) go through a
self-attention network that gives the recombination weights; evolution
paths on three timescales go through a small MLP that gives each
dimension's learning rates of the mean and of sigma. Both networks are
plain functions on a parameter dict ``{"weights": {"Dense_0", "Dense_1",
"Dense_2"}, "lr": {"Dense_0", "Dense_1"}}``, each layer ``{"bias":
(out,), "kernel": (in, out)}`` applied as ``x @ kernel + bias`` (flax
``Dense``'s layout; ``interop.les_params`` maps the JAX package's tree to
it).

``params="auto"`` loads the meta-trained parameters bundled with the port
(``data/les_params.npz``, through ``les_meta.load_params``); ``None``
draws a seeded initialisation from ``params_seed`` (normal kernels scaled
by ``1/sqrt(fan_in)``, zero biases): it cannot equal flax's
``lecun_normal`` draws of the JAX package, since the generators differ;
an explicit dict in the layout above is used as given.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.struct import PyTreeNode, field
from ....utils.common import float_vector, generator, split_seed
from . import les_meta
from .common import standard_normal

HIDDEN = 8  # the attention network's query and key width


def _dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["kernel"] + layer["bias"]


def attention_weights(params: dict, features: torch.Tensor) -> torch.Tensor:
    """``(pop, 3)`` fitness features -> ``(pop,)`` recombination weights:
    self-attention over the candidates (the paper's weighting network)."""
    q = _dense(params["Dense_0"], features)
    k = _dense(params["Dense_1"], features)
    v = _dense(params["Dense_2"], features)
    attn = torch.softmax(q @ k.T / math.sqrt(HIDDEN), dim=-1)
    return torch.softmax((attn @ v)[:, 0], dim=0)


def lr_modulator(params: dict, path_features: torch.Tensor) -> torch.Tensor:
    """``(dim, 6)`` evolution-path features -> ``(dim, 2)`` learning rates
    of the mean and of sigma, in (0, 1)."""
    return torch.sigmoid(_dense(params["Dense_1"], torch.tanh(_dense(params["Dense_0"], path_features))))


def random_params(seed: int, device: torch.device) -> les_meta.Params:
    """A seeded initialisation in the layout of ``les_meta.LAYERS``."""
    g = generator(seed, device)
    params: les_meta.Params = {}
    for net, layer, fan_in, fan_out in les_meta.LAYERS:
        kernel = torch.randn((fan_in, fan_out), generator=g, device=device) / math.sqrt(fan_in)
        params.setdefault(net, {})[layer] = {"bias": torch.zeros((fan_out,), device=device),
                                             "kernel": kernel}
    return params


class LESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    path_mean: torch.Tensor  # (3, dim): evolution paths on three timescales
    path_sigma: torch.Tensor
    population: torch.Tensor = field(storage=True)
    seed: int


def les_ask(params: les_meta.Params, state: LESState,
            noise: torch.Tensor) -> Tuple[torch.Tensor, LESState]:
    """LES's ask as a plain function: ``mean + sigma * noise`` for
    ``(pop, dim)`` standard normals ``noise``. :meth:`LES.ask` and the
    meta-training (``les_meta``, batched under ``torch.func.vmap``) both
    call it; ``params`` is unused and keeps the two steps' signatures
    alike."""
    pop = state.mean + state.sigma * noise
    return pop, state.replace(population=pop)


def les_tell(params: les_meta.Params, state: LESState, fitness: torch.Tensor,
             timescales: torch.Tensor) -> LESState:
    """LES's tell as a plain function of the networks' ``params``, the
    state and the ``(pop,)`` fitness; ``timescales`` is the ``(3, 1)``
    float32 tensor of the paths' decays (0.1, 0.5, 0.9) on the state's
    device, made once by the caller. :meth:`LES.tell` and the
    meta-training both call it."""
    pop = state.population
    pop_size = fitness.shape[-1]
    # fitness features: z-score (std with ddof 0), centred rank, best flag
    zscore = (fitness - torch.mean(fitness)) / (torch.std(fitness, correction=0) + 1e-8)
    ranks = torch.argsort(torch.argsort(fitness, stable=True), stable=True).to(torch.float32)
    crank = ranks / (pop_size - 1) - 0.5
    best = (ranks == 0).to(torch.float32)
    feats = torch.stack([zscore, crank, best], dim=-1)
    w = attention_weights(params["weights"], feats)
    weighted_mean = w @ pop
    weighted_std = torch.sqrt(w @ (pop - state.mean) ** 2 + 1e-12)
    dm = weighted_mean - state.mean
    ds = weighted_std - state.sigma
    path_mean = timescales * state.path_mean + (1 - timescales) * dm
    path_sigma = timescales * state.path_sigma + (1 - timescales) * ds
    lrs = lr_modulator(params["lr"], torch.cat([path_mean, path_sigma], dim=0).T)
    mean = state.mean + lrs[:, 0] * dm
    sigma = torch.clamp_min(state.sigma + lrs[:, 1] * ds, 1e-8)
    return state.replace(mean=mean, sigma=sigma, path_mean=path_mean, path_sigma=path_sigma)


def timescales(device: torch.device) -> torch.Tensor:
    """The evolution paths' decays as :func:`les_tell` takes them."""
    return torch.tensor([0.1, 0.5, 0.9], device=device)[:, None]


class LES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float = 1.0,
        pop_size: int = 16,
        params: Optional[Any] = "auto",
        params_seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size
        self.timescales = timescales(self.device)
        if isinstance(params, str) and params == "auto":
            params = les_meta.load_params(device=self.device)
            if params is None:
                warnings.warn(
                    "LES(params='auto'): the bundled les_params.npz is missing or has another "
                    "shape; falling back to a random (untrained) initialisation.",
                    stacklevel=2,
                )
        if params is None:
            params = random_params(params_seed, self.device)
        self.params = params

    def init(self, seed: int) -> LESState:
        return LESState(
            mean=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.init_stdev, device=self.device),
            path_mean=torch.zeros((3, self.dim), device=self.device),
            path_sigma=torch.zeros((3, self.dim), device=self.device),
            population=torch.zeros((self.pop_size, self.dim), device=self.device),
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        """A generation's one draw: ``(pop, dim)`` standard normals."""
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: LESState) -> Tuple[torch.Tensor, LESState]:
        seed, k = split_seed(state.seed)
        pop, state = les_ask(self.params, state, self._draw(k))
        return pop, state.replace(seed=seed)

    def tell(self, state: LESState, fitness: torch.Tensor) -> LESState:
        return les_tell(self.params, state, fitness, self.timescales)
