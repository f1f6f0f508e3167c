"""Policy networks for neuroevolution — the port of
``evox_tpu/problems/neuroevolution/policy.py`` (``flat_mlp_policy``,
``mlp_policy``)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ...core.device import DeviceLike, resolve_device
from ...utils.common import generator


def flat_mlp_policy(obs_dim: int, hidden: int, act_dim: int = 1) -> Tuple[Callable, int]:
    """One-hidden-layer tanh MLP over a FLAT genome vector.

    Returns ``(apply, dim)`` where ``apply(theta, obs) -> action`` consumes
    genomes ``(..., dim)`` laid out ``[w1 row-major, b1, w2 row-major, b2]``
    — the JAX package's layout and the one the fused rollout kernel reads,
    so genomes cross between the two packages, and between the scan and
    fused engines, unchanged. ``theta`` and ``obs`` broadcast over their
    leading dimensions (the JAX package vmaps a one-genome function).
    """
    n1 = obs_dim * hidden
    n2 = n1 + hidden
    n3 = n2 + hidden * act_dim
    dim = n3 + act_dim

    def apply(theta: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        lead = theta.shape[:-1]
        w1 = theta[..., :n1].reshape(lead + (obs_dim, hidden))
        b1 = theta[..., n1:n2]
        w2 = theta[..., n2:n3].reshape(lead + (hidden, act_dim))
        b2 = theta[..., n3:]
        h = torch.tanh(torch.sum(obs[..., :, None] * w1, dim=-2) + b1)
        return torch.sum(h[..., :, None] * w2, dim=-2) + b2

    return apply, dim


def mlp_policy(
    layer_sizes: Sequence[int],
    activation: Callable = torch.tanh,
    final_activation: Optional[Callable] = None,
    use_matmul: Optional[bool] = None,
    linear_layers: Sequence[int] = (),
) -> Tuple[Callable, Callable]:
    """An MLP as ``(init_params, apply)``, over a params tree: a list of
    ``{"w": (fan_in, fan_out), "b": (fan_out,)}`` layers, the JAX package's
    tree, which :class:`~evox_tpu_torch.utils.TreeAndVector` flattens in the
    JAX genome order.

    ``init_params(seed, device=None)`` draws Lecun-normal weights and zero
    biases. ``apply(params, obs)`` broadcasts: leaves may carry leading
    batch dimensions (``w`` ``(..., fan_in, fan_out)``), and so may ``obs``
    ``(..., fan_in)``; the two sets broadcast against each other, as the
    JAX engine's double vmap over (population, episodes) does.

    ``use_matmul``: per layer by default, as in the JAX package — ``@`` for
    layers of at least 64 by 64, the broadcast-multiply-reduce form below
    that (the two differ only in the order of their sums); True or False
    forces one form. ``linear_layers``: indices of layers with no activation
    after them (a rank-r input layer is ``(obs, r, h, act)`` with
    ``linear_layers=(0,)``); the fused kernel's ``linear`` mirrors it.
    """
    sizes = tuple(int(s) for s in layer_sizes)
    if len(sizes) < 2:
        raise ValueError("layer_sizes needs at least (in, out)")
    n_layers = len(sizes) - 1
    linear_set = frozenset(int(i) for i in linear_layers)
    if not linear_set <= set(range(n_layers)):
        raise ValueError(
            f"linear_layers {sorted(linear_set)} out of range for "
            f"{n_layers} layers (negative indices not supported)"
        )
    layer_matmul = tuple(
        use_matmul if use_matmul is not None else (fi >= 64 and fo >= 64)
        for fi, fo in zip(sizes[:-1], sizes[1:])
    )

    def init_params(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        g = generator(seed, dev)
        return [
            {
                "w": torch.randn((fi, fo), generator=g, device=dev) / math.sqrt(fi),
                "b": torch.zeros((fo,), device=dev),
            }
            for fi, fo in zip(sizes[:-1], sizes[1:])
        ]

    def apply(params, obs: torch.Tensor) -> torch.Tensor:
        h = obs
        for i, layer in enumerate(params):
            if layer_matmul[i]:
                h = (h[..., None, :] @ layer["w"])[..., 0, :] + layer["b"]
            else:
                h = torch.sum(h[..., :, None] * layer["w"], dim=-2) + layer["b"]
            if i in linear_set:
                continue
            if i < n_layers - 1:
                h = activation(h)
            elif final_activation is not None:
                h = final_activation(h)
        return h

    return init_params, apply
