"""Policy networks for neuroevolution — the port of
``evox_tpu/problems/neuroevolution/policy.py::flat_mlp_policy``
(``mlp_policy`` waits, ROADMAP A4)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


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
