"""Latin hypercube sampling — the port of
``evox_tpu/operators/sampling/latin_hypercube.py``."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.device import DeviceLike, resolve_device
from ...utils.common import generator


def latin_hypercube(
    seed: int,
    n: int,
    d: int,
    smooth: bool = True,
    device: DeviceLike = None,
    perms: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``n`` points in ``[0, 1]^d``, one in each of the ``n`` strata of every
    axis. Draws: ``perms``, an ``(n, d)`` integer tensor whose columns are
    permutations of ``range(n)``, and ``offset``, the ``(n, d)`` uniform
    place inside a stratum (0.5 when not ``smooth``); each drawn from
    ``seed`` when not given."""
    dev = resolve_device(device)
    g = None
    if perms is None:
        g = generator(seed, dev)
        perms = torch.stack([torch.randperm(n, generator=g, device=dev) for _ in range(d)], dim=1)
    if not smooth:
        offset = 0.5
    elif offset is None:
        g = g or generator(seed, dev)
        offset = torch.rand((n, d), generator=g, device=dev)
    return (perms.to(device=dev, dtype=torch.float32) + offset) / n


class LatinHypercubeSampling:
    def __init__(self, n: int, d: int, smooth: bool = True, device: DeviceLike = None):
        self.n, self.d, self.smooth = n, d, smooth
        self.device = resolve_device(device)

    def __call__(self, seed: int) -> torch.Tensor:
        return latin_hypercube(seed, self.n, self.d, self.smooth, self.device)
