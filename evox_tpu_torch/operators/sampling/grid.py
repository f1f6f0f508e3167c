"""Grid sampling — the port of ``evox_tpu/operators/sampling/grid.py``."""

from __future__ import annotations

import torch

from ...core.device import DeviceLike, resolve_device


class GridSampling:
    """Uniform grid over ``[0, 1]^d`` with ``n_per_dim`` points per axis,
    the last axis varying fastest. ``device``: ``None`` means ``"cuda"``."""

    def __init__(self, n_per_dim: int, d: int, device: DeviceLike = None):
        self.n_per_dim, self.d = n_per_dim, d
        self.device = resolve_device(device)

    def __call__(self) -> torch.Tensor:
        axes = [torch.linspace(0.0, 1.0, self.n_per_dim, device=self.device)] * self.d
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        return grid.reshape(-1, self.d)
