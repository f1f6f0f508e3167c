"""ZDT bi-objective benchmark suite (Zitzler, Deb & Thiele 2000) — the port
of ``evox_tpu/problems/numerical/zdt.py``: ZDT1/2/3/4/6 with their true
fronts (``pf()``)."""

from __future__ import annotations

import math

import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem


class _ZDT(Problem):
    """``device``: where ``pf()`` goes (``None`` means ``"cuda"``);
    ``evaluate`` runs on the population's device."""

    def __init__(self, n_dim: int = 30, ref_num: int = 100, device: DeviceLike = None):
        self.n_dim = n_dim
        self.ref_num = ref_num
        self.device = resolve_device(device)

    def fit_shape(self, pop_size):
        return (pop_size, 2)

    def _pf_x(self) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, self.ref_num, device=self.device)


class ZDT1(_ZDT):
    def evaluate(self, state, pop):
        f1 = pop[:, 0]
        g = 1.0 + 9.0 * torch.mean(pop[:, 1:], dim=1)
        f2 = g * (1.0 - torch.sqrt(f1 / g))
        return torch.stack([f1, f2], dim=1), state

    def pf(self):
        x = self._pf_x()
        return torch.stack([x, 1.0 - torch.sqrt(x)], dim=1)


class ZDT2(_ZDT):
    def evaluate(self, state, pop):
        f1 = pop[:, 0]
        g = 1.0 + 9.0 * torch.mean(pop[:, 1:], dim=1)
        f2 = g * (1.0 - (f1 / g) ** 2)
        return torch.stack([f1, f2], dim=1), state

    def pf(self):
        x = self._pf_x()
        return torch.stack([x, 1.0 - x**2], dim=1)


class ZDT3(_ZDT):
    def evaluate(self, state, pop):
        f1 = pop[:, 0]
        g = 1.0 + 9.0 * torch.mean(pop[:, 1:], dim=1)
        f2 = g * (1.0 - torch.sqrt(f1 / g) - f1 / g * torch.sin(10.0 * math.pi * f1))
        return torch.stack([f1, f2], dim=1), state

    def pf(self):
        # disconnected front: keep only the non-dominated part of the curve
        from ...operators.selection.non_dominate import non_dominated_sort

        x = torch.linspace(0.0, 1.0, self.ref_num * 10, device=self.device)
        f2 = 1.0 - torch.sqrt(x) - x * torch.sin(10.0 * math.pi * x)
        pts = torch.stack([x, f2], dim=1)
        rank = non_dominated_sort(pts)
        keep = torch.argsort(rank, stable=True)[: self.ref_num]
        return pts[torch.sort(keep).values]


class ZDT4(_ZDT):
    """Multi-modal: x1 in [0, 1], x2..xd in [-5, 5]."""

    def evaluate(self, state, pop):
        f1 = pop[:, 0]
        xr = pop[:, 1:]
        g = 1.0 + 10.0 * (self.n_dim - 1) + torch.sum(xr**2 - 10.0 * torch.cos(4.0 * math.pi * xr), dim=1)
        f2 = g * (1.0 - torch.sqrt(torch.abs(f1 / g)))
        return torch.stack([f1, f2], dim=1), state

    def pf(self):
        x = self._pf_x()
        return torch.stack([x, 1.0 - torch.sqrt(x)], dim=1)


class ZDT6(_ZDT):
    def __init__(self, n_dim: int = 10, ref_num: int = 100, device: DeviceLike = None):
        super().__init__(n_dim, ref_num, device)

    def evaluate(self, state, pop):
        x1 = pop[:, 0]
        f1 = 1.0 - torch.exp(-4.0 * x1) * torch.sin(6.0 * math.pi * x1) ** 6
        g = 1.0 + 9.0 * torch.mean(pop[:, 1:], dim=1) ** 0.25
        f2 = g * (1.0 - (f1 / g) ** 2)
        return torch.stack([f1, f2], dim=1), state

    def pf(self):
        # min attainable f1 = min_x 1 - exp(-4x) sin^6(6 pi x) ~= 0.2807753191
        x = torch.linspace(0.2807753191, 1.0, self.ref_num, device=self.device)
        return torch.stack([x, 1.0 - x**2], dim=1)
