"""DTLZ many-objective benchmark suite (Deb, Thiele, Laumanns & Zitzler
2002) — the port of ``evox_tpu/problems/numerical/dtlz.py``: DTLZ1-7 with
their true fronts (``pf()``) from Das-Dennis reference points.

``evaluate`` runs on the population's device; ``device`` says where
``pf()`` goes (``None`` means ``"cuda"``). DTLZ7's ``pf()`` filters a grid
by ``non_dominated_sort``, which launches the dominance kernel for tensors
on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem
from ...operators.sampling.uniform import UniformSampling
from ...utils.common import row_norm


class _DTLZ(Problem):
    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 100,
                 device: DeviceLike = None):
        self.m = m
        self.d = d if d is not None else m + 4
        self.ref_num = ref_num
        self.device = resolve_device(device)

    def fit_shape(self, pop_size):
        return (pop_size, self.m)

    def _g1(self, xm: torch.Tensor) -> torch.Tensor:
        """The rough ``100 (k + sum((x - 0.5)^2 - cos(20 pi (x - 0.5))))``."""
        k = xm.shape[1]
        return 100.0 * (k + torch.sum((xm - 0.5) ** 2 - torch.cos(20.0 * math.pi * (xm - 0.5)), dim=1))

    def _g2(self, xm: torch.Tensor) -> torch.Tensor:
        return torch.sum((xm - 0.5) ** 2, dim=1)

    def _weights(self) -> torch.Tensor:
        return UniformSampling(self.ref_num, self.m, device=self.device)()[0]


def _cumprod_front(x_angles: torch.Tensor, m: int) -> torch.Tensor:
    """The ``[prod cos ..., sin]`` objective cascade of DTLZ2-6."""
    cos = torch.cos(x_angles)
    sin = torch.sin(x_angles)
    fs = []
    for i in range(m):
        t = torch.ones_like(x_angles[:, 0])
        for j in range(m - 1 - i):
            t = t * cos[:, j]
        if i > 0:
            t = t * sin[:, m - 1 - i]
        fs.append(t)
    return torch.stack(fs, dim=1)


class DTLZ1(_DTLZ):
    def evaluate(self, state, pop):
        m = self.m
        xf, xm = pop[:, : m - 1], pop[:, m - 1 :]
        g = self._g1(xm)
        ones = torch.ones((pop.shape[0], 1), dtype=pop.dtype, device=pop.device)
        cum = torch.cumprod(torch.cat([ones, xf], dim=1), dim=1)  # (n, m)
        rev = torch.cat([ones, 1.0 - torch.flip(xf, dims=(1,))], dim=1)
        f = 0.5 * (1.0 + g)[:, None] * torch.flip(cum, dims=(1,)) * rev
        return f, state

    def pf(self):
        return self._weights() / 2.0


class DTLZ2(_DTLZ):
    _g = _DTLZ._g2

    def evaluate(self, state, pop):
        m = self.m
        xf, xm = pop[:, : m - 1], pop[:, m - 1 :]
        g = self._g(xm)
        angles = xf * math.pi / 2.0
        f = (1.0 + g)[:, None] * _cumprod_front(angles, m)
        return f, state

    def pf(self):
        w = self._weights()
        return w / row_norm(w)[:, None]


class DTLZ3(DTLZ2):
    _g = _DTLZ._g1


class DTLZ4(DTLZ2):
    def __init__(self, d=None, m=3, ref_num=100, alpha: float = 100.0, device: DeviceLike = None):
        super().__init__(d, m, ref_num, device)
        self.alpha = alpha

    def evaluate(self, state, pop):
        m = self.m
        xf, xm = pop[:, : m - 1] ** self.alpha, pop[:, m - 1 :]
        g = self._g2(xm)
        angles = xf * math.pi / 2.0
        f = (1.0 + g)[:, None] * _cumprod_front(angles, m)
        return f, state


class DTLZ5(_DTLZ):
    _g = _DTLZ._g2

    def evaluate(self, state, pop):
        m = self.m
        xf, xm = pop[:, : m - 1], pop[:, m - 1 :]
        g = self._g(xm)
        # degenerate curve: bend all but the first angle toward pi/4
        theta1 = xf[:, :1]
        rest = (1.0 + 2.0 * g[:, None] * xf[:, 1:]) / (2.0 * (1.0 + g[:, None]))
        angles = torch.cat([theta1, rest], dim=1) * math.pi / 2.0
        f = (1.0 + g)[:, None] * _cumprod_front(angles, m)
        return f, state

    def pf(self):
        x = torch.linspace(0.0, 1.0, self.ref_num, device=self.device)[:, None] * math.pi / 2.0
        c, s = torch.cos(x), torch.sin(x)  # a 2-D curve lifted into m-D
        m = self.m
        sqrt2 = torch.sqrt(torch.tensor(2.0, device=self.device))
        cols = [c / sqrt2 ** (m - 2)]
        for i in range(1, m - 1):
            cols.append(c / sqrt2 ** (m - 1 - i))
        cols.append(s)
        return torch.cat(cols, dim=1)


class DTLZ6(DTLZ5):
    def _g(self, xm):
        return torch.sum(xm**0.1, dim=1)


class DTLZ7(_DTLZ):
    def __init__(self, d=None, m=3, ref_num=100, device: DeviceLike = None):
        if d is None:
            d = m + 19
        super().__init__(d, m, ref_num, device)

    def evaluate(self, state, pop):
        m = self.m
        xf, xm = pop[:, : m - 1], pop[:, m - 1 :]
        g = 1.0 + 9.0 * torch.mean(xm, dim=1)
        h = m - torch.sum(xf / (1.0 + g[:, None]) * (1.0 + torch.sin(3.0 * math.pi * xf)), dim=1)
        f = torch.cat([xf, ((1.0 + g) * h)[:, None]], dim=1)
        return f, state

    def pf(self):
        # the disconnected front: the non-dominated points of a dense grid
        from ...operators.selection.non_dominate import non_dominated_sort

        n = self.ref_num * 10
        if self.m > 2:
            w = UniformSampling(n, self.m - 1, device=self.device)()[0]
        else:
            w = torch.linspace(0, 1, n, device=self.device)[:, None]
        x = w[:, : self.m - 1]
        h = self.m - torch.sum(x / 2.0 * (1.0 + torch.sin(3.0 * math.pi * x)), dim=1)
        pts = torch.cat([x, (2.0 * h)[:, None]], dim=1)
        rank = non_dominated_sort(pts)
        keep = torch.argsort(rank, stable=True)[: self.ref_num]
        return pts[torch.sort(keep).values]
