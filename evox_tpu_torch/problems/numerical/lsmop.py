"""LSMOP large-scale multi-objective test suite (Cheng, Jin & Olhofer 2017,
IEEE Trans. Cybernetics 47(12):4108-4121) — the port of
``evox_tpu/problems/numerical/lsmop.py``: one table-driven evaluator, each
LSMOPk a (variable linkage, inner-function pair, front geometry) triple.

Decision space: the first ``m - 1`` position variables lie in [0, 1], the
remaining distance variables in [0, 10]; :meth:`bounds` gives lb/ub. As in
the JAX package, ``pf()`` of the linear fronts (LSMOP1-4) is the unit
simplex (the fronts sum to 1 at g = 0), not the halved one of the suite's
reference code.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem
from ...operators.sampling.uniform import UniformSampling
from .basic import ackley_func, griewank_func, rosenbrock_func, sphere_func


def _schwefel_max(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=-1)


def _rastrigin(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x**2 - 10.0 * torch.cos(2.0 * math.pi * x) + 10.0, dim=-1)


class _LSMOPBase(Problem):
    #: inner g-functions cycled over the m objective groups
    inner: Sequence[Callable] = (sphere_func,)
    #: "linear" (LSMOP1-4) or "nonlinear" (LSMOP5-9) variable linkage
    linkage: str = "linear"
    #: "linear" | "sphere" | "disconnected" front geometry
    front: str = "linear"

    def __init__(self, d: int = None, m: int = 3, ref_num: int = 100, device: DeviceLike = None):
        """``device``: where ``bounds()`` and ``pf()`` go (``None`` means
        ``"cuda"``); ``evaluate`` runs on the population's device."""
        self.m = m
        self.d = d if d is not None else 100 * m
        self.ref_num = ref_num
        self.device = resolve_device(device)
        self.nk = 5
        # chaos-series subgroup lengths (suite eq. 6), in float32 as the JAX
        # package computes them, so both cut the same subgroups
        c = [3.8 * 0.1 * (1 - 0.1)]
        for _ in range(1, m):
            c.append(3.8 * c[-1] * (1 - c[-1]))
        c = torch.tensor(c, dtype=torch.float32)
        budget = self.d - (m - 1)
        sublen = torch.floor(c / torch.sum(c) * budget / self.nk)
        self.sublen = tuple(int(s) for s in sublen)
        starts = [0]
        for s in self.sublen:
            starts.append(starts[-1] + s * self.nk)
        self.group_start = tuple(starts[:-1])

    def bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        lb = torch.zeros((self.d,), device=self.device)
        ub = torch.ones((self.d,), device=self.device)
        ub[self.m - 1:] = 10.0
        return lb, ub

    def fit_shape(self, pop_size):
        return (pop_size, self.m)

    # ------------------------------------------------------------------ core
    def _link(self, x: torch.Tensor) -> torch.Tensor:
        """Variable linkage of the distance part (suite eq. 8/9)."""
        d = x.shape[1]
        m = self.m
        i = torch.arange(m, d + 1, dtype=torch.float32, device=x.device)
        if self.linkage == "linear":
            scale = 1.0 + i / d
        else:
            scale = 1.0 + torch.cos(i / d * math.pi / 2.0)
        xs = scale * x[:, m - 1:] - 10.0 * x[:, :1]
        return torch.cat([x[:, : m - 1], xs], dim=1)

    def _g(self, x: torch.Tensor) -> torch.Tensor:
        """Per-objective mean of the inner function over nk subcomponents."""
        m = self.m
        gs = []
        for i in range(m):
            func = self.inner[i % len(self.inner)]
            sublen = self.sublen[i]
            acc = 0.0
            for j in range(self.nk):
                start = self.group_start[i] + (m - 1) + j * sublen
                acc = acc + func(x[:, start: start + sublen])
            gs.append(acc / max(sublen, 1) / self.nk)
        return torch.stack(gs, dim=1)  # (n, m)

    def evaluate(self, state, pop):
        n = pop.shape[0]
        m = self.m
        x = self._link(pop)
        g = self._g(x)
        ones = torch.ones((n, 1), dtype=pop.dtype, device=pop.device)
        xf = x[:, : m - 1]
        if self.front == "linear":
            cum = torch.flip(torch.cumprod(torch.cat([ones, xf], dim=1), dim=1), dims=[1])
            rev = torch.cat([ones, 1.0 - torch.flip(xf, dims=[1])], dim=1)
            f = (1.0 + g) * cum * rev
        elif self.front == "sphere":
            g_shift = 1.0 + g + torch.cat([g[:, 1:], torch.zeros_like(ones)], dim=1)
            cos = torch.cos(xf * math.pi / 2.0)
            sin = torch.sin(torch.flip(xf, dims=[1]) * math.pi / 2.0)
            cum = torch.flip(torch.cumprod(torch.cat([ones, cos], dim=1), dim=1), dims=[1])
            rev = torch.cat([ones, sin], dim=1)
            f = g_shift * cum * rev
        else:  # disconnected (LSMOP9, DTLZ7-like)
            gsum = 1.0 + torch.sum(g, dim=1, keepdim=True)
            h = self.m - torch.sum(
                xf / (1.0 + gsum) * (1.0 + torch.sin(3.0 * math.pi * xf)), dim=1, keepdim=True
            )
            f = torch.cat([xf, (1.0 + gsum) * h], dim=1)
        return f, state

    # ------------------------------------------------------------------ front
    def pf(self) -> torch.Tensor:
        w, _ = UniformSampling(self.ref_num, self.m, device=self.device)()
        if self.front == "linear":
            return w
        if self.front == "sphere":
            return w / torch.linalg.norm(w, dim=1, keepdim=True)
        # disconnected: filter a dense curve like DTLZ7
        from ...operators.selection.non_dominate import non_dominated_sort

        if self.m > 2:
            x = UniformSampling(self.ref_num * 10, self.m - 1, device=self.device)()[0]
        else:
            x = torch.linspace(0, 1, self.ref_num * 10, device=self.device)[:, None]
        h = self.m - torch.sum(x / 2.0 * (1.0 + torch.sin(3.0 * math.pi * x)), dim=1, keepdim=True)
        pts = torch.cat([x, 2.0 * h], dim=1)
        rank = non_dominated_sort(pts)
        keep = torch.argsort(rank, stable=True)[: self.ref_num]
        return pts[torch.sort(keep).values]


class LSMOP1(_LSMOPBase):
    inner = (sphere_func,)
    linkage, front = "linear", "linear"


class LSMOP2(_LSMOPBase):
    inner = (griewank_func, _schwefel_max)
    linkage, front = "linear", "linear"


class LSMOP3(_LSMOPBase):
    inner = (_rastrigin, rosenbrock_func)
    linkage, front = "linear", "linear"


class LSMOP4(_LSMOPBase):
    inner = (ackley_func, griewank_func)
    linkage, front = "linear", "linear"


class LSMOP5(_LSMOPBase):
    inner = (sphere_func,)
    linkage, front = "nonlinear", "sphere"


class LSMOP6(_LSMOPBase):
    inner = (rosenbrock_func, _schwefel_max)
    linkage, front = "nonlinear", "sphere"


class LSMOP7(_LSMOPBase):
    inner = (ackley_func, rosenbrock_func)
    linkage, front = "nonlinear", "sphere"


class LSMOP8(_LSMOPBase):
    inner = (griewank_func, sphere_func)
    linkage, front = "nonlinear", "sphere"


class LSMOP9(_LSMOPBase):
    inner = (sphere_func, ackley_func)
    linkage, front = "nonlinear", "disconnected"
