"""MaF many-objective test suite (Cheng, Li, Tian, Zhang, Yang, Jin & Yao,
"A benchmark test suite for evolutionary many-objective optimization",
Complex & Intelligent Systems 3(1):67-81, 2017) — the port of
``evox_tpu/problems/numerical/maf.py``.

Shared building blocks: one "front product" helper covers every
DTLZ/WFG-style shape, and the WFG transformations (``s_linear``,
``b_flat``, ``s_decept``, ``s_multi``, ``r_sum``, ``r_nonsep``) are
standalone vectorised functions. Group partitions are fixed in Python at
construction; MaF14/15's chaos-weighted groups are computed with numpy
there, as the JAX package computes them.

Decision spaces (``bounds()``): [0, 1]^d for most members; MaF8/MaF9 are
2-D problems on [-10000, 10000]^2; MaF10-12 (the WFG members) take x_i in
[0, 2i]; MaF14/15 the LSMOP box ([0, 1]^(m-1) x [0, 10]^rest).

The JAX package's repairs of the reference are kept: MaF10 reads the last
position column ``x[:, M-1]``, MaF6's front takes per-column exponents, and
MaF14/15 use the LSMOP box so their front is reachable.

``evaluate`` runs on the population's device; ``device`` says where
``bounds()`` and ``pf()`` go (``None`` means ``"cuda"``). MaF11's ``pf()``
filters its points by ``non_dominated_sort``, which launches the dominance
kernel for tensors on the card; the fronts built in float64 (MaF2, MaF7,
the WFG members' positions) are built with numpy on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem
from ...operators.sampling.uniform import UniformSampling
from ...operators.selection.non_dominate import non_dominated_sort
from ...utils.common import row_norm, sqrt_rn
from .basic import griewank_func, rastrigin_func, rosenbrock_func, sphere_func

# ----------------------------------------------------------------- helpers


def front_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The DTLZ/WFG objective product: for per-position terms ``a`` and
    ``b`` ``(n, m-1)``, the ``(n, m)`` matrix whose column j is
    ``prod(a[:, :m-1-j]) * (b[:, m-1-j] if j > 0 else 1)``."""
    ones = torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device)
    cp = torch.flip(torch.cumprod(torch.cat([ones, a], dim=1), dim=1), dims=(1,))
    return cp * torch.cat([ones, torch.flip(b, dims=(1,))], dim=1)


def _linear(x: torch.Tensor) -> torch.Tensor:
    return front_product(x, 1.0 - x)


def _concave(x: torch.Tensor) -> torch.Tensor:
    return front_product(torch.sin(x * math.pi / 2), torch.cos(x * math.pi / 2))


def _sphere_front(x: torch.Tensor) -> torch.Tensor:
    """cos-products with sin last (the DTLZ2 geometry)."""
    return front_product(torch.cos(x * math.pi / 2), torch.sin(x * math.pi / 2))


def _convex(x: torch.Tensor) -> torch.Tensor:
    return front_product(1.0 - torch.cos(x * math.pi / 2), 1.0 - torch.sin(x * math.pi / 2))


def _mixed(x: torch.Tensor, alpha: float = 1.0, A: float = 5.0) -> torch.Tensor:
    """The WFG 'mixed' last-objective shape (A 5 for WFG1/MaF10)."""
    t = 2.0 * A * math.pi * x[:, 0] + math.pi / 2
    return (1.0 - x[:, 0] - torch.cos(t) / (2.0 * A * math.pi)) ** alpha


def _disc(x: torch.Tensor) -> torch.Tensor:
    """The WFG 'disconnected' last-objective shape (WFG2/MaF11)."""
    return 1.0 - x[:, 0] * torch.cos(5.0 * math.pi * x[:, 0]) ** 2


# the WFG transformation functions (Huband et al. 2006), over (n, k)


def s_linear(y: torch.Tensor, A: float) -> torch.Tensor:
    return torch.abs(y - A) / torch.abs(torch.floor(A - y) + A)


def b_flat(y: torch.Tensor, A: float, B: float, C: float) -> torch.Tensor:
    out = (
        A
        + torch.clamp_max(torch.floor(y - B), 0.0) * A * (B - y) / B
        - torch.clamp_max(torch.floor(C - y), 0.0) * (1 - A) * (y - C) / (1 - C)
    )
    return torch.round(out * 1e4) / 1e4  # the suite's float32 stabilisation


def s_decept(y: torch.Tensor, A: float, B: float, C: float) -> torch.Tensor:
    return 1.0 + (torch.abs(y - A) - B) * (
        torch.floor(y - A + B) * (1 - C + (A - B) / B) / (A - B)
        + torch.floor(A + B - y) * (1 - C + (1 - A - B) / B) / (1 - A - B)
        + 1.0 / B
    )


def s_multi(y: torch.Tensor, A: float, B: float, C: float) -> torch.Tensor:
    t = torch.abs(y - C) / (2.0 * (torch.floor(C - y) + C))
    return (1.0 + torch.cos((4 * A + 2) * math.pi * (0.5 - t)) + 4 * B * t**2) / (B + 2.0)


def r_sum(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted-sum reduction over the last axis -> ``(n,)``."""
    return torch.sum(y * w, dim=-1) / torch.sum(w)


def r_nonsep(y: torch.Tensor, A: int) -> torch.Tensor:
    """Non-separable reduction (WFG ``r_nonsep``) over the last axis."""
    k = y.shape[-1]
    out = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + y[..., j]
        for l in range(A - 1):
            out = out + torch.abs(y[..., j] - y[..., (j + 1 + l) % k])
    denom = (k / A) * math.ceil(A / 2) * (1.0 + 2.0 * A - 2.0 * math.ceil(A / 2))
    return out / denom


# polygon utilities (MaF8/MaF9)


def ray_intersect_segment(point: torch.Tensor, seg_init: torch.Tensor,
                          seg_term: torch.Tensor) -> torch.Tensor:
    """Does a horizontal +x ray from ``point`` ``(..., 2)`` hit the segment
    ``[seg_init, seg_term)`` (``(..., 2)``, broadcast against it)?"""

    def inside(x, a, b):
        return (torch.minimum(a, b) <= x) & (x < torch.maximum(a, b))

    px, py = point[..., 0], point[..., 1]
    ix, iy = seg_init[..., 0], seg_init[..., 1]
    tx, ty = seg_term[..., 0], seg_term[..., 1]
    y_dist = ty - iy
    flat = (py == iy) & inside(px, ix, tx)
    lhs = ix * y_dist + (py - iy) * (tx - ix)
    rhs = px * y_dist
    crosses = ((y_dist > 0) & (lhs >= rhs)) | ((y_dist < 0) & (lhs <= rhs))
    spans = inside(py, iy, ty)
    return ((y_dist == 0) & flat) | ((y_dist != 0) & crosses & spans)


def point_in_polygon(polygon: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Ray casting: is ``point`` ``(..., 2)`` inside ``polygon`` ``(v, 2)``?
    Vertices count as inside."""
    seg_term = torch.roll(polygon, 1, dims=0)
    hits = ray_intersect_segment(point[..., None, :], polygon, seg_term)
    on_vertex = torch.any(torch.all(polygon == point[..., None, :], dim=-1), dim=-1)
    return (torch.sum(hits, dim=-1) % 2 == 1) | on_vertex


def _polygon_vertices(m: int, device: torch.device) -> torch.Tensor:
    """The regular m-gon inscribed in the unit circle, from (0, 1)
    clockwise (the suite's convention)."""
    theta = math.pi / 2 - torch.arange(1, m + 1, device=device) * 2 * math.pi / m
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)


# -------------------------------------------------------------------- base


class MaFBase(Problem):
    """Shared skeleton: m objectives, d decision variables, [0, 1]^d."""

    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 1000,
                 device: DeviceLike = None):
        self.m = m
        self.d = d if d is not None else m + 9
        self.ref_num = ref_num
        self.device = resolve_device(device)

    def bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.zeros((self.d,), device=self.device),
                torch.ones((self.d,), device=self.device))

    def fit_shape(self, pop_size):
        return (pop_size, self.m)

    def _uniform_pts(self, m: Optional[int] = None) -> torch.Tensor:
        return UniformSampling(self.ref_num * self.m, m or self.m, device=self.device)()[0]

    def _pf_from_numpy(self, f: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(f, dtype=np.float32)).to(self.device)


def _distance_g(X: torch.Tensor, m: int) -> torch.Tensor:
    """DTLZ3's rough ``100 (k + sum((x - 0.5)^2 - cos(20 pi (x - 0.5))))``,
    ``(n, 1)``."""
    tail = X[:, m - 1:] - 0.5
    return 100.0 * (X.shape[1] - m + 1
                    + torch.sum(tail**2 - torch.cos(20 * math.pi * tail), dim=1, keepdim=True))


def _suffix_sums(z: torch.Tensor) -> torch.Tensor:
    """``z[:, j:].sum(1)`` for every column j, added from the last column
    one elementwise step at a time (``jnp.cumsum`` of the reversed columns
    in the order XLA's CPU backend adds up to 16 of them)."""
    acc = z[:, -1]
    cols = [acc]
    for j in range(z.shape[1] - 2, -1, -1):
        acc = acc + z[:, j]
        cols.append(acc)
    return torch.stack(cols[::-1], dim=1)


def _powers_of_two(lo: int, hi: int, step: int, device: torch.device) -> torch.Tensor:
    return 2.0 ** torch.arange(lo, hi, step, device=device).to(torch.float32)


# ----------------------------------------------------------------- members


class MaF1(MaFBase):
    """Inverted linear front (modified inverted DTLZ1)."""

    def evaluate(self, state, X):
        m = self.m
        g = torch.sum((X[:, m - 1:] - 0.5) ** 2, dim=1, keepdim=True)
        return (1 + g) * (1.0 - _linear(X[:, : m - 1])), state

    def pf(self):
        return 1.0 - self._uniform_pts()


class MaF2(MaFBase):
    """Concave front with per-objective distance groups (DTLZ2BZ)."""

    def _groups(self):
        m, d = self.m, self.d
        interval = (d - m + 1) // m
        starts = [m - 1 + i * interval for i in range(m)]
        ends = [m - 1 + (i + 1) * interval for i in range(m - 1)] + [d]
        return starts, ends

    def evaluate(self, state, X):
        m = self.m
        starts, ends = self._groups()
        theta = X / 2.0 + 0.25
        g = torch.stack([torch.sum((theta[:, s:e] - 0.5) ** 2, dim=1) for s, e in zip(starts, ends)],
                        dim=1)
        return (1 + g) * _sphere_front(theta[:, : m - 1]), state

    def pf(self):
        m = self.m
        r = self._uniform_pts().cpu().numpy().astype(np.float64)
        c = np.zeros((r.shape[0], m - 1))
        for j in range(2, m + 1):
            temp = r[:, j - 1] / r[:, 0] * np.prod(c[:, m - j + 1: m - 1], axis=1)
            c[:, m - j] = np.sqrt(1.0 / (1.0 + temp**2))
        lo, hi = np.cos(3 * np.pi / 8), np.cos(np.pi / 8)
        if m > 5:
            c = c * (hi - lo) + lo
        else:
            c = c[np.all((c >= lo) & (c <= hi), axis=1)]
        ones = np.ones((c.shape[0], 1))
        f = np.fliplr(np.cumprod(np.hstack([ones, c]), axis=1)) * np.hstack(
            [ones, np.sqrt(1.0 - c[:, ::-1] ** 2)])
        return self._pf_from_numpy(f)


class MaF3(MaFBase):
    """Convex DTLZ3: multimodal g, objectives raised to the 4th power."""

    def evaluate(self, state, X):
        m = self.m
        f1 = (1 + _distance_g(X, m)) * _sphere_front(X[:, : m - 1])
        return torch.cat([f1[:, : m - 1] ** 4, f1[:, m - 1:] ** 2], dim=1), state

    def pf(self):
        r = self._uniform_pts() ** 2
        temp = (torch.sum(sqrt_rn(r[:, :-1]), dim=1) + r[:, -1])[:, None]
        return r / torch.cat([(temp**2).repeat(1, r.shape[1] - 1), temp], dim=1)


class MaF4(MaFBase):
    """Inverted, badly scaled DTLZ3 (objective i scaled by 2^i)."""

    def evaluate(self, state, X):
        m = self.m
        f1 = (1 + _distance_g(X, m)) * (1.0 - _sphere_front(X[:, : m - 1]))
        return f1 * _powers_of_two(1, m + 1, 1, X.device), state

    def pf(self):
        r = self._uniform_pts()
        r = r / row_norm(r)[:, None]
        return (1.0 - r) * _powers_of_two(1, self.m + 1, 1, self.device)


class MaF5(MaFBase):
    """Convex, badly scaled DTLZ4 (alpha 100 bias, objective i scaled by
    2^(m-i))."""

    def evaluate(self, state, X):
        m = self.m
        xh = X[:, : m - 1] ** 100
        g = torch.sum((X[:, m - 1:] - 0.5) ** 2, dim=1, keepdim=True)
        f1 = (1 + g) * _sphere_front(xh)
        return f1 * _powers_of_two(m, 0, -1, X.device), state

    def pf(self):
        r = self._uniform_pts()
        r = r / row_norm(r)[:, None]
        return r * _powers_of_two(self.m, 0, -1, self.device)


class MaF6(MaFBase):
    """Degenerate front (DTLZ5(I, M) with I 2)."""

    I = 2

    def evaluate(self, state, X):
        m = self.m
        g = torch.sum((X[:, m - 1:] - 0.5) ** 2, dim=1, keepdim=True)
        head = X[:, : m - 1]
        squeezed = (1.0 + 2.0 * g * head) / (2.0 + 2.0 * g)
        theta = torch.cat([head[:, : self.I - 1], squeezed[:, self.I - 1:]], dim=1)
        return (1 + 100 * g) * _sphere_front(theta), state

    def pf(self):
        # the g = 0 front through the sphere product: per-column sqrt(2)
        # exponents [m-2, m-2, m-3, ..., 1, 0]
        r = self._uniform_pts(self.I)
        r = r / row_norm(r)[:, None]
        pad = r[:, :1].repeat(1, self.m - self.I)
        pts = torch.cat([pad, r], dim=1)
        exps = (np.concatenate([[self.m - 2], np.arange(self.m - 2, 0, -1), [0]])
                if self.m > 2 else np.zeros(2))
        root2 = sqrt_rn(torch.tensor(2.0, device=self.device))
        return pts / root2 ** torch.from_numpy(np.asarray(exps, np.float32)).to(self.device)


class MaF7(MaFBase):
    """Disconnected front (DTLZ7)."""

    def evaluate(self, state, X):
        m = self.m
        head = X[:, : m - 1]
        g = 1.0 + 9.0 * torch.mean(X[:, m - 1:], dim=1)
        last = (1 + g) * (m - torch.sum(head / (1 + g[:, None]) * (1 + torch.sin(3 * math.pi * head)),
                                        dim=1))
        return torch.cat([head, last[:, None]], dim=1), state

    def pf(self):
        m = self.m
        n = self.ref_num * m
        interval = np.array([0.0, 0.251412, 0.631627, 0.859401])
        median = (interval[1] - interval[0]) / (interval[3] - interval[2] + interval[1] - interval[0])
        gap = np.linspace(0, 1, int(math.ceil(n ** (1 / (m - 1)))))
        X = np.stack([g.ravel() for g in np.meshgrid(*([gap] * (m - 1)))], axis=1)
        X = np.where(X <= median, X * (interval[1] - interval[0]) / median + interval[0], X)
        X = np.where(X > median,
                     (X - median) * (interval[3] - interval[2]) / (1 - median) + interval[2], X)
        last = 2.0 * (m - np.sum(X / 2.0 * (1 + np.sin(3 * np.pi * X)), axis=1))
        return self._pf_from_numpy(np.hstack([X, last[:, None]]))


class _PolygonProblem(MaFBase):
    """The 2-D polygon members MaF8/MaF9."""

    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 1000,
                 device: DeviceLike = None):
        super().__init__(2, m, ref_num, device)
        self.points = _polygon_vertices(self.m, self.device)

    def bounds(self):
        return (torch.full((2,), -10000.0, device=self.device),
                torch.full((2,), 10000.0, device=self.device))

    def _pf_grid(self, order: str) -> torch.Tensor:
        n = self.ref_num * self.m
        temp = np.linspace(-1, 1, int(math.ceil(math.sqrt(n))))
        y, x = np.meshgrid(temp, temp)
        pts = torch.from_numpy(np.column_stack([x.ravel(order=order), y.ravel(order=order)])
                               .astype(np.float32)).to(self.device)
        return pts[point_in_polygon(self.points, pts)]

    def _vertex_distances(self, X: torch.Tensor) -> torch.Tensor:
        return row_norm(X[:, None, :] - self.points.to(X.device)[None])


class MaF8(_PolygonProblem):
    """Distances to the vertices of a regular m-gon (d 2)."""

    def evaluate(self, state, X):
        return self._vertex_distances(X[:, :2]), state

    def pf(self):
        return self._vertex_distances(self._pf_grid(order="F"))


class MaF9(_PolygonProblem):
    """Distances to the edges (lines) of a regular m-gon (d 2)."""

    def _line_distances(self, X: torch.Tensor) -> torch.Tensor:
        pts = self.points.to(X.device)
        a = pts
        b = torch.roll(pts, -1, dims=0)
        x0, x1 = X[:, None, 0], X[:, None, 1]
        num = torch.abs((a[:, 0] - x0) * (b[:, 1] - x1) - (b[:, 0] - x0) * (a[:, 1] - x1))
        return num / row_norm(a - b)

    def evaluate(self, state, X):
        return self._line_distances(X[:, :2]), state

    def pf(self):
        return self._line_distances(self._pf_grid(order="C"))


class _WFGBase(MaFBase):
    """The WFG members' scaffolding: z in [0, 2i], K = m-1 position
    variables."""

    def bounds(self):
        return (torch.zeros((self.d,), device=self.device),
                2.0 * torch.arange(1, self.d + 1, dtype=torch.float32, device=self.device))

    @property
    def K(self):
        return self.m - 1

    def _z01(self, X):
        return X / (2.0 * torch.arange(1, self.d + 1, dtype=X.dtype, device=X.device))

    def _scale(self, device):
        return 2.0 * torch.arange(1, self.m + 1, dtype=torch.float32, device=device)

    def _wfg_x(self, t_head, t_last):
        return torch.cat([t_head, t_last[:, None]], dim=1)

    def _pf_position(self, shape_fn, last_shape_fn) -> torch.Tensor:
        """The optimal position parameters, fitted to the suite's reference
        directions (float64, on the host)."""
        m = self.m
        R = self._uniform_pts().cpu().numpy().astype(np.float64)
        c = np.ones((R.shape[0], m))
        for j in range(1, m):
            temp = R[:, j] / R[:, 0] * np.prod(1 - c[:, m - j: m - 1], axis=1)
            c[:, m - j - 1] = (temp**2 - temp + np.sqrt(2 * temp)) / (temp**2 + 1)
        x = np.arccos(np.clip(c, -1.0, 1.0)) * 2 / np.pi
        a = np.linspace(0, 1, 10001)[None, :]
        E = np.abs(((1 - np.sin(np.pi / 2 * x[:, 1])) * R[:, m - 1] / R[:, m - 2])[:, None]
                   * last_shape_fn(a) - shape_fn(a))
        x[:, 0] = a[0, np.argmin(E, axis=1)]
        return self._pf_from_numpy(x)


class MaF10(_WFGBase):
    """WFG1: flat-bias and polynomial-bias transformations, convex and
    mixed front."""

    def evaluate(self, state, X):
        m, K = self.m, self.K
        L = self.d - K
        z01 = self._z01(X)
        t1 = torch.cat([z01[:, :K], s_linear(z01[:, K:], 0.35)], dim=1)
        t2 = torch.cat([t1[:, :K], b_flat(t1[:, K:], 0.8, 0.75, 0.85)], dim=1)
        t3 = t2**0.02
        kg = K // (m - 1)
        col_w = 2.0 * torch.arange(1, self.d + 1, device=X.device).to(X.dtype)
        t4_head = torch.stack([r_sum(t3[:, i * kg:(i + 1) * kg], col_w[i * kg:(i + 1) * kg])
                               for i in range(m - 1)], dim=1)
        t4_last = r_sum(t3[:, K:], col_w[K: K + L])
        x = self._wfg_x(torch.clamp_min(t4_last[:, None], 1.0) * (t4_head - 0.5) + 0.5, t4_last)
        h = torch.cat([_convex(x[:, : m - 1])[:, : m - 1], _mixed(x)[:, None]], dim=1)
        return x[:, m - 1:] + self._scale(X.device) * h, state

    def pf(self):
        m = self.m
        x = self._pf_position(
            lambda a: 1 - a - np.cos(10 * np.pi * a + np.pi / 2) / (10 * np.pi),
            lambda a: 1 - np.cos(np.pi / 2 * a),
        )
        f = torch.cat([_convex(x[:, : m - 1])[:, : m - 1], _mixed(x)[:, None]], dim=1)
        return f * self._scale(self.device)


class MaF11(_WFGBase):
    """WFG2: a non-separable pairwise reduction, convex and disconnected
    front."""

    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 1000,
                 device: DeviceLike = None):
        super().__init__(d, m, ref_num, device)
        # L must be even for the pairwise reduction
        self.d = int(math.ceil((self.d - self.m + 1) / 2) * 2 + self.m - 1)

    def evaluate(self, state, X):
        m, K = self.m, self.K
        L = self.d - K
        z01 = self._z01(X)
        t1 = torch.cat([z01[:, :K], s_linear(z01[:, K:], 0.35)], dim=1)
        a, b = t1[:, K::2], t1[:, K + 1::2]
        pair = (a + b + 2.0 * torch.abs(a - b)) / 3.0
        t2 = torch.cat([t1[:, :K], pair], dim=1)
        kg = K // (m - 1)
        ones = lambda k: torch.ones((k,), dtype=X.dtype, device=X.device)
        t3_head = torch.stack([r_sum(t2[:, i * kg:(i + 1) * kg], ones(kg)) for i in range(m - 1)],
                              dim=1)
        t3_last = r_sum(t2[:, K: K + L // 2], ones(L // 2))
        x = self._wfg_x(torch.clamp_min(t3_last[:, None], 1.0) * (t3_head - 0.5) + 0.5, t3_last)
        h = torch.cat([_convex(x[:, : m - 1])[:, : m - 1], _disc(x)[:, None]], dim=1)
        return x[:, m - 1:] + self._scale(X.device) * h, state

    def pf(self):
        m = self.m
        x = self._pf_position(
            lambda a: 1 - a * np.cos(5 * np.pi * a) ** 2,
            lambda a: 1 - np.cos(np.pi / 2 * a),
        )
        R = torch.cat([_convex(x[:, : m - 1])[:, : m - 1], _disc(x)[:, None]], dim=1)
        nd = non_dominated_sort(R) == 0
        return R[nd] * self._scale(self.device)


class MaF12(_WFGBase):
    """WFG9: deceptive and multimodal transformations, concave front."""

    def evaluate(self, state, X):
        m, K = self.m, self.K
        L = self.d - K
        z01 = self._z01(X)
        # b_param: bias each variable by the mean of those after it; the
        # suffix sums in index order (floor(0.5 - Y) jumps with Y's last
        # bit, so the card and the CPU must add alike)
        csum = _suffix_sums(z01)
        Y = (csum - z01) / torch.arange(K + L - 1, -1, -1, device=X.device).to(X.dtype)
        head = z01[:, :-1] ** (
            0.02 + (50 - 0.02) * (0.98 / 49.98 - (1 - 2 * Y[:, :-1])
                                  * torch.abs(torch.floor(0.5 - Y[:, :-1]) + 0.98 / 49.98)))
        t1 = torch.cat([head, z01[:, -1:]], dim=1)
        t2 = torch.cat([s_decept(t1[:, :K], 0.35, 0.001, 0.05), s_multi(t1[:, K:], 30, 95, 0.35)],
                       dim=1)
        kg = K // (m - 1)
        t3_head = torch.stack([r_nonsep(t2[:, i * kg:(i + 1) * kg], kg) for i in range(m - 1)], dim=1)
        t3_last = r_nonsep(t2[:, K:], L)
        x = self._wfg_x(torch.clamp_min(t3_last[:, None], 1.0) * (t3_head - 0.5) + 0.5, t3_last)
        h = front_product(torch.sin(x[:, : m - 1] * math.pi / 2), torch.cos(x[:, : m - 1] * math.pi / 2))
        return x[:, m - 1:] + self._scale(X.device) * h, state

    def pf(self):
        r = self._uniform_pts()
        return r / row_norm(r)[:, None] * self._scale(self.device)


class MaF13(MaFBase):
    """A degenerate 3-D core front embedded in m objectives, with a
    non-separable variable linkage."""

    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 1000,
                 device: DeviceLike = None):
        # the front's 3-D core needs at least 3 objectives
        super().__init__(d, max(m, 3), ref_num, device)

    def evaluate(self, state, X):
        D = X.shape[1]
        m = self.m
        Y = X - 2.0 * X[:, 1:2] * torch.sin(
            2 * math.pi * X[:, 0:1] + torch.arange(1, D + 1, device=X.device) * math.pi / D)

        def mean_sq(sl):
            return 2.0 * torch.mean(Y[:, sl] ** 2, dim=1)

        f0 = torch.sin(X[:, 0] * math.pi / 2) + mean_sq(slice(3, D, 3))
        f1 = torch.cos(X[:, 0] * math.pi / 2) * torch.sin(X[:, 1] * math.pi / 2) + mean_sq(slice(4, D, 3))
        f2 = torch.cos(X[:, 0] * math.pi / 2) * torch.cos(X[:, 1] * math.pi / 2) + mean_sq(slice(2, D, 3))
        rest = (f0**2 + f1**10 + f2**10 + mean_sq(slice(3, D)))[:, None]
        return torch.cat([torch.stack([f0, f1, f2], dim=1), rest.repeat(1, m - 3)], dim=1), state

    def pf(self):
        r = UniformSampling(self.ref_num * self.m, 3, device=self.device)()[0]
        r = r / row_norm(r)[:, None]
        rest = (r[:, 0] ** 2 + r[:, 1] ** 10 + r[:, 2] ** 10)[:, None]
        return torch.cat([r, rest.repeat(1, self.m - 3)], dim=1)


class _LargeScaleBase(MaFBase):
    """MaF14/15: chaos-weighted variable groups, two inner functions
    alternating across objectives (the LSMOP construction). The groups are
    fixed with numpy at construction."""

    nk = 2

    def __init__(self, d: Optional[int] = None, m: int = 3, ref_num: int = 1000,
                 device: DeviceLike = None):
        super().__init__(d if d is not None else 20 * m, m, ref_num, device)
        c = [3.8 * 0.1 * (1 - 0.1)]
        for _ in range(1, self.m):
            c.append(3.8 * c[-1] * (1 - c[-1]))
        c = np.array(c)
        self.sublen = tuple(int(v) for v in np.floor(c / c.sum() * (self.d - self.m + 1) / self.nk))
        self.glen = tuple(int(v) for v in np.concatenate([[0], np.cumsum(np.array(self.sublen) * self.nk)]))

    def bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # distance variables up to 10 (the LSMOP box), so the linkage can cancel
        lb = torch.zeros((self.d,), device=self.device)
        ub = torch.cat([torch.ones((self.m - 1,), device=self.device),
                        10.0 * torch.ones((self.d - self.m + 1,), device=self.device)])
        return lb, ub

    def _group_g(self, X, even_fn, odd_fn):
        m = self.m
        G = []
        for i in range(m):
            fn = even_fn if i % 2 == 0 else odd_fn
            acc = 0.0
            for j in range(self.nk):
                start = self.glen[i] + m - 1 + j * self.sublen[i]
                acc = acc + fn(X[:, start: start + self.sublen[i]])
            G.append(acc / (self.sublen[i] * self.nk))
        return torch.stack(G, dim=1)


class MaF14(_LargeScaleBase):
    """Large-scale linear front, partially separable (Rastrigin and
    Rosenbrock)."""

    def evaluate(self, state, X):
        m, D = self.m, X.shape[1]
        link = (1.0 + torch.arange(m, D + 1, device=X.device) / D) * X[:, m - 1:] - X[:, 0:1] * 10.0
        X = torch.cat([X[:, : m - 1], link], dim=1)
        G = self._group_g(X, rastrigin_func, rosenbrock_func)
        return (1 + G) * _linear(X[:, : m - 1]), state

    def pf(self):
        return self._uniform_pts()


class MaF15(_LargeScaleBase):
    """Large-scale inverted concave front (Griewank and Sphere)."""

    def evaluate(self, state, X):
        m, D = self.m, X.shape[1]
        link = ((1.0 + torch.cos(torch.arange(m, D + 1, device=X.device) / D * math.pi / 2.0))
                * X[:, m - 1:] - X[:, 0:1] * 10.0)
        X = torch.cat([X[:, : m - 1], link], dim=1)
        G = self._group_g(X, griewank_func, sphere_func)
        G_shift = torch.cat([G[:, 1:], torch.zeros((X.shape[0], 1), dtype=G.dtype, device=G.device)],
                            dim=1)
        return (1 + G + G_shift) * (1.0 - _sphere_front(X[:, : m - 1])), state

    def pf(self):
        r = self._uniform_pts()
        return 1.0 - r / row_norm(r)[:, None]


__all__ = [
    "MaF1", "MaF2", "MaF3", "MaF4", "MaF5", "MaF6", "MaF7", "MaF8", "MaF9",
    "MaF10", "MaF11", "MaF12", "MaF13", "MaF14", "MaF15",
    "front_product", "point_in_polygon", "ray_intersect_segment",
    "s_linear", "b_flat", "s_decept", "s_multi", "r_sum", "r_nonsep",
]
