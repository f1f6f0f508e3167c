"""CEC 2022 single-objective bound-constrained suite (F1-F12) — the port of
``evox_tpu/problems/numerical/cec2022.py``.

The official shift, rotation and shuffle constants are data of the
benchmark: the port reads its own copy of them (``cec2022_data/``, the
same 54 files as the JAX package's). Every basic function is batched over
an ``(n, k)`` population, reducing over the last axis; the rotations are
float32 matrix products.

The JAX package's choices are kept, since the suite is defined by its
data and its reference's outputs: F3 and F7's Schaffer F7 part read the
shifted vector without the rotation (F7: the head of the shuffled one);
``levy`` takes ``w = 1 + z/4``; F12's sixth part reuses the fifth block's
shift and rotation; a value below the round-off floor (1e-8, F11's
d-dependent) snaps to 0.

The suite defines d 2, 10 and 20, the hybrid members (F6-F8) d 10 and 20
only. ``device`` says where the constants live (``None`` means
``"cuda"``); ``evaluate`` takes a population on that device. The box is
``[-100, 100]^d``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem

_DATA_DIR = os.path.join(os.path.dirname(__file__), "cec2022_data")
SUPPORTED_DIMS = (2, 10, 20)
HYBRID_DIMS = (10, 20)

__all__ = [
    "F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8", "F9", "F10", "F11", "F12",
    "CEC2022TestSuite", "CEC2022TestSuit", "CEC2022Problem",
]


def _load(name: str) -> np.ndarray:
    return np.loadtxt(os.path.join(_DATA_DIR, name))


def _arange1(k: int, z: torch.Tensor) -> torch.Tensor:
    """``1, ..., k`` as float32 on ``z``'s device."""
    return torch.arange(1, k + 1, dtype=torch.float32, device=z.device)


# ------------------------------------------------------------ basic functions


def zakharov(z):
    t = torch.sum(0.5 * _arange1(z.shape[-1], z) * z, dim=-1)
    return torch.sum(z**2, dim=-1) + t**2 + t**4


def rosenbrock(z):
    z = z + 1.0
    return 100.0 * torch.sum((z[..., :-1] ** 2 - z[..., 1:]) ** 2, dim=-1) + torch.sum(
        (1.0 - z[..., :-1]) ** 2, dim=-1
    )


def schaffer_f7(y):
    """Schaffer F7 over consecutive pairs of ``y``."""
    k = y.shape[-1]
    s = torch.sqrt(y[..., :-1] ** 2 + y[..., 1:] ** 2)
    t = torch.sin(50.0 * s**0.2)
    f = torch.sum(torch.sqrt(s) * (1.0 + t * t), dim=-1)
    return f * f / (k - 1) ** 2


def rastrigin(z):
    z = z * 0.0512
    return torch.sum(z**2 - 10.0 * torch.cos(2 * math.pi * z) + 10.0, dim=-1)


def levy(z):
    w = 1.0 + z / 4.0
    head = torch.sin(math.pi * w[..., 0]) ** 2
    mid = torch.sum(
        (w[..., :-1] - 1) ** 2 * (1 + 10 * torch.sin(math.pi * w[..., :-1] + 1) ** 2), dim=-1
    )
    tail = (w[..., -1] - 1) ** 2 * (1 + torch.sin(2 * math.pi * w[..., -1]) ** 2)
    return head + mid + tail


def bent_cigar(z):
    return z[..., 0] ** 2 + 1e6 * torch.sum(z[..., 1:] ** 2, dim=-1)


def hgbat(z):
    k = z.shape[-1]
    z = z * 0.05 - 1.0
    ssq = torch.sum(z**2, dim=-1)
    s = torch.sum(z, dim=-1)
    return torch.abs(ssq**2 - s**2) ** 0.5 + (0.5 * ssq + s) / k + 0.5


def katsuura(z):
    k = z.shape[-1]
    z = z * 0.05
    j = 2.0 ** torch.arange(1, 33, dtype=torch.float32, device=z.device)
    t = z[..., None] * j  # (n, k, 32)
    temp = torch.sum(torch.abs(t - torch.floor(t + 0.5)) / j, dim=-1)
    f = torch.prod((1.0 + _arange1(k, z) * temp) ** (10.0 / k**1.2), dim=-1)
    scale = 10.0 / (k * k)
    return f * scale - scale


def ackley(z):
    k = z.shape[-1]
    t1 = -20.0 * torch.exp(-0.2 * torch.sqrt(torch.sum(z**2, dim=-1) / k))
    t2 = -torch.exp(torch.sum(torch.cos(2 * math.pi * z), dim=-1) / k)
    return t1 + t2 + 20.0 + math.e


def schwefel(z):
    k = z.shape[-1]
    z = z * 10.0 + 4.209687462275036e002
    az = torch.abs(z)
    mod = torch.fmod(az, 500.0)
    inside = -z * torch.sin(torch.sqrt(az))
    over = -(500.0 - mod) * torch.sin(torch.sqrt(500.0 - mod)) + ((z - 500.0) / 100.0) ** 2 / k
    under = -(-500.0 + mod) * torch.sin(torch.sqrt(500.0 - mod)) + ((z + 500.0) / 100.0) ** 2 / k
    per_dim = torch.where(z > 500.0, over, torch.where(z < -500.0, under, inside))
    return torch.sum(per_dim, dim=-1) + 4.189828872724338e002 * k


def happycat(z):
    k = z.shape[-1]
    z = z * 0.05 - 1.0
    ssq = torch.sum(z**2, dim=-1)
    s = torch.sum(z, dim=-1)
    return torch.abs(ssq - k) ** 0.25 + (0.5 * ssq + s) / k + 0.5


def elliptic(z):
    k = z.shape[-1]
    w = 10.0 ** (6.0 * torch.arange(k, dtype=torch.float32, device=z.device) / (k - 1))
    return torch.sum(w * z**2, dim=-1)


def discus(z):
    return 1e6 * z[..., 0] ** 2 + torch.sum(z[..., 1:] ** 2, dim=-1)


def exp_schaffer_f6(z):
    """Expanded Schaffer F6 over cyclically consecutive pairs."""
    ssq = z**2 + torch.roll(z, 1, dims=-1) ** 2
    t1 = torch.sin(torch.sqrt(ssq)) ** 2 - 0.5
    t2 = (1.0 + 0.001 * ssq) ** 2
    return torch.sum(0.5 + t1 / t2, dim=-1)


def exp_griewank_rosenbrock(z):
    z = z * 0.05 + 1.0
    t = 100.0 * (z**2 - torch.roll(z, -1, dims=-1)) ** 2 + (z - 1.0) ** 2
    return torch.sum(t**2 / 4000.0 - torch.cos(t) + 1.0, dim=-1)


def griewank(z):
    k = z.shape[-1]
    return (
        torch.sum(z**2, dim=-1) / 4000.0
        - torch.prod(torch.cos(z / torch.sqrt(_arange1(k, z))), dim=-1)
        + 1.0
    )


# --------------------------------------------------------------- scaffolding


class CEC2022Problem(Problem):
    """Base: the official shift and rotation (and shuffle) constants of
    member ``func_num`` as float32 on ``device``."""

    func_num: int = 0
    #: the hybrid members' group proportions
    p: Tuple[float, ...] = ()

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        fn = self.func_num
        as_t = lambda a, dtype=torch.float32: torch.from_numpy(np.asarray(a)).to(self.device, dtype)
        self.shift = as_t(_load(f"shift_data_{fn}.txt"))
        self.rot: Dict[int, torch.Tensor] = {d: as_t(_load(f"M_{fn}_D{d}.txt")) for d in SUPPORTED_DIMS}
        if self.p:
            self.shuffle = {d: as_t(_load(f"shuffle_data_{fn}_D{d}.txt").astype(np.int64) - 1,
                                    torch.int64) for d in HYBRID_DIMS}
            self.group_ids = {}  # each group a contiguous run of the shuffled vector
            for d in HYBRID_DIMS:
                ends = np.cumsum(np.round(np.asarray(self.p) * d).astype(int)).tolist()
                ends[-1] = d
                self.group_ids[d] = [slice(a, b) for a, b in zip([0] + ends[:-1], ends)]

    def bounds(self, d: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.full((d,), -100.0, device=self.device),
                torch.full((d,), 100.0, device=self.device))

    def _sr(self, X, shift, rot, sh_rate: float, shuffle=None):
        """Shift, scale, rotate (and shuffle), batched."""
        z = (X - shift) * sh_rate
        z = z @ rot.T
        if shuffle is not None:
            z = z[:, shuffle]
        return z

    def _threshold(self, d: int) -> float:
        """The round-off floor below which a value snaps to exactly 0."""
        return 1e-8

    def evaluate(self, state, X):
        d = X.shape[1]
        if d not in SUPPORTED_DIMS:
            raise ValueError(f"CEC2022 defines d in {SUPPORTED_DIMS}, got {d}")
        f = self._impl(X, d)
        return torch.where(f < self._threshold(d), 0.0, f), state


class _SimpleCEC(CEC2022Problem):
    """F1-F5: one shifted and rotated basic function."""

    base_fn = None
    sh_rate = 1.0

    def _impl(self, X, d):
        return type(self).base_fn(self._sr(X, self.shift[:d], self.rot[d], self.sh_rate))


class F1(_SimpleCEC):
    """Shifted and rotated Zakharov."""
    func_num = 1
    base_fn = staticmethod(zakharov)


class F2(_SimpleCEC):
    """Shifted and rotated Rosenbrock."""
    func_num = 2
    base_fn = staticmethod(rosenbrock)
    sh_rate = 2.048 / 100.0


class F3(CEC2022Problem):
    """Shifted (not rotated, see the module's notes) Schaffer F7."""
    func_num = 3

    def _impl(self, X, d):
        return schaffer_f7(X - self.shift[:d])


class F4(_SimpleCEC):
    """Shifted and rotated non-continuous Rastrigin."""
    func_num = 4
    base_fn = staticmethod(rastrigin)


class F5(_SimpleCEC):
    """Shifted and rotated Levy."""
    func_num = 5
    base_fn = staticmethod(levy)


class _HybridCEC(CEC2022Problem):
    """F6-F8: shuffle the rotated vector, split it into groups, add the
    groups' basic functions."""

    components = ()

    def _shuffled(self, X, d):
        if d not in HYBRID_DIMS:
            raise ValueError(f"CEC2022's hybrid F{self.func_num} defines d in {HYBRID_DIMS}, got {d}")
        return self._sr(X, self.shift[:d], self.rot[d], 1.0, self.shuffle[d])

    def _impl(self, X, d):
        z = self._shuffled(X, d)
        total = 0.0
        for fn, idx in zip(self.components, self.group_ids[d]):
            total = total + fn(z[:, idx])
        return total


class F6(_HybridCEC):
    """Hybrid: bent cigar + HGBat + Rastrigin (p = 0.4/0.4/0.2)."""
    func_num = 6
    p = (0.4, 0.4, 0.2)
    components = (bent_cigar, hgbat, rastrigin)


class F7(_HybridCEC):
    """Hybrid: HGBat + Katsuura + Ackley + Rastrigin + Schwefel + Schaffer F7."""
    func_num = 7
    p = (0.1, 0.2, 0.2, 0.2, 0.1, 0.2)

    def _impl(self, X, d):
        z = self._shuffled(X, d)
        ids = self.group_ids[d]
        return (
            hgbat(z[:, ids[0]])
            + katsuura(z[:, ids[1]])
            + ackley(z[:, ids[2]])
            + rastrigin(z[:, ids[3]])
            + schwefel(z[:, ids[4]])
            + schaffer_f7(z[:, : ids[5].stop - ids[5].start])  # the head of z, as the reference reads it
        )


class F8(_HybridCEC):
    """Hybrid: Katsuura + HappyCat + Griewank-Rosenbrock + Schwefel + Ackley."""
    func_num = 8
    p = (0.3, 0.2, 0.2, 0.1, 0.2)
    components = (katsuura, happycat, exp_griewank_rosenbrock, schwefel, ackley)


class _CompositionCEC(CEC2022Problem):
    """F9-F12: a weighted composition of shifted and rotated parts."""

    bias = ()
    lamb = ()
    sigma = ()

    def __init__(self, device: DeviceLike = None):
        super().__init__(device)
        as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self.bias_t, self.lamb_t, self.sigma_t = as_t(self.bias), as_t(self.lamb), as_t(self.sigma)

    def _compose(self, X, fs):
        """``fs`` ``(n, N)`` part values -> the composed ``(n,)`` fitness."""
        d = X.shape[1]
        N = fs.shape[1]
        diff_sq = torch.sum((X[:, None, :] - self.shift[:N, :d][None]) ** 2, dim=-1)  # (n, N)
        inv_dist = 1.0 / torch.sqrt(diff_sq)
        w = inv_dist * torch.exp(-0.5 * diff_sq / (self.sigma_t**2 * d))
        # a row exactly at an optimum: the weight goes to the part(s) it hits
        hit = torch.isinf(inv_dist)
        any_hit = torch.any(hit, dim=1, keepdim=True)
        w_norm = torch.where(
            any_hit,
            hit / torch.clamp_min(torch.sum(hit, dim=1, keepdim=True), 1),
            w / torch.sum(w, dim=1, keepdim=True),
        )
        return torch.sum(w_norm * (self.lamb_t * fs + self.bias_t), dim=1)

    def _block(self, X, k, sh_rate=1.0, rotate=True):
        d = X.shape[1]
        shift = self.shift[k, :d]
        if rotate:
            return self._sr(X, shift, self.rot[d][k * d : (k + 1) * d], sh_rate)
        return (X - shift) * sh_rate


class F9(_CompositionCEC):
    """Composition: Rosenbrock + elliptic + bent cigar + discus + elliptic."""
    func_num = 9
    bias = (0.0, 200.0, 300.0, 100.0, 400.0)
    lamb = (1.0, 1e-6, 1e-26, 1e-6, 1e-6)
    sigma = (10.0, 20.0, 30.0, 40.0, 50.0)

    def _impl(self, X, d):
        fs = torch.stack([
            rosenbrock(self._block(X, 0, 2.048 / 100.0)),
            elliptic(self._block(X, 1)),
            bent_cigar(self._block(X, 2)),
            discus(self._block(X, 3)),
            elliptic(self._block(X, 4, rotate=False)),
        ], dim=1)
        return self._compose(X, fs)


class F10(_CompositionCEC):
    """Composition: Schwefel + Rastrigin + HGBat."""
    func_num = 10
    bias = (0.0, 200.0, 100.0)
    lamb = (1.0, 1.0, 1.0)
    sigma = (20.0, 10.0, 10.0)

    def _impl(self, X, d):
        fs = torch.stack([
            schwefel(self._block(X, 0, rotate=False)),
            rastrigin(self._block(X, 1)),
            hgbat(self._block(X, 2)),
        ], dim=1)
        return self._compose(X, fs)


class F11(_CompositionCEC):
    """Composition: Schaffer F6 + Schwefel + Griewank + Rosenbrock + Rastrigin."""
    func_num = 11
    bias = (0.0, 200.0, 300.0, 400.0, 200.0)
    lamb = (5e-4, 1.0, 10.0, 1.0, 10.0)
    sigma = (20.0, 20.0, 30.0, 30.0, 20.0)

    def _impl(self, X, d):
        fs = torch.stack([
            exp_schaffer_f6(self._block(X, 0)),
            schwefel(self._block(X, 1)),
            griewank(self._block(X, 2, 6.0)),
            rosenbrock(self._block(X, 3, 2.048 / 100.0)),
            rastrigin(self._block(X, 4)),
        ], dim=1)
        return self._compose(X, fs)

    def _threshold(self, d):
        # the reference's d-dependent round-off floor
        return {10: 5.07e-6, 20: 1.46e-5}.get(d, 1e-8)


class F12(_CompositionCEC):
    """Composition: HGBat + Rastrigin + Schwefel + bent cigar + elliptic +
    Schaffer F6 (the sixth part reuses the fifth block)."""
    func_num = 12
    bias = (0.0, 300.0, 500.0, 100.0, 400.0, 200.0)
    lamb = (10.0, 10.0, 2.5, 1e-26, 1e-6, 5e-4)
    sigma = (10.0, 20.0, 30.0, 40.0, 50.0, 60.0)

    def _impl(self, X, d):
        fs = torch.stack([
            hgbat(self._block(X, 0)),
            rastrigin(self._block(X, 1)),
            schwefel(self._block(X, 2)),
            bent_cigar(self._block(X, 3)),
            elliptic(self._block(X, 4)),
            exp_schaffer_f6(self._block(X, 4)),
        ], dim=1)
        return self._compose(X, fs)


class CEC2022TestSuite:
    """``CEC2022TestSuite.create(3) -> F3()`` (also under the reference's
    ``CEC2022TestSuit`` spelling)."""

    funcs = {i + 1: cls for i, cls in enumerate([F1, F2, F3, F4, F5, F6, F7, F8, F9, F10, F11, F12])}

    @staticmethod
    def create(func_num: int, device: DeviceLike = None) -> CEC2022Problem:
        return CEC2022TestSuite.funcs[func_num](device=device)


CEC2022TestSuit = CEC2022TestSuite
