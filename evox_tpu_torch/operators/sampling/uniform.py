"""Das–Dennis simplex-lattice reference vectors — the port of
``evox_tpu/operators/sampling/uniform.py``.

The lattice is static data enumerated on the host with numpy (a
combinatorial enumeration, not device math), then moved to the device
once."""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device


def _simplex_lattice(h: int, m: int) -> np.ndarray:
    """All compositions of h into m nonnegative parts, divided by h."""
    # stars and bars: choose bar positions among h+m-1 slots
    combos = np.array(list(combinations(range(h + m - 1), m - 1)), dtype=np.int64)
    if combos.size == 0:
        return np.full((1, m), 1.0 / m)
    edges = np.concatenate(
        [combos, np.full((combos.shape[0], 1), h + m - 1, dtype=np.int64)], axis=1
    )
    prev = np.concatenate([np.full((combos.shape[0], 1), -1, dtype=np.int64), combos], axis=1)
    return (edges - prev - 1).astype(np.float64) / h


class UniformSampling:
    """``UniformSampling(n, m)() -> (weights (n', m), n')`` with n' ≈ n.

    ``device``: where the weights go; ``None`` means ``"cuda"``."""

    def __init__(self, n: int, m: int, device: DeviceLike = None):
        self.n = n
        self.m = m
        self.device = resolve_device(device)

    def __call__(self) -> Tuple[torch.Tensor, int]:
        m, n = self.m, self.n
        h1 = 1
        while comb(h1 + m, m - 1) <= n:
            h1 += 1
        w = _simplex_lattice(h1, m)
        if h1 < m:
            # two-layer NBI: add an inner layer shrunk toward the centroid
            h2 = 0
            while comb(h1 + m - 1, m - 1) + comb(h2 + m, m - 1) <= n:
                h2 += 1
            if h2 > 0:
                w2 = _simplex_lattice(h2, m) / 2.0 + 1.0 / (2.0 * m)
                w = np.concatenate([w, w2], axis=0)
        w = np.maximum(w, 1e-6)
        return torch.from_numpy(w.astype(np.float32)).to(self.device), w.shape[0]
