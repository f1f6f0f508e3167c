"""Shared ES helpers — the port of ``evox_tpu/algorithms/so/es/common.py``.

Step-size rails, the dense-covariance scale guard, the eigendecomposition
with its condition cap and non-finite fallback, and the CMA-family
recombination weights. The weights are computed on the CPU in float32, in
the JAX package's order of operations, and moved to the algorithm's device:
the card and the CPU use the same numbers.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch

from ....utils.common import generator, seeded

__all__ = [
    "MAX_LOG_SIGMA_STEP",
    "EighScaleError",
    "bounded_sigma_step",
    "capped_mu_weights",
    "check_dense_scale",
    "clamp_step_size",
    "f32_sqrt",
    "full_f32_matmul",
    "mueff_of",
    "recombination_weights",
    "safe_eigh",
    "sorted_selection_moments",
    "standard_normal",
    "weights_at_ranks",
]

# largest per-generation |Δ log sigma| of the large-population-safe update:
# ln 2, sigma at most doubles or halves in a generation (the JAX package's
# value; the clamp is the identity at conventional population sizes)
MAX_LOG_SIGMA_STEP = 0.6931471805599453


def clamp_step_size(sigma: torch.Tensor, floor: float = 1e-20, ceiling: float = 1e20) -> torch.Tensor:
    """Clamp an ES step size into ``[floor, ceiling]``: the identity for a
    step size in range, a rail for one collapsing to 0 or growing to inf.
    NaN passes through."""
    return torch.clamp(sigma, floor, ceiling)


def bounded_sigma_step(
    sigma: torch.Tensor,
    log_step: torch.Tensor,
    floor: float = 1e-20,
    ceiling: float = 1e20,
    max_log_step: float = MAX_LOG_SIGMA_STEP,
) -> torch.Tensor:
    """``sigma * exp(log_step)`` with the log-step clamped into
    ``[-max_log_step, max_log_step]``, then railed by :func:`clamp_step_size`."""
    step = torch.clamp(log_step, -max_log_step, max_log_step)
    return clamp_step_size(sigma * torch.exp(step), floor, ceiling)


class EighScaleError(RuntimeError):
    """A full-covariance CMA variant was asked for a ``dim`` or ``pop`` past
    the single-device dense wall (an O(dim^3) ``eigh`` or an O(pop*dim)
    sample matrix). Raised at construction, before any work; the way out is
    the low-memory track (SepCMAES, LMMAES, RMES)."""


def check_dense_scale(
    dim: int,
    pop_size: int,
    eigh_max_dim: Optional[int],
    dense_budget_elems: Optional[int],
    where: str = "CMAES",
) -> None:
    """Refuse a dense (full-covariance) CMA configuration past either limit;
    ``None`` disables a limit."""
    if eigh_max_dim is not None and dim > eigh_max_dim:
        raise EighScaleError(
            f"{where}: dim={dim} exceeds eigh_max_dim={eigh_max_dim}: the "
            "O(dim^3) eigendecomposition of the full covariance would stall "
            "one device. Use the low-memory track instead (SepCMAES for a "
            "diagonal, LMMAES or RMES for a low-rank covariance), or raise "
            "eigh_max_dim explicitly."
        )
    if dense_budget_elems is not None and pop_size * dim > dense_budget_elems:
        raise EighScaleError(
            f"{where}: pop_size*dim = {pop_size}*{dim} = {pop_size * dim} "
            f"elements exceeds dense_budget_elems={dense_budget_elems}: the "
            "dense track holds the full (pop, dim) sample matrix and its "
            "sorted copies. Use SepCMAES, LMMAES or RMES, or raise "
            "dense_budget_elems."
        )


def recombination_weights(mu: int, mu_half: Optional[float] = None) -> torch.Tensor:
    """The CMA-family log-rank weights ``w_r ∝ log(mu_half / r)``, r = 1..µ,
    summing to 1, as a float32 CPU tensor.

    Computed as the JAX package does, in float32: each raw weight as
    ``log1p((mu_half - r) / r)`` (no cancellation at large µ), normalised
    through a max-subtracted ``logsumexp`` of their logs. ``mu_half``
    defaults to ``mu + 0.5``."""
    if mu < 1:
        raise ValueError(f"mu must be >= 1, got {mu}")
    half = float(mu + 0.5) if mu_half is None else float(mu_half)
    if half <= mu:
        raise ValueError(f"mu_half ({half}) must exceed mu ({mu})")
    r = torch.arange(1, mu + 1, dtype=torch.float32)
    raw = torch.log1p((half - r) / r)
    lw = torch.log(raw)
    return torch.exp(lw - torch.logsumexp(lw, dim=0))


def mueff_of(weights: torch.Tensor) -> float:
    """``sum(w)^2 / sum(w^2)``, in float32 as the JAX package computes it."""
    w = weights.to(torch.float32)
    return float(torch.sum(w) ** 2 / torch.sum(w**2))


def capped_mu_weights(lam: int, mu: Optional[int] = None, mu_half_prefactor: bool = False):
    """``(mu, weights)``: ``mu=None`` is the untruncated half ``lam // 2``
    with the ``(lam + 1) / 2`` prefactor; an explicit ``mu`` below it is the
    large-population parent cap, with the ``mu + 0.5`` prefactor
    (``mu_half_prefactor=True`` forces that prefactor, as RMES does). A
    ``mu`` outside ``[1, lam // 2]`` raises."""
    if mu is not None and not (1 <= mu <= lam // 2):
        raise ValueError(
            f"mu must be in [1, lam // 2 = {lam // 2}] (got {mu}); the "
            "log-rank truncation weights select from the better half at most"
        )
    capped = mu is not None and mu < lam // 2
    mu = mu if mu is not None else lam // 2
    half = (mu + 0.5) if (capped or mu_half_prefactor) else (lam + 1) / 2
    return mu, recombination_weights(mu, half)


def sorted_selection_moments(algo, state, fitness: torch.Tensor):
    """The tell's moments: a stable sort of the fitness, the top-µ rows of
    each of ``algo.pop_fields``, weighted through ``algo.pop_moments``.
    Returns ``(moments, order)``."""
    order = torch.argsort(fitness, stable=True)
    rows = {name: getattr(state, name)[order[: algo.mu]] for name in algo.pop_fields}
    return algo.pop_moments(rows, algo.weights), order


def weights_at_ranks(weights: torch.Tensor, ranks: torch.Tensor, mu: int) -> torch.Tensor:
    """Each candidate's recombination weight from its 0-based fitness rank:
    ``weights[rank]`` for the top-µ, 0 beyond."""
    safe = torch.clamp(ranks, 0, mu - 1)
    return torch.where(ranks < mu, weights[safe], torch.zeros((), dtype=weights.dtype,
                                                               device=weights.device))


def safe_eigh(
    C: torch.Tensor, cond_cap: float = 1e14, max_dim: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, D)``: the eigenvectors of the symmetrised covariance and the
    per-axis standard deviations, the square roots of its eigenvalues
    clamped into ``[max_eig / cond_cap, max_eig]``.

    ``jnp.linalg.eigh`` returns NaN for a matrix it cannot decompose, and
    the JAX function then falls back to ``(I, ones)``. ``torch.linalg.eigh``
    raises instead. So the matrix handed to it is the identity wherever C
    holds a non-finite entry, and the fallback is chosen on the device with
    ``torch.where``: no exception and no extra host read (on the card,
    ``eigh`` itself waits for the host once a call).

    ``B`` is unique only up to the sign of each column and a basis of each
    degenerate eigenspace, so it can differ from the JAX package's; ``B
    diag(D^2) B^T`` and ``D`` do not. ``max_dim`` raises
    :class:`EighScaleError` for a wider matrix.
    """
    n = C.shape[0]
    if max_dim is not None and n > max_dim:
        raise EighScaleError(
            f"safe_eigh: covariance is {n}x{n}, past max_dim={max_dim}: the "
            "O(dim^3) eigh would stall one device. Switch to the low-memory "
            "track (SepCMAES, LMMAES, RMES) or raise max_dim explicitly."
        )
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    C = (C + C.T) / 2.0
    finite = torch.isfinite(C).all()
    eigvals, B = torch.linalg.eigh(torch.where(finite, C, eye))
    max_eig = torch.clamp_min(torch.max(eigvals), 1e-20)
    D = torch.sqrt(torch.minimum(torch.maximum(eigvals, max_eig / cond_cap), max_eig))
    ok = finite & torch.isfinite(B).all() & torch.isfinite(D).all()
    return torch.where(ok, B, eye), torch.where(ok, D, torch.ones_like(D))


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """cuBLAS float32 matrix products in full float32 (IEEE) inside the
    block, whatever the process's TF32 setting outside it (TF32's 10-bit
    mantissa would move CMA-ES's sampling and covariance updates by ~1e-3
    relative on the card, not on the CPU). The setting is restored on exit,
    through the same interface that read it: ``fp32_precision`` where
    PyTorch has it (mixing it with ``allow_tf32`` otherwise raises), else
    ``allow_tf32``."""
    cublas = torch.backends.cuda.matmul
    name, full = ("fp32_precision", "ieee") if hasattr(cublas, "fp32_precision") else ("allow_tf32", False)
    was = getattr(cublas, name)
    setattr(cublas, name, full)
    try:
        yield
    finally:
        setattr(cublas, name, was)


def standard_normal(seed: int, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Float32 standard normals of ``shape`` on ``device`` from ``seed``:
    what the ES family's draw methods return."""
    return seeded(seed, device, lambda g: torch.randn(shape, generator=g, device=device,
                                                      dtype=torch.float32))


def f32_sqrt(x: float) -> float:
    """``jnp.sqrt`` of a Python float: the square root rounded in float32
    (it can differ from ``math.sqrt`` in the last bit)."""
    return float(torch.sqrt(torch.tensor(x, dtype=torch.float32)))
