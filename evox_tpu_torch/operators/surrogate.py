"""Surrogate models for pre-screening expensive evaluations — the port of
``evox_tpu/operators/surrogate.py``.

A fixed-capacity paired (candidate, fitness) archive ring and two
interchangeable models behind one ``fit``/``predict -> (mean,
uncertainty)`` interface, consumed by
:class:`~evox_tpu_torch.workflows.surrogate.SurrogateWorkflow`. Every
method is tensor code at fixed shapes with no host read, so a refit queues
on the card's stream and the generation loop goes on.

- :class:`GPSurrogate`: an exact GP (RBF kernel, one float32 Cholesky).
  The lengthscale is the masked mean pairwise squared distance and the
  amplitude the masked fitness variance, so ``fit`` is deterministic;
  dead archive rows get a 1e8 diagonal. Capacities past ``max_capacity``
  raise :class:`GPCapacityError`, naming the ensemble.
- :class:`EnsembleSurrogate`: ``n_members`` MLPs (dim → hidden → hidden →
  1, tanh) trained by full-batch adam on the standardized archive; the
  members are one member-stacked tensor (batched products over the member
  axis), so a step is one set of launches whatever the member count. The
  prediction is the ensemble mean, the uncertainty the members' spread.
  Every initial weight of a fit comes from one ``_draw``, which tests
  replace with the JAX package's draws.

The states carry the JAX package's storage annotations: archived
candidates ``storage=True`` (they rest in bfloat16 under ``BF16_STORAGE``),
fitness and every factorisation product ``storage=False``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.struct import PyTreeNode, field
from ..utils.common import generator
from ..utils.optimizers import Adam
from ..utils.ring import ring_scatter_indices
from .gaussian_process.regression import cholesky_or_nan, fit_params, sq_dists

__all__ = [
    "ArchiveState",
    "SurrogateArchive",
    "GPCapacityError",
    "GPModelState",
    "GPSurrogate",
    "EnsembleModelState",
    "EnsembleSurrogate",
    "spearman_correlation",
]


# ------------------------------------------------------------------ archive


class ArchiveState(PyTreeNode):
    """Paired (candidate, fitness) ring: ``count`` is the total writes
    ever, slot ``count % capacity`` the next write, so once full the
    oldest pairs are overwritten."""

    x: torch.Tensor = field(storage=True)  # (capacity, dim)
    y: torch.Tensor = field(storage=False)  # (capacity,) float32
    count: torch.Tensor = field()  # () int32 total writes ever


class SurrogateArchive:
    """Fixed-capacity archive of evaluated (candidate, fitness) pairs.
    ``capacity`` must be at least the widest batch one ``update`` writes."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)

    def init(self, dim: int, dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> ArchiveState:
        dev = resolve_device(device)
        return ArchiveState(
            x=torch.zeros((self.capacity, dim), dtype=dtype, device=dev),
            y=torch.full((self.capacity,), float("inf"), device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def update(self, astate: ArchiveState, x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> ArchiveState:
        """Append the ``mask``-selected rows of ``(x, y)`` at the ring head.
        The other rows go to one spare slot past the end that is cut off
        (JAX's ``mode="drop"`` scatter), so the write has the same shape
        however many rows were truly evaluated, and reads nothing back."""
        if x.shape[0] > self.capacity:
            raise ValueError(
                f"batch of {x.shape[0]} rows exceeds archive capacity "
                f"{self.capacity}; a single update's scatter would "
                "collide with itself inside the ring — size the archive "
                "to at least the widest evaluated batch"
            )
        idx, count = ring_scatter_indices(astate.count, mask, self.capacity)
        idx = idx.to(torch.int64)

        def scatter(buf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
            spare = torch.cat([buf, buf[:1]])
            return spare.index_copy(0, idx, rows.to(buf.dtype))[: self.capacity]

        return ArchiveState(x=scatter(astate.x, x), y=scatter(astate.y, y), count=count)

    def fill(self, astate: ArchiveState) -> torch.Tensor:
        """() int32: how many slots hold real pairs."""
        return torch.clamp(astate.count, max=self.capacity)

    def valid_mask(self, astate: ArchiveState) -> torch.Tensor:
        """(capacity,) bool: the first ``min(count, capacity)`` slots."""
        return torch.arange(self.capacity, device=astate.count.device) < self.fill(astate)


# ------------------------------------------------------------- rank health


def spearman_correlation(a: torch.Tensor, b: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked Spearman rank correlation of two ``(n,)`` vectors, a 0-d
    float32 tensor. Rows outside ``mask`` or non-finite in either vector
    are ranked last and left out; fewer than 3 valid rows give 1.0. Ranks
    are a double stable argsort, as ``jnp.argsort``'s."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if mask is None:
        mask = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    mask = mask & torch.isfinite(a) & torch.isfinite(b)
    n = mask.to(torch.float32).sum()

    def rank(v):
        key = torch.where(mask, v, float("inf"))
        return torch.argsort(torch.argsort(key, stable=True), stable=True).to(torch.float32)

    ra, rb = rank(a), rank(b)
    zero = torch.zeros((), device=a.device)
    n_safe = torch.clamp(n, min=1.0)
    ma = torch.where(mask, ra, zero).sum() / n_safe
    mb = torch.where(mask, rb, zero).sum() / n_safe
    da = torch.where(mask, ra - ma, zero)
    db = torch.where(mask, rb - mb, zero)
    corr = (da * db).sum() / torch.clamp(torch.sqrt((da**2).sum() * (db**2).sum()), min=1e-12)
    return torch.where(n < 3, torch.ones((), device=a.device), torch.clamp(corr, -1.0, 1.0))


# ------------------------------------------------------------------ GP model


class GPCapacityError(RuntimeError):
    """The exact GP's dense ``(capacity, capacity)`` Cholesky exceeds its
    budget: refused at construction, naming the ensemble handoff."""


class GPModelState(PyTreeNode):
    """A fitted exact-GP posterior: ``predict`` is one cross-covariance and
    two triangular solves. Every field is float32 and stays so."""

    x: torch.Tensor = field(storage=False)  # (cap, dim)
    chol: torch.Tensor = field(storage=False)  # (cap, cap)
    alpha: torch.Tensor = field(storage=False)  # (cap,)
    y_mean: torch.Tensor = field()  # () masked mean of y
    lengthscale2: torch.Tensor = field()  # () squared RBF scale
    amplitude: torch.Tensor = field()  # () kernel variance


class GPSurrogate:
    """Exact Gaussian-process surrogate: RBF kernel, one float32 Cholesky,
    kernel scales from masked data statistics (no optimizer loop; the
    optimizer-fitted API is :class:`~evox_tpu_torch.operators.
    gaussian_process.GPRegression`).

    Args:
        noise: observation noise floor, times the amplitude, on the
            diagonal.
        max_capacity: dense-scale bound; archives past it raise
            :class:`GPCapacityError`.
        device: where ``init_model`` builds the prior; ``None`` means
            ``"cuda"``.
    """

    kind = "gp"

    def __init__(self, noise: float = 1e-4, max_capacity: int = 2048, device: DeviceLike = None):
        self.noise = float(noise)
        self.max_capacity = int(max_capacity)
        self.device = resolve_device(device)

    def check_capacity(self, capacity: int) -> None:
        if capacity > self.max_capacity:
            raise GPCapacityError(
                f"GPSurrogate: archive capacity {capacity} exceeds "
                f"max_capacity={self.max_capacity} — the exact GP is one "
                f"dense ({capacity}, {capacity}) Cholesky per refit "
                "(O(capacity^3)). Use EnsembleSurrogate for large "
                "archives, or raise max_capacity to override."
            )

    def init_model(self, capacity: int, dim: int) -> GPModelState:
        """The untrained prior: zero mean, the prior amplitude as
        uncertainty (the workflow screens nothing until the first fit)."""
        self.check_capacity(capacity)
        dev = self.device
        one = torch.ones((), device=dev)
        return GPModelState(
            x=torch.zeros((capacity, dim), device=dev),
            chol=torch.eye(capacity, device=dev),
            alpha=torch.zeros((capacity,), device=dev),
            y_mean=torch.zeros((), device=dev),
            lengthscale2=one,
            amplitude=one.clone(),
        )

    def fit(self, model: GPModelState, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
            seed: Optional[int] = None) -> GPModelState:
        """Refit the posterior on the masked archive. ``seed`` is accepted
        (and unused: the fit is deterministic) so both model kinds share
        one call signature."""
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        mask = mask & torch.isfinite(y)
        fmask = mask.to(torch.float32)
        zero = torch.zeros((), device=y.device)
        n = torch.clamp(fmask.sum(), min=1.0)
        y_mean = torch.where(mask, y, zero).sum() / n
        yc = torch.where(mask, y - y_mean, zero)
        amplitude = torch.clamp(torch.where(mask, (y - y_mean) ** 2, zero).sum() / n, min=1e-8)
        d2 = sq_dists(x, x)
        pair_w = fmask[:, None] * fmask[None, :]
        ls2 = torch.clamp((d2 * pair_w).sum() / torch.clamp(pair_w.sum(), min=1.0), min=1e-8)
        K = amplitude * torch.exp(-0.5 * d2 / ls2)
        # dead rows get a huge diagonal: their posterior weight is ~0
        noise_vec = self.noise * amplitude + torch.where(mask, zero, torch.full_like(zero, 1e8))
        L = cholesky_or_nan(K + torch.diag(noise_vec))
        alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
        return GPModelState(x=x, chol=L, alpha=alpha, y_mean=y_mean, lengthscale2=ls2,
                            amplitude=amplitude)

    def predict(self, model: GPModelState, x_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, uncertainty) at ``x_test`` ``(t, dim)``: the posterior mean
        and standard deviation."""
        x_test = x_test.to(torch.float32)
        Ks = model.amplitude * torch.exp(-0.5 * sq_dists(x_test, model.x) / model.lengthscale2)
        mean = Ks @ model.alpha + model.y_mean
        v = torch.linalg.solve_triangular(model.chol, Ks.T, upper=False)
        var = torch.clamp(model.amplitude - (v**2).sum(0), min=1e-12)
        return mean, torch.sqrt(var)


# ------------------------------------------------------------ ensemble model


class EnsembleModelState(PyTreeNode):
    """A fitted deep ensemble: member-stacked MLP weights (``w1`` ``(M,
    dim, h)``, ``b1`` ``(M, h)``, ``w2``, ``b2``, ``w3`` ``(M, h, 1)``,
    ``b3`` ``(M, 1)``) and the masked standardization they were trained
    under."""

    params: Any = field()
    x_mean: torch.Tensor = field()  # (dim,)
    x_scale: torch.Tensor = field()  # (dim,)
    y_mean: torch.Tensor = field()  # ()
    y_scale: torch.Tensor = field()  # ()


_LAYERS = ("w1", "b1", "w2", "b2", "w3", "b3")


class EnsembleSurrogate:
    """Deep-ensemble MLP surrogate trained with adam: ``n_members`` MLPs
    (dim → hidden → hidden → 1, tanh), ``fit_steps`` full-batch steps on
    the standardized masked archive, every member retrained from fresh
    weights each fit. ``predict``: the de-standardized ensemble mean and
    the members' spread (std over members). ``device``: ``None`` means
    ``"cuda"``."""

    kind = "ensemble"

    def __init__(self, n_members: int = 4, hidden: int = 32, fit_steps: int = 150,
                 learning_rate: float = 1e-2, device: DeviceLike = None):
        if n_members < 2:
            raise ValueError(
                f"n_members must be >= 2 (disagreement needs a spread), got {n_members}"
            )
        self.n_members = int(n_members)
        self.hidden = int(hidden)
        self.fit_steps = int(fit_steps)
        self.opt = Adam(learning_rate)
        self.device = resolve_device(device)

    # -- MLP plumbing (the member axis leads every weight) -------------------
    def _draw(self, seed: int, dim: int) -> dict:
        """A fit's draws: the standard normals of ``w1`` ``(M, dim, h)``,
        ``w2`` ``(M, h, h)`` and ``w3`` ``(M, h, 1)``."""
        g = generator(seed, self.device)
        M, h = self.n_members, self.hidden
        return {name: torch.randn(shape, generator=g, device=self.device)
                for name, shape in (("w1", (M, dim, h)), ("w2", (M, h, h)), ("w3", (M, h, 1)))}

    def _init_params(self, seed: int, dim: int) -> dict:
        z = self._draw(seed, dim)
        M, h = self.n_members, self.hidden
        # 1/sqrt in float32, as jnp computes it (a fill: no host copy)
        inv_sqrt = lambda v: 1.0 / torch.sqrt(torch.full((), float(v), device=self.device))
        zeros = lambda *shape: torch.zeros(shape, device=self.device)
        return {
            "w1": z["w1"] * inv_sqrt(max(dim, 1)),
            "b1": zeros(M, h),
            "w2": z["w2"] * inv_sqrt(h),
            "b2": zeros(M, h),
            "w3": z["w3"] * inv_sqrt(h),
            "b3": zeros(M, 1),
        }

    @staticmethod
    def _forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        """``(M, n)`` predictions of every member at ``x`` ``(n, dim)``."""
        h = torch.tanh(x @ params["w1"] + params["b1"][:, None, :])
        h = torch.tanh(h @ params["w2"] + params["b2"][:, None, :])
        return (h @ params["w3"] + params["b3"][:, None, :])[..., 0]

    @staticmethod
    def _pack(params: dict) -> torch.Tensor:
        M = params["w1"].shape[0]
        return torch.cat([params[k].reshape(M, -1) for k in _LAYERS], dim=1)

    @staticmethod
    def _unpack(flat: torch.Tensor, like: dict) -> dict:
        out, at = {}, 0
        for k in _LAYERS:
            size = like[k][0].numel()
            out[k] = flat[:, at:at + size].reshape(like[k].shape)
            at += size
        return out

    def init_model(self, capacity: int, dim: int) -> EnsembleModelState:
        del capacity  # the ensemble has no dense-capacity bound
        dev = self.device
        return EnsembleModelState(
            params=self._init_params(0, dim),
            x_mean=torch.zeros((dim,), device=dev),
            x_scale=torch.ones((dim,), device=dev),
            y_mean=torch.zeros((), device=dev),
            y_scale=torch.ones((), device=dev),
        )

    def fit(self, model: EnsembleModelState, x: torch.Tensor, y: torch.Tensor,
            mask: torch.Tensor, seed: int) -> EnsembleModelState:
        """Retrain every member from fresh weights drawn from ``seed`` on the
        masked, standardized archive: ``fit_steps`` adam steps, all members
        in each step's launches."""
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        dim = x.shape[1]
        mask = mask & torch.isfinite(y)
        fmask = mask.to(torch.float32)
        zero = torch.zeros((), device=y.device)
        n = torch.clamp(fmask.sum(), min=1.0)
        x_mean = torch.where(mask[:, None], x, zero).sum(0) / n
        x_var = torch.where(mask[:, None], (x - x_mean) ** 2, zero).sum(0) / n
        x_scale = torch.sqrt(torch.clamp(x_var, min=1e-8))
        y_mean = torch.where(mask, y, zero).sum() / n
        y_var = torch.where(mask, (y - y_mean) ** 2, zero).sum() / n
        y_scale = torch.sqrt(torch.clamp(y_var, min=1e-8))
        xs = (x - x_mean) / x_scale
        ys = torch.where(mask, (y - y_mean) / y_scale, zero)
        like = self._init_params(seed, dim)

        def loss(flat):
            pred = self._forward(self._unpack(flat, like), xs)
            # the members' losses summed: each member's gradient is its own
            return ((fmask * (pred - ys) ** 2).sum(1) / n).sum()

        flat = fit_params(self._pack(like), loss, self.opt, self.fit_steps)
        params = {k: v.contiguous() for k, v in self._unpack(flat, like).items()}
        return EnsembleModelState(params=params, x_mean=x_mean, x_scale=x_scale, y_mean=y_mean,
                                  y_scale=y_scale)

    def predict(self, model: EnsembleModelState, x_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, uncertainty): the de-standardized ensemble mean and the
        members' spread."""
        xs = (x_test.to(torch.float32) - model.x_mean) / model.x_scale
        preds = self._forward(model.params, xs)
        mean = preds.mean(0) * model.y_scale + model.y_mean
        return mean, preds.std(0, correction=0) * model.y_scale
