"""Exact Gaussian-process regression — the port of
``evox_tpu/operators/gaussian_process/regression.py``.

RBF kernel, a Cholesky solve of the marginal likelihood, and the three
log-hyperparameters fitted by adam (``utils/optimizers.Adam``, optax's
arithmetic). The hyperparameters travel through the optimizer as one
``(..., 3)`` tensor, so a fit takes a leading batch of independent GPs
(IM-MOEA's cluster × variable grid) in one set of launches: the loss is
the sum of the items' negative log likelihoods, and each item's gradient
is its own.

A matrix that is not positive definite factors to NaN, as
``jnp.linalg.cholesky`` does: :func:`cholesky_or_nan` takes
``cholesky_ex`` without its host check and writes NaN where it failed, so
a failed fit costs no host read.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode
from ...utils.common import generator
from ...utils.optimizers import Adam

# squared-difference elements of one distance chunk (1 GiB of float32 at
# GPSurrogate's bound, capacity 2048 and d 64, without chunking)
_DIST_CHUNK = 1 << 26


class GPParams(PyTreeNode):
    log_lengthscale: torch.Tensor
    log_variance: torch.Tensor
    log_noise: torch.Tensor

    def packed(self) -> torch.Tensor:
        """The ``(..., 3)`` tensor the optimizer updates."""
        return torch.stack([self.log_lengthscale, self.log_variance, self.log_noise], dim=-1)

    @staticmethod
    def unpack(p: torch.Tensor) -> "GPParams":
        return GPParams(log_lengthscale=p[..., 0], log_variance=p[..., 1], log_noise=p[..., 2])


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., n, t)`` squared distances between the rows of ``a`` ``(...,
    n, d)`` and ``b`` ``(..., t, d)`` in the difference form
    ``((a_i - b_j) ** 2).sum(-1)`` (the matmul expansion cancels near the
    archived points), in row chunks of at most ``_DIST_CHUNK`` elements."""
    n, t, d = a.shape[-2], b.shape[-2], a.shape[-1]
    batch = math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    rows = max(1, _DIST_CHUNK // max(1, batch * t * d))
    if rows >= n:
        return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
    return torch.cat([((a[..., lo:lo + rows, None, :] - b[..., None, :, :]) ** 2).sum(-1)
                      for lo in range(0, n, rows)], dim=-2)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``a``; a matrix that is not
    positive definite gives an all-NaN factor (``jnp.linalg.cholesky``'s
    result), with no host read of the factorisation's status. The NaN is
    added, so it also reaches the gradient, as JAX's does."""
    L, info = torch.linalg.cholesky_ex(a)
    return L + torch.where(info != 0, float("nan"), 0.0).to(L.dtype)[..., None, None]


def _rbf(x1: torch.Tensor, x2: torch.Tensor, params: GPParams) -> torch.Tensor:
    ls = torch.exp(params.log_lengthscale)[..., None, None]
    var = torch.exp(params.log_variance)[..., None, None]
    return var * torch.exp(-0.5 * sq_dists(x1, x2) / ls**2)


def _log_2pi(like: torch.Tensor) -> torch.Tensor:
    # jnp.log(2.0 * jnp.pi): float32 log of the float32 constant (a fill,
    # not a copy of a host scalar, which would wait for the stream)
    return torch.log(torch.full((), 2.0 * math.pi, dtype=torch.float32, device=like.device))


def _noisy_kernel(params: GPParams, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-2]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    noise = (torch.exp(params.log_noise) + 1e-6)[..., None, None]
    return _rbf(x, x, params) + noise * eye


def _nll(params: GPParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood of each item, shape ``y.shape[:-1]``."""
    n = x.shape[-2]
    L = cholesky_or_nan(_noisy_kernel(params, x))
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    return (0.5 * (y * alpha).sum(-1)
            + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * n * _log_2pi(y))


def fit_params(init: torch.Tensor, loss_fn, optimizer: Adam, steps: int) -> torch.Tensor:
    """``steps`` optimizer steps on the packed parameters ``init`` against
    ``loss_fn(params) -> scalar``, gradients by autograd."""
    p = init.detach().clone()
    opt_state = optimizer.init(p)
    with torch.enable_grad():
        for _ in range(steps):
            leaf = p.requires_grad_(True)
            (grad,) = torch.autograd.grad(loss_fn(leaf), leaf)
            updates, opt_state = optimizer.update(grad, opt_state)
            p = (leaf + updates).detach()
    return p


class GPRegression:
    """``fit(x, y)`` then ``predict(model, x*) -> (mean, var)``.

    Inputs ``(n, d)``, or ``(n,)`` (one feature); targets ``(n,)``. Any
    leading axes of ``y`` are a batch of independent GPs: ``x`` then has
    the same leading axes (``(..., n)`` or ``(..., n, d)``), the model's
    parameters those axes too, and ``predict`` takes ``(..., t)`` or
    ``(..., t, d)``. ``device``: where the initial hyperparameters live;
    ``None`` means ``"cuda"``."""

    def __init__(
        self,
        lengthscale: float = 1.0,
        variance: float = 1.0,
        noise: float = 1e-2,
        fit_steps: int = 50,
        learning_rate: float = 0.1,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        f32 = lambda v: torch.log(torch.tensor(v, dtype=torch.float32, device=self.device))
        self.init_params = GPParams(log_lengthscale=f32(lengthscale), log_variance=f32(variance),
                                    log_noise=f32(noise))
        self.fit_steps = fit_steps
        self.opt = Adam(learning_rate)

    @staticmethod
    def _shape(x: torch.Tensor, batch_ndim: int = 0) -> torch.Tensor:
        """``x`` with a feature axis: ``(..., n)`` becomes ``(..., n, 1)``
        when it has only the ``batch_ndim`` leading axes besides rows."""
        return x[..., None] if x.ndim == batch_ndim + 1 else x

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[GPParams, torch.Tensor, torch.Tensor]:
        """Hyperparameters by marginal likelihood; returns ``(params, x,
        y)``, the fitted model."""
        batch = y.shape[:-1]
        x = self._shape(x, len(batch))
        y_mean = y.mean(-1, keepdim=True)
        yc = y - y_mean
        init = self.init_params.packed().expand(*batch, 3)
        p = fit_params(init, lambda q: _nll(GPParams.unpack(q), x, yc).sum(), self.opt,
                       self.fit_steps)
        return (GPParams.unpack(p), x, yc + y_mean)

    def predict(self, model, x_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        params, x, y = model
        x_test = self._shape(x_test, y.ndim - 1)
        y_mean = y.mean(-1, keepdim=True)
        yc = y - y_mean
        L = cholesky_or_nan(_noisy_kernel(params, x))
        alpha = torch.cholesky_solve(yc[..., None], L)
        Ks = _rbf(x_test, x, params)  # (..., t, n)
        mean = (Ks @ alpha)[..., 0] + y_mean
        v = torch.linalg.solve_triangular(L, Ks.transpose(-1, -2), upper=False)
        var = torch.clamp(torch.exp(params.log_variance)[..., None] - (v**2).sum(-2), min=1e-12)
        return mean, var

    def sample(self, seed: int, model, x_test: torch.Tensor,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + sqrt(var) * z`` at ``x_test``; ``z``, the standard
        normals, drawn from ``seed`` when not given."""
        mean, var = self.predict(model, x_test)
        if z is None:
            z = torch.randn(mean.shape, generator=generator(seed, mean.device), device=mean.device)
        return mean + torch.sqrt(var) * z
