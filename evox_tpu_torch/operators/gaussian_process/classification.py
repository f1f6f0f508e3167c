"""GP binary classification with a Bernoulli likelihood (Laplace
approximation) — the port of
``evox_tpu/operators/gaussian_process/classification.py``.

:class:`GPClassification` is Rasmussen & Williams' Laplace scheme
(Algorithms 3.1/3.2): a fixed number of Newton steps to the posterior mode
of the latent function under a logistic likelihood, the predictive
variance through the Cholesky factor of ``B = I + W^1/2 K W^1/2``, and
MacKay's probit squashing for the probabilities. ``fit_steps > 0`` fits
(lengthscale, variance) against the Laplace evidence, with gradients by
autograd through the Newton solve.

:class:`ProbitLabelRegression` is the cheap baseline: GP regression on ±1
labels, probit-squashed at predict time.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...core.device import DeviceLike, resolve_device
from ...core.struct import PyTreeNode
from ...utils.optimizers import Adam
from .regression import GPParams, GPRegression, _rbf, cholesky_or_nan, fit_params


class LaplaceModel(PyTreeNode):
    params: GPParams
    x: torch.Tensor  # (n, d) training inputs
    y: torch.Tensor  # (n,) labels in {-1, +1}
    f_hat: torch.Tensor  # (n,) latent posterior mode


def _jittered_kernel(params: GPParams, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return _rbf(x, x, params) + 1e-6 * torch.eye(n, dtype=x.dtype, device=x.device)


def _b_factor(K: torch.Tensor, pi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(W, sqrt(W), chol(I + W^1/2 K W^1/2))`` at the probabilities ``pi``."""
    W = torch.clamp(pi * (1.0 - pi), min=1e-10)
    sW = torch.sqrt(W)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return W, sW, cholesky_or_nan(eye + sW[:, None] * K * sW[None, :])


def _newton_mode(params: GPParams, x: torch.Tensor, y: torch.Tensor, steps: int) -> torch.Tensor:
    """Posterior mode of the latent f (R&W Algorithm 3.1, a fixed number
    of steps)."""
    K = _jittered_kernel(params, x)
    t = (y + 1.0) / 2.0
    f = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(steps):
        pi = torch.sigmoid(f)
        W, sW, L = _b_factor(K, pi)
        b = W * f + (t - pi)
        a = b - sW * torch.cholesky_solve((sW * (K @ b))[:, None], L)[:, 0]
        f = K @ a
    return f


def _laplace_neg_evidence(params: GPParams, x: torch.Tensor, y: torch.Tensor,
                          steps: int) -> torch.Tensor:
    """-log q(y | X, theta) under the Laplace approximation (R&W 3.32)."""
    f_hat = _newton_mode(params, x, y, steps)
    K = _jittered_kernel(params, x)
    pi = torch.sigmoid(f_hat)
    _, _, L = _b_factor(K, pi)
    # at the mode K a = f_hat with a = t - pi: no solve with K
    a = (y + 1.0) / 2.0 - pi
    log_lik = F.logsigmoid(y * f_hat).sum()
    return 0.5 * (f_hat @ a) - log_lik + torch.log(torch.diagonal(L)).sum()


class GPClassification:
    """Laplace-Bernoulli GP classifier: ``fit(x, y)`` with labels in {0, 1}
    or {-1, +1}, then ``predict_proba``/``predict_label``.

    ``fit_steps > 0`` also fits (lengthscale, variance) by the approximate
    marginal likelihood (adam, gradients through the Newton solve).
    ``device``: ``None`` means ``"cuda"``."""

    def __init__(
        self,
        lengthscale: float = 1.0,
        variance: float = 1.0,
        newton_steps: int = 15,
        fit_steps: int = 0,
        learning_rate: float = 0.1,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        f32 = lambda v: torch.log(torch.tensor(v, dtype=torch.float32, device=self.device))
        self.init_params = GPParams(log_lengthscale=f32(lengthscale), log_variance=f32(variance),
                                    log_noise=f32(1e-6))  # unused by the likelihood
        self.newton_steps = newton_steps
        self.fit_steps = fit_steps
        self.opt = Adam(learning_rate)

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> LaplaceModel:
        x = GPRegression._shape(x)
        y = torch.where(y > 0, 1.0, -1.0).to(torch.float32)
        params = self.init_params
        if self.fit_steps > 0:
            p = fit_params(params.packed(),
                           lambda q: _laplace_neg_evidence(GPParams.unpack(q), x, y,
                                                           self.newton_steps),
                           self.opt, self.fit_steps)
            params = GPParams.unpack(p)
        f_hat = _newton_mode(params, x, y, self.newton_steps)
        return LaplaceModel(params=params, x=x, y=y, f_hat=f_hat)

    def latent(self, model: LaplaceModel, x_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent predictive ``(mean, var)`` at ``x_test`` (R&W Alg 3.2)."""
        params, x, y, f_hat = model.params, model.x, model.y, model.f_hat
        x_test = GPRegression._shape(x_test)
        K = _jittered_kernel(params, x)
        pi = torch.sigmoid(f_hat)
        _, sW, L = _b_factor(K, pi)
        Ks = _rbf(x_test, x, params)  # (m, n)
        mean = Ks @ ((y + 1.0) / 2.0 - pi)
        v = torch.linalg.solve_triangular(L, sW[:, None] * Ks.T, upper=False)
        var = torch.clamp(torch.exp(params.log_variance) - (v**2).sum(0), min=1e-12)
        return mean, var

    def predict_proba(self, model: LaplaceModel, x_test: torch.Tensor) -> torch.Tensor:
        mean, var = self.latent(model, x_test)
        # MacKay's approximation of the logistic-Gaussian integral
        kappa = 1.0 / torch.sqrt(1.0 + torch.pi * var / 8.0)
        return torch.sigmoid(kappa * mean)

    def predict_label(self, model: LaplaceModel, x_test: torch.Tensor) -> torch.Tensor:
        return (self.predict_proba(model, x_test) > 0.5).to(torch.int32)


class ProbitLabelRegression(GPRegression):
    """GP regression on ±1 labels, probit-squashed at predict time
    (Nickisch & Rasmussen's "label regression"), the cheap baseline."""

    def fit(self, x: torch.Tensor, y: torch.Tensor):
        """``y`` in {0, 1} or {-1, +1}."""
        return super().fit(x, torch.where(y > 0, 1.0, -1.0).to(torch.float32))

    def predict_proba(self, model, x_test: torch.Tensor) -> torch.Tensor:
        mean, var = super().predict(model, x_test)
        return torch.special.ndtr(mean / torch.sqrt(1.0 + var))

    def predict_label(self, model, x_test: torch.Tensor) -> torch.Tensor:
        return (self.predict_proba(model, x_test) > 0.5).to(torch.int32)
