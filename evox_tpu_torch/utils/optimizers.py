"""Gradient-step optimizers for ES-style algorithms.

The port of ``evox_tpu/utils/optimizers.py``. The JAX package resolves any
optax factory by name (``make_optimizer``) and builds ClipUp as an optax
transformation. Here every optax optimizer alias that updates from the
gradient (and, where it decays weights, the parameters) is a small class
with optax's ``init``/``update`` contract, optax 0.2.6's keyword names and
defaults, and optax's arithmetic in its order of operations: updates are
*added* to the parameters. The parameters are one tensor (an ES center).

Scalars that optax computes from the step count in float32 (bias
corrections, RAdam's rectification, Adafactor's decay, the noise scale of
``noisy_sgd``) are numpy float32 scalars here, whose arithmetic rounds as
JAX's weakly typed float32 does, handed to the tensors as Python floats:
no copy to or from the card, and a decision on them reads no card. A
state's step count is a Python integer.

Refused names (``make_optimizer``): ``lbfgs`` and ``polyak_sgd`` (they
need the objective's value and a value function; an ES hands an optimizer
only its gradient estimate), ``dpsgd`` (per-example gradients), optax's
gradient transformations that are not optimizers (``clip``, ``scale``,
``trace``, ``scale_by_*``, ...), and unknown names (``ValueError("unknown
optimizer ...")``, as in the JAX package).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.struct import PyTreeNode
from .common import generator, split_seed

Mask = Union[None, bool, Callable[[torch.Tensor], bool]]

_NO_PARAMS = "this optimizer decays or scales by the parameters: pass them to update()"


_F32 = np.float32


def _pow32(base: float, exponent: float) -> np.float32:
    """``base ** exponent`` of float32 operands, correctly rounded to
    float32 as XLA's jitted ``pow`` gives it (PyTorch's float32 ``pow`` by
    an integer multiplies step by step, an ulp off; ``1 - b**t`` magnifies
    that ulp ~300x at ``b`` 0.999)."""
    return _F32(float(_F32(base)) ** float(_F32(exponent)))


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int = 1) -> torch.Tensor:
    """``optax.tree.update_moment``: ``(1 - decay) * g**order + decay * t``."""
    return (1 - decay) * (g if order == 1 else g**order) + decay * t


def _debias(m: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """``optax.tree.bias_correction``: ``m / (1 - decay**count)``, the
    divisor in float32."""
    return m / float(_F32(1) - _pow32(decay, count))


def _apply_mask(mask: Mask, params: torch.Tensor) -> bool:
    """optax's ``masked`` for one parameter leaf: ``None`` or ``True``
    applies the transformation, ``False`` skips it; a callable is called on
    the parameters."""
    if callable(mask):
        mask = mask(params)
    return mask is None or bool(mask)


def _decayed(u: torch.Tensor, params: Optional[torch.Tensor], weight_decay: float,
             mask: Mask = None) -> torch.Tensor:
    """``optax.add_decayed_weights``: ``u + weight_decay * params``."""
    if params is None:
        raise ValueError(_NO_PARAMS)
    return u + weight_decay * params if _apply_mask(mask, params) else u


def _safe_norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    """``optax``'s ``safe_norm``: the 2-norm, ``min_norm`` at or below it."""
    norm = torch.linalg.vector_norm(x)
    return torch.where(norm <= min_norm, torch.full_like(norm, min_norm), norm)


def _trust_ratio(u: torch.Tensor, params: Optional[torch.Tensor], min_norm: float = 0.0,
                 trust_coefficient: float = 1.0, eps: float = 0.0) -> torch.Tensor:
    """``optax.scale_by_trust_ratio`` on one leaf."""
    if params is None:
        raise ValueError(_NO_PARAMS)
    param_norm = _safe_norm(params, min_norm)
    update_norm = _safe_norm(u, min_norm)
    ratio = trust_coefficient * param_norm / (update_norm + eps)
    zero = (param_norm == 0.0) | (update_norm == 0.0)
    return u * torch.where(zero, torch.ones_like(ratio), ratio)


def _trace(u: torch.Tensor, trace: torch.Tensor, decay: float,
           nesterov: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``optax.trace``: the momentum buffer and the update it gives."""
    new_trace = u + decay * trace
    return (u + decay * new_trace if nesterov else new_trace), new_trace


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class _Optimizer:
    """Shared: the learning rate and optax's ``scale_by_learning_rate``
    (updates are ``-learning_rate * u``)."""

    def __init__(self, learning_rate: Optional[float]):
        self.learning_rate = None if learning_rate is None else float(learning_rate)

    def _step(self, u: torch.Tensor) -> torch.Tensor:
        return u if self.learning_rate is None else -self.learning_rate * u


# ------------------------------------------------------------------- SGD


class TraceState(PyTreeNode):
    trace: torch.Tensor


class SGD(_Optimizer):
    """``optax.sgd``: ``-learning_rate * grads``, through a momentum trace
    (``momentum``, ``nesterov``) when ``momentum`` is set; the state is
    empty without one."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None,
                 nesterov: bool = False, accumulator_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate)
        self.momentum, self.nesterov = momentum, nesterov
        self.accumulator_dtype = accumulator_dtype

    def init(self, params: torch.Tensor) -> Any:
        if self.momentum is None:
            return ()
        return TraceState(trace=torch.zeros_like(params, dtype=self.accumulator_dtype))

    def update(self, grads: torch.Tensor, state: Any,
               params: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Any]:
        if self.momentum is None:
            return self._step(grads), state
        u, trace = _trace(grads, state.trace, self.momentum, self.nesterov)
        return self._step(u), TraceState(trace=_cast(trace, self.accumulator_dtype))


class SignSGD(_Optimizer):
    """``optax.sign_sgd``: ``-learning_rate * sign(grads)``."""

    def init(self, params: torch.Tensor) -> Tuple[()]:
        return ()

    def update(self, grads, state, params=None):
        return self._step(torch.sign(grads)), state


class NoisySGDState(PyTreeNode):
    count: int
    seed: int


class NoisySGD(_Optimizer):
    """``optax.noisy_sgd``: gradient plus Gaussian noise of variance
    ``eta / count**gamma``. ``key`` (or the deprecated ``seed``) is an
    integer seed here; each step's noise comes from :meth:`_draw`, the one
    draw method, which tests replace with JAX's draws."""

    def __init__(self, learning_rate: float, eta: float = 0.01, gamma: float = 0.55,
                 key: Optional[int] = None, *, seed: Optional[int] = None):
        super().__init__(learning_rate)
        if seed is not None and key is not None:
            raise ValueError("Only one of seed or key can be specified.")
        self.eta, self.gamma = eta, gamma
        self.key = int(seed if seed is not None else (key if key is not None else 0))

    def init(self, params: torch.Tensor) -> NoisySGDState:
        return NoisySGDState(count=0, seed=self.key)

    def _draw(self, seed: int, like: torch.Tensor) -> torch.Tensor:
        """Standard normals shaped and placed like ``like``."""
        g = generator(seed, like.device)
        return torch.randn(like.shape, generator=g, device=like.device, dtype=like.dtype)

    def update(self, grads, state, params=None):
        count = state.count + 1
        std = np.sqrt(_F32(self.eta) / _pow32(count, self.gamma))
        seed, k = split_seed(state.seed)
        u = grads + float(std) * self._draw(k, grads)
        return self._step(u), NoisySGDState(count=count, seed=seed)


# ------------------------------------------------------- the Adam family


class AdamState(PyTreeNode):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def _scale_by_adam(grads: torch.Tensor, state: AdamState, b1: float, b2: float, eps: float,
                   eps_root: float, nesterov: bool,
                   mu_dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, AdamState]:
    """``optax.scale_by_adam``."""
    mu = _moment(grads, state.mu, b1, 1)
    nu = _moment(grads, state.nu, b2, 2)
    count = state.count + 1
    if nesterov:
        mu_hat = b1 * _debias(mu, b1, count + 1) + (1 - b1) * _debias(grads, b1, count)
    else:
        mu_hat = _debias(mu, b1, count)
    nu_hat = _debias(nu, b2, count)
    u = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
    return u, AdamState(count=count, mu=_cast(mu, mu_dtype), nu=nu)


class Adam(_Optimizer):
    """``optax.adam`` (``nesterov=True``: ``optax.nadam``)."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 *, nesterov: bool = False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype, self.nesterov = mu_dtype, nesterov

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(count=0, mu=torch.zeros_like(params, dtype=self.mu_dtype),
                         nu=torch.zeros_like(params))

    def _adam(self, grads, state):
        return _scale_by_adam(grads, state, self.b1, self.b2, self.eps, self.eps_root,
                              self.nesterov, self.mu_dtype)

    def update(self, grads, state, params=None):
        u, state = self._adam(grads, state)
        return self._step(u), state


class NAdam(Adam):
    """``optax.nadam``: adam with ``nesterov=True``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 *, nesterov: bool = True):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


class AdamW(Adam):
    """``optax.adamw`` (``nesterov=True``: ``optax.nadamw``): adam, then
    ``weight_decay * params`` added, then the learning rate."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 weight_decay: float = 1e-4, mask: Mask = None, *, nesterov: bool = False):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)
        self.weight_decay, self.mask = weight_decay, mask

    def update(self, grads, state, params=None):
        u, state = self._adam(grads, state)
        return self._step(_decayed(u, params, self.weight_decay, self.mask)), state


class NAdamW(AdamW):
    """``optax.nadamw``: adamw with ``nesterov=True``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 weight_decay: float = 1e-4, mask: Mask = None, *, nesterov: bool = True):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, weight_decay, mask,
                         nesterov=nesterov)


class Lamb(Adam):
    """``optax.lamb``: adam, weight decay, then the trust ratio
    ``||params|| / ||u||``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, eps_root: float = 0.0, weight_decay: float = 0.0,
                 mask: Mask = None):
        super().__init__(learning_rate, b1, b2, eps, eps_root)
        self.weight_decay, self.mask = weight_decay, mask

    def update(self, grads, state, params=None):
        u, state = self._adam(grads, state)
        u = _trust_ratio(_decayed(u, params, self.weight_decay, self.mask), params)
        return self._step(u), state


class AmsgradState(PyTreeNode):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    nu_max: torch.Tensor


class AMSGrad(_Optimizer):
    """``optax.amsgrad``: adam with the running maximum of the corrected
    second moment."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root, self.mu_dtype = b1, b2, eps, eps_root, mu_dtype

    def init(self, params):
        return AmsgradState(count=0, mu=torch.zeros_like(params, dtype=self.mu_dtype),
                            nu=torch.zeros_like(params), nu_max=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        mu = _moment(grads, state.mu, self.b1, 1)
        nu = _moment(grads, state.nu, self.b2, 2)
        count = state.count + 1
        mu_hat = _debias(mu, self.b1, count)
        nu_max = torch.maximum(state.nu_max, _debias(nu, self.b2, count))
        u = mu_hat / (torch.sqrt(nu_max + self.eps_root) + self.eps)
        return self._step(u), AmsgradState(count=count, mu=_cast(mu, self.mu_dtype), nu=nu,
                                           nu_max=nu_max)


class Adamax(_Optimizer):
    """``optax.adamax``: the second moment as an infinity norm."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return AdamState(count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def _adamax(self, grads, state):
        count = state.count + 1
        mu = _moment(grads, state.mu, self.b1, 1)
        nu = torch.maximum(torch.abs(grads) + self.eps, self.b2 * state.nu)
        return _debias(mu, self.b1, count) / nu, AdamState(count=count, mu=mu, nu=nu)

    def update(self, grads, state, params=None):
        u, state = self._adamax(grads, state)
        return self._step(u), state


class AdamaxW(Adamax):
    """``optax.adamaxw``: adamax with decoupled weight decay."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4, mask: Mask = None):
        super().__init__(learning_rate, b1, b2, eps)
        self.weight_decay, self.mask = weight_decay, mask

    def update(self, grads, state, params=None):
        u, state = self._adamax(grads, state)
        return self._step(_decayed(u, params, self.weight_decay, self.mask)), state


class RAdam(_Optimizer):
    """``optax.radam``: adam's step rectified by its variance, the plain
    first moment while the rectification term is below ``threshold``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, threshold: float = 5.0,
                 *, nesterov: bool = False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.threshold, self.nesterov = threshold, nesterov
        self.ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(self, params):
        return AdamState(count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        b1, b2, ro_inf = self.b1, self.b2, self.ro_inf
        mu = _moment(grads, state.mu, b1, 1)
        nu = _moment(grads, state.nu, b2, 2)
        count = state.count + 1
        b2t = _pow32(b2, count)
        ro = _F32(ro_inf) - _F32(2 * count) * b2t / (_F32(1) - b2t)
        if self.nesterov:
            mu_hat = b1 * _debias(mu, b1, count + 1) + (1 - b1) * _debias(grads, b1, count)
        else:
            mu_hat = _debias(mu, b1, count)
        if bool(ro >= self.threshold):
            nu_hat = _debias(nu, b2, count)
            r = np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                        / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            u = float(r) * mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
        else:
            u = mu_hat
        return self._step(u), AdamState(count=count, mu=mu, nu=nu)


class Yogi(_Optimizer):
    """``optax.yogi``: an additive second-moment update; both moments start
    at 1e-6."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-3):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return AdamState(count=0, mu=torch.full_like(params, 1e-6), nu=torch.full_like(params, 1e-6))

    def update(self, grads, state, params=None):
        mu = _moment(grads, state.mu, self.b1, 1)
        g2 = grads * grads
        nu = state.nu - (1 - self.b2) * torch.sign(state.nu - g2) * g2
        count = state.count + 1
        u = _debias(mu, self.b1, count) / (torch.sqrt(_debias(nu, self.b2, count)) + self.eps)
        return self._step(u), AdamState(count=count, mu=mu, nu=nu)


class AdaBelief(_Optimizer):
    """``optax.adabelief``: the second moment of the gradient's deviation
    from its running mean."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-16, eps_root: float = 1e-16, *, nesterov: bool = False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root, self.nesterov = b1, b2, eps, eps_root, nesterov

    def init(self, params):
        return AdamState(count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        b1, b2 = self.b1, self.b2
        mu = _moment(grads, state.mu, b1, 1)
        nu = _moment(grads - mu, state.nu, b2, 2) + self.eps_root
        count = state.count + 1
        if self.nesterov:
            mu_hat = b1 * _debias(mu, b1, count + 1) + (1 - b1) * _debias(grads, b1, count)
        else:
            mu_hat = _debias(mu, b1, count)
        u = mu_hat / (torch.sqrt(_debias(nu, b2, count)) + self.eps)
        return self._step(u), AdamState(count=count, mu=mu, nu=nu)


class AdanState(PyTreeNode):
    m: torch.Tensor
    v: torch.Tensor
    n: torch.Tensor
    g: torch.Tensor
    t: int


class Adan(_Optimizer):
    """``optax.adan``: Nesterov momentum from moments of the gradient and
    of its difference."""

    def __init__(self, learning_rate: float, b1: float = 0.98, b2: float = 0.92,
                 b3: float = 0.99, eps: float = 1e-8, eps_root: float = 1e-8,
                 weight_decay: float = 0.0, mask: Mask = None):
        super().__init__(learning_rate)
        self.b1, self.b2, self.b3, self.eps, self.eps_root = b1, b2, b3, eps, eps_root
        self.weight_decay, self.mask = weight_decay, mask

    def init(self, params):
        z = torch.zeros_like(params)
        return AdanState(m=z, v=z.clone(), n=z.clone(), g=z.clone(), t=0)

    def update(self, grads, state, params=None):
        b1, b2, b3 = self.b1, self.b2, self.b3
        diff = torch.zeros_like(grads) if state.t == 0 else grads - state.g
        m = _moment(grads, state.m, b1, 1)
        v = _moment(diff, state.v, b2, 1)
        n = _moment(grads + (1 - b2) * diff, state.n, b3, 2)
        t = state.t + 1
        u = _debias(m, b1, t) + (1 - b2) * _debias(v, b2, t)
        u = u / (torch.sqrt(_debias(n, b3, t) + self.eps_root) + self.eps)
        u = _decayed(u, params, self.weight_decay, self.mask)
        return self._step(u), AdanState(m=m, v=v, n=n, g=grads, t=t)


class LionState(PyTreeNode):
    count: int
    mu: torch.Tensor


class Lion(_Optimizer):
    """``optax.lion``: the sign of an interpolated momentum, with decoupled
    weight decay."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.99,
                 mu_dtype: Optional[torch.dtype] = None, weight_decay: float = 1e-3,
                 mask: Mask = None):
        super().__init__(learning_rate)
        self.b1, self.b2, self.mu_dtype = b1, b2, mu_dtype
        self.weight_decay, self.mask = weight_decay, mask

    def init(self, params):
        return LionState(count=0, mu=torch.zeros_like(params, dtype=self.mu_dtype))

    def update(self, grads, state, params=None):
        u = torch.sign((1.0 - self.b1) * grads + self.b1 * state.mu)
        mu = _cast(_moment(grads, state.mu, self.b2, 1), self.mu_dtype)
        u = _decayed(u, params, self.weight_decay, self.mask)
        return self._step(u), LionState(count=state.count + 1, mu=mu)


class NovogradState(PyTreeNode):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor  # 0-d: the layer's second moment


class Novograd(_Optimizer):
    """``optax.novograd``: a second moment of the gradient's norm, the
    first of the normalised gradient plus weight decay."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.25,
                 eps: float = 1e-6, eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params):
        return NovogradState(count=0, mu=torch.zeros_like(params),
                             nu=torch.zeros((), dtype=params.dtype, device=params.device))

    def update(self, grads, state, params=None):
        if params is None:
            raise ValueError(_NO_PARAMS)
        count = state.count + 1
        nu_add = torch.linalg.vector_norm(grads) ** 2
        nu = nu_add if count == 1 else _moment(nu_add, state.nu, self.b2, 1)
        mu_add = grads / (torch.sqrt(nu + self.eps_root) + self.eps) + self.weight_decay * params
        mu = mu_add if count == 1 else self.b1 * state.mu + mu_add
        return self._step(mu), NovogradState(count=count, mu=mu, nu=nu)


class OptimisticState(PyTreeNode):
    is_initial_step: bool
    previous_gradient: torch.Tensor


def _optimistic(u: torch.Tensor, state: Any, alpha: float, beta: float) -> torch.Tensor:
    """``optax.scale_by_optimistic_gradient``'s update."""
    prev = u if state.is_initial_step else state.previous_gradient
    return (alpha + beta) * u - beta * prev


class OptimisticGradientDescent(_Optimizer):
    """``optax.optimistic_gradient_descent``: ``(alpha + beta) * g - beta *
    g_prev``."""

    def __init__(self, learning_rate: float, alpha: float = 1.0, beta: float = 1.0):
        super().__init__(learning_rate)
        self.alpha, self.beta = float(alpha), float(beta)

    def init(self, params):
        return OptimisticState(is_initial_step=True, previous_gradient=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        u = _optimistic(grads, state, self.alpha, self.beta)
        return self._step(u), OptimisticState(is_initial_step=False, previous_gradient=grads)


class OptimisticAdamState(PyTreeNode):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    is_initial_step: bool
    previous_gradient: torch.Tensor


class OptimisticAdamV2(Adam):
    """``optax.optimistic_adam_v2``: nadam's step through the optimistic
    gradient, then the learning rate."""

    def __init__(self, learning_rate: float, *, alpha: float = 1.0, beta: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None, nesterov: bool = True):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)
        self.alpha, self.beta, self.scale = float(alpha), float(beta), self.learning_rate

    def init(self, params):
        adam = super().init(params)
        return OptimisticAdamState(count=0, mu=adam.mu, nu=adam.nu, is_initial_step=True,
                                   previous_gradient=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        u, adam = self._adam(grads, AdamState(count=state.count, mu=state.mu, nu=state.nu))
        out = _optimistic(u, state, self.alpha, self.beta)
        return -self.scale * out, OptimisticAdamState(
            count=adam.count, mu=adam.mu, nu=adam.nu, is_initial_step=False, previous_gradient=u)


class OptimisticAdam(OptimisticAdamV2):
    """``optax.optimistic_adam`` (deprecated there, with the same warning):
    the optimistic step with ``alpha = learning_rate`` and ``beta =
    optimism`` (default: the learning rate), then a sign flip."""

    def __init__(self, learning_rate: float, optimism: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None, *, nesterov: bool = True):
        warnings.warn("`optimistic_adam` is deprecated, please use `optimistic_adam_v2` instead.",
                      category=DeprecationWarning)
        if callable(learning_rate):
            raise ValueError("This version of `optimistic_adam` does not support learning rate "
                             "schedules but `optimistic_adam_v2` does.")
        super().__init__(learning_rate, alpha=learning_rate,
                         beta=learning_rate if optimism is None else optimism, b1=b1, b2=b2,
                         eps=eps, eps_root=eps_root, mu_dtype=mu_dtype, nesterov=nesterov)
        self.scale = 1.0


# ------------------------------------------------- the adaptive-rate family


class RssState(PyTreeNode):
    sum_of_squares: torch.Tensor


class Adagrad(_Optimizer):
    """``optax.adagrad``: the gradient over the root of its running sum of
    squares."""

    def __init__(self, learning_rate: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(learning_rate)
        self.initial_accumulator_value, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return RssState(sum_of_squares=torch.full_like(params, self.initial_accumulator_value))

    def update(self, grads, state, params=None):
        sos = grads * grads + state.sum_of_squares
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps), torch.zeros_like(sos))
        return self._step(inv * grads), RssState(sum_of_squares=sos)


class AdaDeltaState(PyTreeNode):
    e_g: torch.Tensor
    e_x: torch.Tensor


class Adadelta(_Optimizer):
    """``optax.adadelta``; ``learning_rate=None`` applies the raw adadelta
    step (optax's default)."""

    def __init__(self, learning_rate: Optional[float] = None, rho: float = 0.9,
                 eps: float = 1e-6, weight_decay: float = 0.0, weight_decay_mask: Mask = None):
        super().__init__(learning_rate)
        self.rho, self.eps = rho, eps
        self.weight_decay, self.weight_decay_mask = weight_decay, weight_decay_mask

    def init(self, params):
        return AdaDeltaState(e_g=torch.zeros_like(params), e_x=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        g = _decayed(grads, params, self.weight_decay, self.weight_decay_mask)
        e_g = _moment(g, state.e_g, self.rho, 2)
        u = torch.sqrt(state.e_x + self.eps) / torch.sqrt(e_g + self.eps) * g
        e_x = _moment(u, state.e_x, self.rho, 2)
        return self._step(u), AdaDeltaState(e_g=e_g, e_x=e_x)


class RMSPropState(PyTreeNode):
    count: int
    mu: Optional[torch.Tensor]  # centered only
    nu: torch.Tensor
    trace: Optional[torch.Tensor]  # with momentum only


class RMSProp(_Optimizer):
    """``optax.rmsprop``: plain or ``centered``, with optax's
    ``bias_correction``, ``eps_in_sqrt`` and a momentum trace."""

    def __init__(self, learning_rate: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(learning_rate)
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale
        self.eps_in_sqrt, self.centered, self.bias_correction = eps_in_sqrt, centered, bias_correction
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, params):
        return RMSPropState(
            count=0,
            mu=torch.zeros_like(params) if self.centered else None,
            nu=torch.full_like(params, self.initial_scale),
            trace=None if self.momentum is None else torch.zeros_like(params),
        )

    def update(self, grads, state, params=None):
        decay = self.decay
        nu = _moment(grads, state.nu, decay, 2)
        mu = _moment(grads, state.mu, decay, 1) if self.centered else None
        count = state.count + 1 if self.bias_correction else state.count
        nu_hat = _debias(nu, decay, count) if self.bias_correction else nu
        if self.centered:
            mu_hat = _debias(mu, decay, count) if self.bias_correction else mu
            nu_hat = nu_hat - mu_hat * mu_hat
        if self.eps_in_sqrt:
            scaling = torch.rsqrt(nu_hat + self.eps)
        else:
            scaling = 1 / (torch.sqrt(nu_hat) + self.eps)
        u = self._step(scaling * grads)
        trace = state.trace
        if self.momentum is not None:
            u, trace = _trace(u, trace, self.momentum, self.nesterov)
        return u, RMSPropState(count=count, mu=mu, nu=nu, trace=trace)


class RpropState(PyTreeNode):
    step_sizes: torch.Tensor
    prev_updates: torch.Tensor


class Rprop(_Optimizer):
    """``optax.rprop``: per-coordinate step sizes grown while the
    gradient's sign holds and shrunk when it flips. As in optax 0.2.6, a
    step applies the update of the step before (zeroed where the sign
    flipped)."""

    def __init__(self, learning_rate: float, eta_minus: float = 0.5, eta_plus: float = 1.2,
                 min_step_size: float = 1e-6, max_step_size: float = 50.0):
        super().__init__(learning_rate)
        self.eta_minus, self.eta_plus = eta_minus, eta_plus
        self.min_step_size, self.max_step_size = min_step_size, max_step_size

    def init(self, params):
        return RpropState(step_sizes=torch.full_like(params, self.learning_rate),
                          prev_updates=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        sign = grads * state.prev_updates
        factor = torch.where(sign > 0, self.eta_plus, self.eta_minus).to(grads.dtype)
        grown = torch.clamp(state.step_sizes * factor, min=self.min_step_size,
                            max=self.max_step_size)
        step_sizes = torch.where(sign == 0, state.step_sizes, grown)
        zero = torch.zeros_like(grads)
        prev_updates = torch.where(sign < 0, zero, step_sizes * torch.sign(grads))
        u = torch.where(sign < 0, zero, state.prev_updates)
        return -1.0 * u, RpropState(step_sizes=step_sizes, prev_updates=prev_updates)


class SM3State(PyTreeNode):
    mu: torch.Tensor  # the accumulator of a vector's one axis
    nu: torch.Tensor


class SM3(_Optimizer):
    """``optax.sm3`` on a vector (one axis: its cover is the coordinates
    themselves); ``momentum`` is optax's ``b1``."""

    def __init__(self, learning_rate: float, momentum: float = 0.9):
        super().__init__(learning_rate)
        self.momentum = momentum

    def init(self, params):
        if params.ndim != 1:
            raise ValueError(f"SM3 here takes a vector of parameters, got shape {tuple(params.shape)}")
        return SM3State(mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        accum = 1.0 * grads**2 + 1.0 * state.mu
        inv = torch.where(accum > 0, torch.rsqrt(accum + 1e-8), torch.zeros_like(accum))
        nu = _moment(grads * inv, state.nu, self.momentum, 1)
        return -self.learning_rate * nu, SM3State(mu=accum, nu=nu)


class FactoredState(PyTreeNode):
    count: int
    v: torch.Tensor
    ema: Optional[torch.Tensor]  # with momentum only


class Adafactor(_Optimizer):
    """``optax.adafactor`` on a vector, where it is unfactored: the
    gradient over the root of a decaying mean square, clipped by its block
    RMS, scaled by the parameters' RMS."""

    def __init__(self, learning_rate: Optional[float] = None, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: float = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 dtype_momentum: torch.dtype = torch.float32,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True, weight_decay_mask: Mask = None):
        super().__init__(learning_rate)
        self.min_dim_size_to_factor, self.factored = min_dim_size_to_factor, factored
        self.decay_rate, self.decay_offset, self.eps = decay_rate, decay_offset, eps
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self.clipping_threshold, self.momentum = clipping_threshold, momentum
        self.dtype_momentum = dtype_momentum
        self.weight_decay_rate, self.weight_decay_mask = weight_decay_rate, weight_decay_mask

    def init(self, params):
        shape = sorted(params.shape)
        if self.factored and len(shape) >= 2 and shape[-2] >= self.min_dim_size_to_factor:
            raise ValueError("Adafactor here keeps the unfactored second moment: the "
                             f"parameters' shape {tuple(params.shape)} would be factored")
        return FactoredState(
            count=0, v=torch.zeros_like(params),
            ema=None if self.momentum is None else torch.zeros_like(params, dtype=self.dtype_momentum))

    def update(self, grads, state, params=None):
        if params is None:
            raise ValueError(_NO_PARAMS)
        decay = _F32(1) - _pow32(state.count - self.decay_offset + 1, -self.decay_rate)
        v = float(decay) * state.v + float(_F32(1) - decay) * (grads * grads + self.eps)
        u = grads * v ** (-0.5)
        if self.clipping_threshold is not None:
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp_min(rms / self.clipping_threshold, 1.0)
        if self.learning_rate is not None:
            u = self.learning_rate * u
        if self.multiply_by_parameter_scale:
            rms = torch.sqrt(torch.mean(params * params))
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        ema = state.ema
        if self.momentum is not None:
            u = _moment(u, ema, self.momentum, 1)
            ema = u.to(self.dtype_momentum)
        if self.weight_decay_rate is not None:
            u = _decayed(u, params, self.weight_decay_rate, self.weight_decay_mask)
        return -1 * u, FactoredState(count=state.count + 1, v=v, ema=ema)


class Fromage(_Optimizer):
    """``optax.fromage``: the trust-ratio step ``lr / sqrt(1 + lr**2)``,
    then weights decayed by ``1 / sqrt(1 + lr**2) - 1``."""

    def __init__(self, learning_rate: float, min_norm: float = 1e-6):
        super().__init__(learning_rate)
        self.min_norm = min_norm
        lr = self.learning_rate
        mult = _F32(1) / np.sqrt(_F32(1 + lr**2))  # optax takes the root in float32
        self.step_size = float(-(_F32(lr) * mult))
        self.decay = float(mult - _F32(1))

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        u = self.step_size * _trust_ratio(grads, params, self.min_norm)
        return _decayed(u, params, self.decay), state


class Lars(_Optimizer):
    """``optax.lars``: weight decay, the layer-wise trust ratio, the
    learning rate, then a momentum trace."""

    def __init__(self, learning_rate: float, weight_decay: float = 0.0,
                 weight_decay_mask: Mask = True, trust_coefficient: float = 0.001,
                 eps: float = 0.0, trust_ratio_mask: Mask = True, momentum: float = 0.9,
                 nesterov: bool = False):
        super().__init__(learning_rate)
        self.weight_decay, self.weight_decay_mask = weight_decay, weight_decay_mask
        self.trust_coefficient, self.eps, self.trust_ratio_mask = trust_coefficient, eps, trust_ratio_mask
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, params):
        return TraceState(trace=torch.zeros_like(params))

    def update(self, grads, state, params=None):
        u = _decayed(grads, params, self.weight_decay, self.weight_decay_mask)
        if _apply_mask(self.trust_ratio_mask, params):
            u = _trust_ratio(u, params, trust_coefficient=self.trust_coefficient, eps=self.eps)
        u, trace = _trace(self._step(u), state.trace, self.momentum, self.nesterov)
        return u, TraceState(trace=trace)


# ------------------------------------------------------------------ ClipUp


class ClipUpState(PyTreeNode):
    velocity: torch.Tensor


class ClipUp:
    """ClipUp (Toklu et al. 2020), ``evox_tpu/utils/optimizers.py::clipup``:
    the gradient normalised to unit length, a momentum velocity, and the
    velocity's length clipped at ``max_speed``."""

    def __init__(
        self,
        learning_rate: float = 0.15,
        momentum: float = 0.9,
        max_speed: float = 0.3,
        fix_gradient_size: bool = True,
    ):
        self.learning_rate = float(learning_rate)
        self.momentum = momentum
        self.max_speed = max_speed
        self.fix_gradient_size = fix_gradient_size

    def init(self, params: torch.Tensor) -> ClipUpState:
        return ClipUpState(velocity=torch.zeros_like(params))

    def update(
        self, grads: torch.Tensor, state: ClipUpState, params: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, ClipUpState]:
        g = grads
        if self.fix_gradient_size:
            g = g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12)
        v = self.momentum * state.velocity + self.learning_rate * g
        speed = torch.linalg.vector_norm(v)
        v = torch.where(speed > self.max_speed, v * (self.max_speed / speed), v)
        return -v, ClipUpState(velocity=v)


# ---------------------------------------------------------------- by name


OPTIMIZERS = {
    "sgd": SGD, "sign_sgd": SignSGD, "noisy_sgd": NoisySGD,
    "adam": Adam, "nadam": NAdam, "adamw": AdamW, "nadamw": NAdamW, "amsgrad": AMSGrad,
    "adamax": Adamax, "adamaxw": AdamaxW, "radam": RAdam, "yogi": Yogi, "adabelief": AdaBelief,
    "adan": Adan, "lion": Lion, "lamb": Lamb, "lars": Lars, "novograd": Novograd,
    "adagrad": Adagrad, "adadelta": Adadelta, "adafactor": Adafactor, "rmsprop": RMSProp,
    "rprop": Rprop, "sm3": SM3, "fromage": Fromage,
    "optimistic_gradient_descent": OptimisticGradientDescent,
    "optimistic_adam": OptimisticAdam, "optimistic_adam_v2": OptimisticAdamV2,
}

# optax optimizers that need more than a gradient estimate
NEEDS_MORE = {
    "lbfgs": "its line search needs the objective's value and a value_fn",
    "polyak_sgd": "its step size needs the objective's value",
    "dpsgd": "it clips and noises per-example gradients",
}

# optax's gradient transformations that are not optimizers (and every
# ``scale_by_*``): building blocks of an optax chain
TRANSFORMATIONS = frozenset({
    "adaptive_grad_clip", "add_decayed_weights", "add_noise", "apply_every", "apply_if_finite",
    "centralize", "chain", "clip", "clip_by_block_rms", "clip_by_global_norm",
    "conditionally_mask", "conditionally_transform", "differentially_private_aggregate", "ema",
    "flatten", "freeze", "identity", "inject_hyperparams", "inject_stateful_hyperparams",
    "keep_params_nonnegative", "lookahead", "masked", "multi_transform", "named_chain",
    "normalize_by_update_norm", "partition", "per_example_global_norm_clip",
    "per_example_layer_norm_clip", "scale", "scale_gradient", "selective_transform",
    "set_to_zero", "skip_large_updates", "skip_not_finite", "snapshot", "stateless",
    "stateless_with_tree_map", "trace", "with_extra_args_support", "zero_nans",
})


def make_optimizer(optimizer: Any, learning_rate: float = 0.01, **kwargs: Any) -> Any:
    """Resolve ``None`` (sgd), ``"clipup"`` or an optax optimizer's name
    (``OPTIMIZERS``), built as ``factory(learning_rate, **kwargs)``, or pass
    through an object with ``init``/``update``. ES algorithms *minimize*,
    and the gradients passed in are descent directions."""
    if optimizer is None:
        return SGD(learning_rate)
    if hasattr(optimizer, "init") and hasattr(optimizer, "update"):
        return optimizer
    if optimizer == "clipup":
        return ClipUp(learning_rate=learning_rate, **kwargs)
    if optimizer in OPTIMIZERS:
        return OPTIMIZERS[optimizer](learning_rate, **kwargs)
    if optimizer in NEEDS_MORE:
        raise ValueError(f"optimizer {optimizer!r} is refused: {NEEDS_MORE[optimizer]}, and an "
                         "ES hands its optimizer only a gradient estimate")
    if optimizer in TRANSFORMATIONS or str(optimizer).startswith("scale_by_"):
        raise ValueError(f"{optimizer!r} is an optax gradient transformation, not an optimizer; "
                         "pass an object with init/update that chains it, or an optimizer's name")
    raise ValueError(f"unknown optimizer {optimizer!r}")


__all__ = [
    "AMSGrad", "AdaBelief", "AdaDeltaState", "Adadelta", "Adafactor", "Adagrad", "Adam",
    "AdamState", "AdamW", "Adamax", "AdamaxW", "Adan", "AdanState", "AmsgradState", "ClipUp",
    "ClipUpState", "FactoredState", "Fromage", "Lamb", "Lars", "Lion", "LionState", "NAdam",
    "NAdamW", "NoisySGD", "NoisySGDState", "Novograd", "NovogradState", "OPTIMIZERS",
    "OptimisticAdam", "OptimisticAdamState", "OptimisticAdamV2", "OptimisticGradientDescent",
    "OptimisticState", "RAdam", "RMSProp", "RMSPropState", "Rprop", "RpropState", "RssState",
    "SGD", "SM3", "SM3State", "SignSGD", "TraceState", "Yogi", "make_optimizer",
]
