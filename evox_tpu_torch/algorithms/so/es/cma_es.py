"""CMA-ES family (Hansen, "The CMA Evolution Strategy: A Tutorial",
arXiv:1604.00772) — the port of ``evox_tpu/algorithms/so/es/cma_es.py``:
``CMAES``, ``SepCMAES``, the in-place restart variants ``IPOPCMAES`` and
``BIPOPCMAES``, and the host-level ``RestartCMAESDriver``.

How the port differs in form, not in numbers:

- The eigendecomposition is lazy, every ``decomp_per_iter`` generations,
  as in the JAX package; there it is a ``lax.cond`` on a device counter,
  here a host ``if`` on the integer ``iteration`` the state carries, so no
  generation reads the device. It goes through one method, ``_decompose``,
  which the tests replace with the JAX package's ``(B, D)``: eigenvectors
  are unique only up to signs, so whole generations compare field by field
  only with the same basis.
- CMA-ES's matrix products (the sampling product ``(z * D) @ B^T``, the
  selected steps, the weighted sums, ``B z_w``, the rank-µ update and
  ``|ps|``'s dot product) go through kernel M1 on the card (:func:`~evox_tpu_torch.kernels.smallmm.
  smallmm`): one fixed summation order that does not depend on the batch
  count, so a fleet tenant under ``torch.func.vmap`` equals its solo run
  bit for bit (cuBLAS picks its kernel by the batch count). A generation
  makes four launches: the ask's product; the tell's two groups of
  independent products (``smallmm_group``: the selected steps with ``w
  z``, then ``w y``, ``B z_w`` and the rank-µ product with ``w`` as its
  row scale); ``|ps|``'s dot product. On the CPU they stay ``einsum`` in
  full float32 (:func:`~.common.full_f32_matmul`), one bmm route that is
  already the same in a batch and alone.
- The restart variants choose between the continued and the restarted
  state field by field with ``torch.where`` on the device, in place of the
  JAX package's ``lax.cond``; the seed advances on every ``tell``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch

from ....core.algorithm import Algorithm
from ....core.device import DeviceLike, resolve_device
from ....core.distributed import POP_AXIS, P
from ....core.struct import PyTreeNode, field
from ....kernels.smallmm import smallmm, smallmm_group
from ....utils.common import float_vector, generator, split_seed
from .common import (
    bounded_sigma_step,
    capped_mu_weights,
    check_dense_scale,
    clamp_step_size,
    full_f32_matmul,
    mueff_of,
    recombination_weights as _stable_weights,
    safe_eigh,
    sorted_selection_moments,
    standard_normal,
    weights_at_ranks,
)


def _default_pop_size(dim: int) -> int:
    return 4 + math.floor(3 * math.log(dim))


def _hsig_denominator(cs: float, it: int) -> torch.Tensor:
    """``sqrt(1 - (1 - cs) ** (2 * it))`` with a float32 power, as the JAX
    package raises it; a 0-d CPU tensor, which enters a CUDA op as a scalar."""
    base = torch.tensor(1 - cs, dtype=torch.float32)
    return torch.sqrt(1 - torch.pow(base, torch.tensor(2.0 * it, dtype=torch.float32)))


def _m1_form(equation: str, a: torch.Tensor, b: torch.Tensor, scale=None):
    """One of CMA-ES's products, named by its ``einsum`` equation, as M1's
    ``(a, b, trans_a, trans_b, scale)`` and the view that turns M1's
    matrix into the product's shape."""
    if equation in ("pd,ed->pe", "md,ed->me"):  # rows times B^T
        return (a, b, False, True, scale), lambda c: c
    if equation == "m,md->d":  # a weighted sum of rows
        return (a[None, :], b, False, False, scale), lambda c: c[0]
    if equation == "de,e->d":  # B times a vector
        return (a, b[:, None], False, False, scale), lambda c: c[:, 0]
    if equation == "md,me->de":  # the rank-mu sum of outer products, rows of a scaled
        return (a, b, True, False, scale), lambda c: c
    raise ValueError(f"no M1 form for {equation!r}")


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor, scale=None) -> torch.Tensor:
    if scale is not None:
        a = a * scale[:, None]
    with full_f32_matmul():
        return torch.einsum(equation, a, b)


def _product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One of CMA-ES's products, named by its ``einsum`` equation: on the
    card kernel M1 (``smallmm``, one summation order whatever the batch
    count); on the CPU the ``einsum`` in full float32 (one bmm route, so a
    member's numbers under ``torch.func.vmap`` equal a solo run's there)."""
    if a.device.type != "cuda":
        return _einsum(equation, a, b)
    (A, B, ta, tb, _), view = _m1_form(equation, a, b)
    return view(smallmm(A, B, ta, tb, device=a.device))


def _products(*items: tuple) -> list:
    """Independent products ``(equation, a, b[, scale])`` (``scale``
    multiplies the rows of ``a`` first): on the card one grouped M1 launch
    (``smallmm_group``), each product's numbers those of its own launch;
    on the CPU :func:`_product`'s ``einsum`` each."""
    if items[0][1].device.type != "cuda":
        return [_einsum(*item) for item in items]
    forms = [_m1_form(*item) for item in items]
    outs = smallmm_group([prod for prod, _ in forms], device=items[0][1].device)
    return [view(c) for (_, view), c in zip(forms, outs)]


def _scalar(value: Any, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device: a divisor
    that divides the same way alone and under ``torch.func.vmap`` (on the
    card a Python-number divisor becomes a multiply by its reciprocal in a
    solo call and a true division in a batched one). On the CPU both are
    the true division, as before."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``|v|``: on the card the square root of M1's ``v . v`` (a reduction
    kernel sums a row of a batch in another order than a lone vector); on
    the CPU ``torch.linalg.vector_norm``."""
    if v.device.type != "cuda":
        return torch.linalg.vector_norm(v)
    return torch.sqrt(smallmm(v[None, :], v[:, None], device=v.device)[0, 0])


class CMAESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor  # 0-d
    pc: torch.Tensor
    ps: torch.Tensor
    C: torch.Tensor
    B: torch.Tensor
    D: torch.Tensor
    z: torch.Tensor = field(storage=True)  # (pop, dim) standard normals of the current generation
    iteration: int
    seed: int


class CMAES(Algorithm):
    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        recombination_weights: Any = None,
        cm: float = 1.0,
        decomp_per_iter: Optional[int] = None,
        sigma_floor: float = 1e-20,
        sigma_ceiling: float = 1e20,
        cond_cap: float = 1e14,
        eigh_max_dim: Optional[int] = 4096,
        dense_budget_elems: Optional[int] = 2**26,
        device: DeviceLike = None,
    ):
        if not init_stdev > 0:
            raise ValueError("init_stdev must be > 0")
        self.device = resolve_device(device)
        self.sigma_floor = sigma_floor
        self.sigma_ceiling = sigma_ceiling
        self.cond_cap = cond_cap
        self.eigh_max_dim = eigh_max_dim
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size or _default_pop_size(self.dim)
        check_dense_scale(self.dim, self.pop_size, eigh_max_dim, dense_budget_elems, "CMAES")
        self.cm = cm
        n, lam = self.dim, self.pop_size
        if recombination_weights is None:
            mu = lam // 2
            w = _stable_weights(mu, (lam + 1) / 2)
        else:
            w = torch.as_tensor(recombination_weights, dtype=torch.float32).cpu()
            mu = int(w.shape[0])
        self.mu = mu
        self.mueff = me = mueff_of(w)
        self.weights = w.to(self.device)
        self.cc = (4 + me / n) / (n + 4 + 2 * me / n)
        self.cs = (me + 2) / (n + me + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + me)
        self.cmu = min(1 - self.c1, 2 * (me - 2 + 1 / me) / ((n + 2) ** 2 + me))
        self.damps = 1 + 2 * max(0.0, math.sqrt((me - 1) / (n + 1)) - 1) + self.cs
        self.chiN = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))
        if decomp_per_iter is None:
            decomp_per_iter = max(1, round(1 / ((self.c1 + self.cmu) * n * 10)))
        self.decomp_per_iter = decomp_per_iter

    def init(self, seed: int) -> CMAESState:
        n, dev = self.dim, self.device
        return CMAESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            pc=torch.zeros(n, device=dev),
            ps=torch.zeros(n, device=dev),
            C=torch.eye(n, device=dev),
            B=torch.eye(n, device=dev),
            D=torch.ones(n, device=dev),
            z=torch.zeros((self.pop_size, n), device=dev),
            iteration=0,
            seed=seed,
        )

    def _draw(self, seed: int) -> torch.Tensor:
        """The one draw of a generation: ``(pop, dim)`` standard normals."""
        return standard_normal(seed, (self.pop_size, self.dim), self.device)

    def ask(self, state: CMAESState) -> Tuple[torch.Tensor, CMAESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        y = _product("pd,ed->pe", z * state.D, state.B)
        pop = state.mean + state.sigma * y
        return pop, state.replace(z=z, seed=seed)

    def tell(self, state: CMAESState, fitness: torch.Tensor) -> CMAESState:
        n = self.dim
        order = torch.argsort(fitness, stable=True)
        z_sorted = state.z[order[: self.mu]]
        y_sorted, z_w = _products(("md,ed->me", z_sorted * state.D, state.B),
                                  ("m,md->d", self.weights, z_sorted))
        # invsqrtC @ y_w == B z_w because y = B D z; the rank-mu product's
        # rows of y_sorted scaled by the weights
        y_w, Bz_w, rank_mu = _products(("m,md->d", self.weights, y_sorted),
                                       ("de,e->d", state.B, z_w),
                                       ("md,me->de", y_sorted, y_sorted, self.weights))
        mean = state.mean + self.cm * state.sigma * y_w
        ps = (1 - self.cs) * state.ps + math.sqrt(self.cs * (2 - self.cs) * self.mueff) * Bz_w
        it = state.iteration + 1
        ps_norm = _norm(ps)
        hsig = (ps_norm / _scalar(_hsig_denominator(self.cs, it), ps_norm)
                < (1.4 + 2 / (n + 1)) * self.chiN)
        hsig = hsig.to(torch.float32)
        pc = (1 - self.cc) * state.pc + hsig * math.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w
        C = (
            (1 - self.c1 - self.cmu) * state.C
            + self.c1 * (torch.outer(pc, pc) + (1 - hsig) * self.cc * (2 - self.cc) * state.C)
            + self.cmu * rank_mu
        )
        sigma = clamp_step_size(
            state.sigma * torch.exp(self.cs / self.damps * (ps_norm / _scalar(self.chiN, ps_norm) - 1)),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        B, D = state.B, state.D
        if it % self.decomp_per_iter == 0:
            B, D = self._decompose(C)
        return state.replace(mean=mean, sigma=sigma, pc=pc, ps=ps, C=C, B=B, D=D, iteration=it)

    def _decompose(self, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return safe_eigh(C, self.cond_cap, max_dim=self.eigh_max_dim)


class SepCMAESState(PyTreeNode):
    mean: torch.Tensor
    sigma: torch.Tensor
    pc: torch.Tensor
    ps: torch.Tensor
    C: torch.Tensor  # the covariance's diagonal
    z: torch.Tensor = field(storage=True, sharding=P(POP_AXIS))
    iteration: int
    seed: int


class SepCMAES(Algorithm):
    """Separable (diagonal-covariance) CMA-ES (Ros & Hansen 2008): O(d)
    memory. ``tell`` goes through the weighted moments of the selected
    samples (``pop_moments``, then ``tell_with_moments``), as in the JAX
    package. It speaks the POP-sharded protocol of
    :class:`~evox_tpu_torch.core.distributed.ShardedES` (``ask_rows``,
    ``rank_weights``, ``pop_moments``, ``tell_with_moments``)."""

    pop_fields = ("z",)
    pop_shard_capable = True
    sharded_pop_fields = ("z",)

    def __init__(
        self,
        center_init: Any,
        init_stdev: float,
        pop_size: Optional[int] = None,
        mu: Optional[int] = None,
        sigma_floor: float = 1e-20,
        sigma_ceiling: float = 1e20,
        device: DeviceLike = None,
    ):
        if not init_stdev > 0:
            raise ValueError("init_stdev must be > 0")
        self.device = resolve_device(device)
        self.sigma_floor = sigma_floor
        self.sigma_ceiling = sigma_ceiling
        self.center_init = float_vector(center_init, self.device)
        self.dim = int(self.center_init.shape[0])
        self.init_stdev = float(init_stdev)
        self.pop_size = pop_size or _default_pop_size(self.dim)
        n, lam = self.dim, self.pop_size
        mu, w = capped_mu_weights(lam, mu)
        self.mu = mu
        self.mueff = me = mueff_of(w)
        self.weights = w.to(self.device)
        self.cc = (4 + me / n) / (n + 4 + 2 * me / n)
        self.cs = (me + 2) / (n + me + 5)
        # the separable rate (n+2)/3 times the full one, capped at 1
        self.ccov = min(
            1.0,
            (n + 2) / 3 * min(
                1.0,
                2 * (me - 2 + 1 / me) / ((n + 2) ** 2 + me) + 2 / ((n + 1.3) ** 2 + me),
            ),
        )
        self.c1 = self.ccov * 2 / ((n + 1.3) ** 2 + me) / (
            2 / ((n + 1.3) ** 2 + me) + min(1.0, 2 * (me - 2 + 1 / me) / ((n + 2) ** 2 + me))
        )
        self.cmu = self.ccov - self.c1
        self.damps = 1 + 2 * max(0.0, math.sqrt((me - 1) / (n + 1)) - 1) + self.cs
        self.chiN = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))

    def init(self, seed: int) -> SepCMAESState:
        n, dev = self.dim, self.device
        return SepCMAESState(
            mean=self.center_init.clone(),
            sigma=torch.tensor(self.init_stdev, dtype=torch.float32, device=dev),
            pc=torch.zeros(n, device=dev),
            ps=torch.zeros(n, device=dev),
            C=torch.ones(n, device=dev),
            z=torch.zeros((self.pop_size, n), device=dev),
            iteration=0,
            seed=seed,
        )

    def _draw(self, seed: int, rows: Optional[int] = None) -> torch.Tensor:
        """The one draw: ``(rows, dim)`` standard normals (``pop_size`` rows
        by default; a shard's block through ``ask_rows``)."""
        return standard_normal(seed, (rows or self.pop_size, self.dim), self.device)

    def ask(self, state: SepCMAESState) -> Tuple[torch.Tensor, SepCMAESState]:
        seed, k = split_seed(state.seed)
        z = self._draw(k)
        pop = state.mean + state.sigma * torch.sqrt(state.C) * z
        return pop, state.replace(z=z, seed=seed)

    def ask_rows(self, state: SepCMAESState, seed: int, n_rows: int):
        """One shard's block of the sampling law: ``n_rows`` candidates
        from ``seed``, and their ``z``."""
        z = self._draw(seed, n_rows)
        return state.mean + state.sigma * torch.sqrt(state.C) * z, {"z": z}

    def rank_weights(self, ranks: torch.Tensor) -> torch.Tensor:
        return weights_at_ranks(self.weights, ranks, self.mu)

    def pop_moments(self, rows: dict, weights: torch.Tensor) -> dict:
        z = rows["z"]
        return {"zw": weights @ z, "zzw": weights @ (z**2)}

    def tell_with_moments(self, state: SepCMAESState, moments: dict,
                          fitness: torch.Tensor) -> SepCMAESState:
        n = self.dim
        z_w = moments["zw"]
        D = torch.sqrt(state.C)
        # y = z * D rowwise, so y_w = z_w * D and sum_i w_i y_i^2 = zzw * C
        y_w = z_w * D
        rank_mu = moments["zzw"] * state.C
        mean = state.mean + state.sigma * y_w
        ps = (1 - self.cs) * state.ps + math.sqrt(self.cs * (2 - self.cs) * self.mueff) * z_w
        it = state.iteration + 1
        ps_norm = torch.linalg.vector_norm(ps)
        hsig = (ps_norm / _hsig_denominator(self.cs, it) < (1.4 + 2 / (n + 1)) * self.chiN)
        hsig = hsig.to(torch.float32)
        pc = (1 - self.cc) * state.pc + hsig * math.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w
        C = (
            (1 - self.c1 - self.cmu) * state.C
            + self.c1 * (pc**2 + (1 - hsig) * self.cc * (2 - self.cc) * state.C)
            + self.cmu * rank_mu
        )
        C = torch.clamp_min(C, 1e-20)
        sigma = bounded_sigma_step(
            state.sigma,
            self.cs / self.damps * (ps_norm / self.chiN - 1),
            self.sigma_floor,
            self.sigma_ceiling,
        )
        return state.replace(mean=mean, sigma=sigma, pc=pc, ps=ps, C=C, iteration=it)

    def tell(self, state: SepCMAESState, fitness: torch.Tensor) -> SepCMAESState:
        moments, _ = sorted_selection_moments(self, state, fitness)
        return self.tell_with_moments(state, moments, fitness)


class _RestartCMAES(CMAES):
    """CMA-ES that restarts in place when the fitness spread of a generation
    falls below ``stagnation_tol`` or sigma leaves ``[1e-16, 1e16]``: the
    strategy state resets and the mean is drawn uniformly in
    ``restart_bounds``. The pop size stays; ``RestartCMAESDriver`` grows it."""

    def __init__(self, *args: Any, stagnation_tol: float = 1e-12,
                 restart_bounds: Tuple[float, float] = (-1.0, 1.0), **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.stagnation_tol = stagnation_tol
        self.restart_bounds = restart_bounds

    def _draw_restart(self, seed: int) -> torch.Tensor:
        """A restart's mean: ``(dim,)`` uniform in ``restart_bounds``."""
        lo, hi = self.restart_bounds
        u = torch.rand(self.dim, generator=generator(seed, self.device), device=self.device)
        return u * (hi - lo) + lo

    def tell(self, state: CMAESState, fitness: torch.Tensor) -> CMAESState:
        new = super().tell(state, fitness)
        spread = torch.max(fitness) - torch.min(fitness)
        degenerate = (
            (spread < self.stagnation_tol)
            | (new.sigma < 1e-16)
            | (new.sigma > 1e16)
            | ~torch.isfinite(new.sigma)
        )
        seed, k = split_seed(new.seed)
        fresh = self.init(seed).replace(mean=self._draw_restart(k))
        chosen = {
            name: torch.where(degenerate, getattr(fresh, name), getattr(new, name))
            for name in ("mean", "sigma", "pc", "ps", "C", "B", "D", "z")
        }
        return new.replace(seed=seed, **chosen)


class IPOPCMAES(_RestartCMAES):
    """Restart-CMA-ES at a fixed pop size (``RestartCMAESDriver`` doubles
    it, IPOP)."""


class BIPOPCMAES(_RestartCMAES):
    """Restart-CMA-ES at a fixed pop size (``RestartCMAESDriver`` with
    ``bipop=True`` runs the two-regime budget schedule)."""


class RestartCMAESDriver:
    """Host-level IPOP/BIPOP driver (Auger & Hansen 2005; Hansen 2009).

    Runs CMA-ES to stagnation, then restarts with a doubled population
    (IPOP), or alternates large and small populations by their spent
    budgets (BIPOP). A plain host loop of eager generations; it reads the
    fitness's min and max and sigma once a generation.

    Usage::

        driver = RestartCMAESDriver(center_init, init_stdev, evaluate_fn)
        best_x, best_f = driver.run(seed, max_restarts=5, gens_per_run=200)
    """

    def __init__(self, center_init: Any, init_stdev: float,
                 evaluate_fn: Callable[[torch.Tensor], torch.Tensor], bipop: bool = False,
                 base_pop_size: Optional[int] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.center_init = float_vector(center_init, self.device)
        self.init_stdev = init_stdev
        self.evaluate_fn = evaluate_fn
        self.bipop = bipop
        self.base_pop_size = base_pop_size or _default_pop_size(self.center_init.shape[0])
        self.pop_sizes: list = []  # the pop size of each run of the last ``run``

    def _draw_regime(self, seed: int) -> float:
        """BIPOP's small-regime draw: one uniform number in [0, 1)."""
        return float(torch.rand((), generator=generator(seed, torch.device("cpu"))))

    def run(self, seed: int, max_restarts: int = 5, gens_per_run: int = 200):
        """``(best_x, best_f)``: the best candidate seen (a tensor) and its
        fitness (a float)."""
        best_x, best_f = None, math.inf
        large_pop = self.base_pop_size
        budget_large, budget_small = 0, 0
        self.pop_sizes = []
        for restart in range(max_restarts):
            seed, k_init, k_regime = split_seed(seed, 3)
            small_regime = self.bipop and restart > 0 and budget_small < budget_large
            if small_regime:
                u = self._draw_regime(k_regime)
                ratio = (large_pop / self.base_pop_size) ** (u**2)
                lam = max(4, int(self.base_pop_size * ratio) // 2 * 2)
            else:
                if restart > 0:
                    large_pop *= 2  # IPOP growth, large regime only
                lam = large_pop
            self.pop_sizes.append(lam)
            algo = CMAES(self.center_init, self.init_stdev, pop_size=lam, device=self.device)
            state = algo.init(k_init)
            gens_done = 0
            for _ in range(gens_per_run):
                pop, state = algo.ask(state)
                fit = self.evaluate_fn(pop)
                state = algo.tell(state, fit)
                gens_done += 1
                i = torch.argmin(fit)
                spread = torch.max(fit) - torch.min(fit)
                f_min, spread, sigma = torch.stack([fit[i], spread, state.sigma]).tolist()
                if f_min < best_f:
                    best_f, best_x = f_min, pop[i]
                if spread < 1e-12 or not math.isfinite(sigma):
                    break
            if small_regime:
                budget_small += gens_done * lam
            else:
                budget_large += gens_done * lam
        return best_x, best_f
