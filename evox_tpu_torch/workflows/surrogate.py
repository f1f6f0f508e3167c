"""SurrogateWorkflow — the port of ``evox_tpu/workflows/surrogate.py``:
spend cheap device work to cut true evaluations of an expensive problem.

Each generation the whole ask goes through a surrogate model
(:mod:`evox_tpu_torch.operators.surrogate`); only the ``screen_frac``
fraction with the best predicted fitness reaches the real problem. The
rows left out are inert: filled with the worst finite truly evaluated
value, so they lose every comparison. A generation falls back to full
evaluation while the archive warms up, when the model's Spearman rank
correlation on the last evaluated subset fell below ``rank_floor``, or
when its mean uncertainty on this ask exceeds ``unc_ceiling``; every
decision is counted in the state and reported by
:meth:`SurrogateWorkflow.surrogate_report`.

Where JAX picks the screened or the full evaluation with ``lax.cond``,
eager PyTorch needs the row count on the host:

- ``step`` (a problem on the card, or a host problem evaluated
  synchronously) reads the plan's ``full_eval`` flag once a generation,
  and nothing else, and refits inline on the ``refit_every`` cadence;
- ``run`` with a host problem goes through the executor
  (``run_host_pipelined``): ``pipeline_ask`` hands the candidates and the
  row count to :meth:`SurrogateWorkflow.host_evaluate`, which reads the
  count with the candidates' one copy, and the executor calls
  ``refit_due``/``dispatch_refit`` after each tell: the refit queues on
  the card's stream and the loop goes on. Both drivers refit at the same
  absolute generations on the same archive, so a pipelined run equals a
  ``step`` loop and a resumed run the straight one.

Disabled (``surrogate=None`` or ``screen_frac=1.0``) is ``StdWorkflow``
unchanged, bit for bit. ``mesh`` is ``StdWorkflow``'s; ``eval_shard_map``
composes only with screening off (the evaluated rows of a screened
generation are a slice the per-shard blocks cannot tile). Under a
``RunSupervisor`` (``workflows/supervisor.py``) a screened run is retried
and replayed like any other, and the OOM rung's halved ``eval_chunk``
reaches :meth:`SurrogateWorkflow.host_evaluate`.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.algorithm import Algorithm
from ..core.dtype_policy import apply_compute, apply_storage
from ..core.instrument import sanitize_json
from ..core.problem import Problem
from ..core.struct import PyTreeNode
from ..operators.surrogate import SurrogateArchive, spearman_correlation
from ..utils.common import fold_in_seed, tree_flatten, tree_map
from ..utils.ring import ring_slots, ring_write
from .common import finish_step, host_candidates, ingest_fitness, quarantine_nonfinite
from .std import StdWorkflow, StdWorkflowState

__all__ = [
    "FALLBACK_RANK",
    "FALLBACK_UNCERTAINTY",
    "SurrogateState",
    "SurrogateWorkflow",
    "SurrogateWorkflowState",
    "masked_worst_finite_fill",
]

# bits of a fallback event's reason
FALLBACK_RANK = 1  # predicted/true rank correlation below rank_floor
FALLBACK_UNCERTAINTY = 2  # mean uncertainty above unc_ceiling


class SurrogateState(PyTreeNode):
    """The surrogate's part of the workflow state: the archive, the fitted
    model, the health readings and the true-evaluation ledger, every
    counter a 0-d int32 tensor (no host read to update one)."""

    archive: Any  # ArchiveState
    model: Any  # GPModelState or EnsembleModelState
    seed: int  # the refit stream (each refit folds in its generation)
    refits: torch.Tensor
    last_refit_gen: torch.Tensor
    # health: set from the last evaluated subset, read by the next ask
    fallback_next: torch.Tensor  # () bool
    last_rank_corr: torch.Tensor  # () float32
    last_uncertainty: torch.Tensor  # () float32
    # the ledger
    candidates_seen: torch.Tensor  # rows asked
    true_evals: torch.Tensor  # rows truly evaluated
    screened_out: torch.Tensor  # rows never evaluated
    generations: torch.Tensor
    screened_gens: torch.Tensor
    fallback_gens: torch.Tensor  # triggered full-evaluation generations
    warmup_gens: torch.Tensor
    # fallback events (generation, reason bits), a ring of fallback_log
    fb_gens: torch.Tensor
    fb_reasons: torch.Tensor
    fb_count: torch.Tensor


class SurrogateWorkflowState(StdWorkflowState):
    sur: Any = None


class _ScreenPlan(NamedTuple):
    """One generation's screening decision, all on the device."""

    order: torch.Tensor  # (n,) evaluation order (identity under full evaluation)
    n_eval: torch.Tensor  # () int32 rows to evaluate truly
    full_eval: torch.Tensor  # () bool
    warm: torch.Tensor  # () bool: archive filled and model fitted
    mean_perm: torch.Tensor  # (n,) predicted fitness in evaluation order
    unc_mean: torch.Tensor  # () mean uncertainty over the ask
    reason: torch.Tensor  # () int32 fallback bits (0: none or warm-up)


def masked_worst_finite_fill(fitness: torch.Tensor, eval_mask: torch.Tensor) -> torch.Tensor:
    """Rows outside ``eval_mask`` take the worst finite truly evaluated
    value (the dtype's largest finite value when there is none); evaluated
    rows pass through unchanged, a non-finite one included. ``(n,)``."""
    finite = eval_mask & torch.isfinite(fitness)
    worst = torch.where(finite, fitness, float("-inf")).amax()
    worst = torch.where(torch.isfinite(worst), worst, torch.finfo(fitness.dtype).max)
    return torch.where(eval_mask, fitness, worst)


def _i32(value: int, like: torch.Tensor) -> torch.Tensor:
    # a fill launch, not a copy of a host scalar (which would wait for the stream)
    return torch.full((), value, dtype=torch.int32, device=like.device)


class SurrogateWorkflow(StdWorkflow):
    """Drive any single-objective algorithm with surrogate pre-screened
    evaluation, with :class:`StdWorkflow`'s API (``step``, ``run``,
    ``resume``, the pipelined halves, checkpointing). The module docstring
    has the design.

    Args:
        algorithm, problem, **std_kwargs: as :class:`StdWorkflow`.
        surrogate: a model with ``init_model``/``fit``/``predict``
            (:class:`~evox_tpu_torch.operators.surrogate.GPSurrogate`,
            :class:`~evox_tpu_torch.operators.surrogate.EnsembleSurrogate`);
            ``None`` disables screening.
        screen_frac: fraction of each ask evaluated truly (``k =
            ceil(screen_frac * width)``, at least 1); ``1.0`` disables.
        archive_capacity: the archive's size; ``None`` is 4x the widest ask.
            An explicit one must hold the widest ask.
        warmup: archived pairs before screening starts (default: the widest
            ask).
        refit_every: refit cadence in generations.
        rank_floor: Spearman floor between predicted and true fitness on a
            generation's evaluated rows; below it the next generation
            evaluates fully.
        unc_ceiling: mean-uncertainty ceiling over the ask; above it this
            generation evaluates fully. ``None``: off.
        fallback_log: how many fallback events the state keeps.
    """

    def __init__(
        self,
        algorithm: Algorithm,
        problem: Problem,
        surrogate: Any = None,
        screen_frac: float = 1.0,
        archive_capacity: Optional[int] = None,
        warmup: Optional[int] = None,
        refit_every: int = 1,
        rank_floor: float = 0.5,
        unc_ceiling: Optional[float] = None,
        fallback_log: int = 64,
        **std_kwargs: Any,
    ):
        if not (0.0 < screen_frac <= 1.0):
            raise ValueError(f"screen_frac must be in (0, 1], got {screen_frac}")
        if refit_every < 1:
            raise ValueError(f"refit_every must be >= 1, got {refit_every}")
        if fallback_log < 1:
            raise ValueError(f"fallback_log must be >= 1, got {fallback_log}")
        if surrogate is not None:
            for meth in ("init_model", "fit", "predict"):
                if not callable(getattr(surrogate, meth, None)):
                    raise TypeError(
                        f"surrogate must implement {meth}(); got {type(surrogate).__name__}"
                    )
        self.surrogate = surrogate
        self.screen_frac = float(screen_frac)
        self.refit_every = int(refit_every)
        self.rank_floor = float(rank_floor)
        self.unc_ceiling = float(unc_ceiling) if unc_ceiling is not None else None
        self.fallback_log = int(fallback_log)
        self._screening = surrogate is not None and self.screen_frac < 1.0
        if self._screening and std_kwargs.get("eval_shard_map"):
            raise ValueError(
                "surrogate screening cannot compose with eval_shard_map: the truly evaluated "
                "rows are a slice the per-shard blocks cannot tile; evaluate without it")
        super().__init__(algorithm, problem, **std_kwargs)
        self._sur_kwargs = dict(
            surrogate=surrogate, screen_frac=screen_frac, archive_capacity=archive_capacity,
            warmup=warmup, refit_every=refit_every, rank_floor=rank_floor,
            unc_ceiling=unc_ceiling, fallback_log=fallback_log,
        )
        if self._screening:
            dev = getattr(surrogate, "device", None)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(
                    f"{type(surrogate).__name__} runs on {dev}, the workflow on {self.device}"
                )
            self._derive_shapes(archive_capacity, warmup)

    # ------------------------------------------------------------ shape prep
    def _derive_shapes(self, archive_capacity: Optional[int], warmup: Optional[int]) -> None:
        # the ask's shapes from one real init and ask (eager PyTorch has no
        # abstract evaluation)
        astate = self.algorithm.init(0)
        probes = [self.algorithm.ask(astate)[0]]
        if self.algorithm.has_init_ask:
            probes.append(self.algorithm.init_ask(astate)[0])
        widths = []
        for pop in probes:
            if not isinstance(pop, torch.Tensor) or pop.ndim != 2:
                raise ValueError(
                    "surrogate screening requires flat 2-D (pop, dim) candidates "
                    f"from ask; got {getattr(pop, 'shape', type(pop).__name__)} — flatten the "
                    "genotype before the workflow (pop_transforms map candidates AFTER "
                    "screening) or disable screening"
                )
            widths.append(int(pop.shape[0]))
        steady = widths[0]
        if self._k_for(steady) >= steady:
            raise ValueError(
                f"screen_frac={self.screen_frac} screens nothing at the steady ask width "
                f"{steady} (ceil(screen_frac * width) = {self._k_for(steady)} >= width); "
                "lower screen_frac, or pass screen_frac=1.0 to disable screening explicitly"
            )
        self._dim = int(probes[0].shape[1])
        self._max_width = max(widths)
        if archive_capacity is None:
            cap = 4 * self._max_width
        else:
            cap = int(archive_capacity)
            if cap < self._max_width:
                raise ValueError(
                    f"archive_capacity {cap} is smaller than the widest ask batch "
                    f"({self._max_width}); one generation's scatter would collide "
                    "with itself inside the ring"
                )
        check = getattr(self.surrogate, "check_capacity", None)
        if check is not None:
            check(cap)  # the GP's dense-scale guard, at construction
        self._archive = SurrogateArchive(cap)
        self._warmup = int(warmup) if warmup is not None else self._max_width

    def clone_with_algorithm(self, algorithm: Algorithm) -> "SurrogateWorkflow":
        # IPOP's rebuild: a defaulted capacity and warmup follow the new width
        return SurrogateWorkflow(algorithm, **dict(self._ctor_args, **self._sur_kwargs))

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> SurrogateWorkflowState:
        base = super().init(seed)
        sur = None
        if self._screening:
            dev = self.device
            zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
            log = self.fallback_log
            sur = SurrogateState(
                archive=self._archive.init(self._dim, device=dev),
                model=self.surrogate.init_model(self._archive.capacity, self._dim),
                # disjoint from the algorithm's, problem's and monitors'
                # seeds, so a disabled run is StdWorkflow's bit for bit
                seed=fold_in_seed(seed, 0x5A6E),
                refits=zero(),
                last_refit_gen=zero(),
                fallback_next=torch.zeros((), dtype=torch.bool, device=dev),
                last_rank_corr=torch.ones((), device=dev),
                last_uncertainty=torch.zeros((), device=dev),
                candidates_seen=zero(), true_evals=zero(), screened_out=zero(),
                generations=zero(), screened_gens=zero(), fallback_gens=zero(),
                warmup_gens=zero(),
                fb_gens=torch.zeros((log,), dtype=torch.int32, device=dev),
                fb_reasons=torch.zeros((log,), dtype=torch.int32, device=dev),
                fb_count=zero(),
            )
        state = SurrogateWorkflowState(generation=base.generation, algo=base.algo, prob=base.prob,
                                       monitors=base.monitors, first_step=True, sur=sur)
        return apply_storage(state, self.dtype_policy)

    # ------------------------------------------------------------- screening
    def _k_for(self, width: int) -> int:
        return max(1, int(math.ceil(self.screen_frac * width)))

    def _screen_plan(self, sur: SurrogateState, pop: Any) -> _ScreenPlan:
        if not isinstance(pop, torch.Tensor) or pop.ndim != 2:
            raise ValueError(
                "surrogate screening requires flat 2-D (pop, dim) candidates from ask; "
                f"got shape {getattr(pop, 'shape', None)}"
            )
        n, dev = pop.shape[0], pop.device
        k = self._k_for(n)
        mean, unc = self.surrogate.predict(sur.model, pop.to(torch.float32))
        if k >= n:
            # this width cannot screen (a wider init_ask batch): a warm-up
            # generation, never a fallback event
            warm = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            warm = (self._archive.fill(sur.archive) >= self._warmup) & (sur.refits > 0)
        unc_mean = unc.mean()
        ceiling = self.unc_ceiling if self.unc_ceiling is not None else float("inf")
        unc_trip = warm & (unc_mean > ceiling)
        rank_trip = warm & sur.fallback_next
        full_eval = ~warm | rank_trip | unc_trip
        order = torch.where(full_eval, torch.arange(n, device=dev),
                            torch.argsort(mean, stable=True))
        return _ScreenPlan(
            order=order,
            n_eval=torch.where(full_eval, n, k).to(torch.int32),
            full_eval=full_eval,
            warm=warm,
            mean_perm=mean[order],
            unc_mean=unc_mean,
            reason=rank_trip.to(torch.int32) * FALLBACK_RANK
            + unc_trip.to(torch.int32) * FALLBACK_UNCERTAINTY,
        )

    def _screened_evaluate(self, pstate: Any, cand: Any, full_eval: torch.Tensor,
                           k: int) -> Tuple[torch.Tensor, Any]:
        """The leading ``k`` rows (the rest padded +inf, masked later) or
        the whole batch: the step path's one host read, ``full_eval``."""
        n = tree_flatten(cand)[0][0].shape[0]
        if k >= n or bool(full_eval):
            return self._evaluate(pstate, cand)
        fit, ps = self._evaluate(pstate, tree_map(lambda x: x[:k], cand))
        pad = torch.full((n - k,), float("inf"), dtype=fit.dtype, device=fit.device)
        return torch.cat([fit, pad]), ps

    def _refit_model(self, sur: SurrogateState, archive: Any, gen_after: int) -> Any:
        """The one refit body of both drivers: the archive's live rows, the
        seed folded with the generation."""
        return self.surrogate.fit(sur.model, archive.x.to(torch.float32), archive.y,
                                  self._archive.valid_mask(archive),
                                  fold_in_seed(sur.seed, gen_after))

    def _update_sur(self, sur: SurrogateState, generation: int, raw_perm: torch.Tensor,
                    flipped_perm: torch.Tensor, eval_mask: torch.Tensor, plan: _ScreenPlan,
                    refit_inline: bool) -> SurrogateState:
        gen_after = int(generation) + 1
        archive = self._archive.update(sur.archive, raw_perm, flipped_perm,
                                       eval_mask & torch.isfinite(flipped_perm))
        # health: can the model order what was truly measured?
        corr = spearman_correlation(plan.mean_perm, flipped_perm, eval_mask)
        fallback_next = (sur.refits > 0) & (corr < self.rank_floor)
        model, refits, last_refit = sur.model, sur.refits, sur.last_refit_gen
        if refit_inline and gen_after % self.refit_every == 0:
            # the step path's refit; host-driven runs refit through the
            # executor's dispatch_refit at the same generations
            model = self._refit_model(sur, archive, gen_after)
            refits = refits + 1
            last_refit = _i32(gen_after, last_refit)
        n = eval_mask.shape[0]
        ev = plan.full_eval & plan.warm  # a triggered fallback, not warm-up
        i32 = lambda b: b.to(torch.int32)
        return SurrogateState(
            archive=archive,
            model=model,
            seed=sur.seed,
            refits=refits,
            last_refit_gen=last_refit,
            fallback_next=fallback_next,
            last_rank_corr=corr,
            last_uncertainty=plan.unc_mean,
            candidates_seen=sur.candidates_seen + n,
            true_evals=sur.true_evals + plan.n_eval,
            screened_out=sur.screened_out + (n - plan.n_eval),
            generations=sur.generations + 1,
            screened_gens=sur.screened_gens + i32(~plan.full_eval),
            fallback_gens=sur.fallback_gens + i32(ev),
            warmup_gens=sur.warmup_gens + i32(~plan.warm),
            fb_gens=ring_write(sur.fb_gens, _i32(gen_after, sur.fb_count), sur.fb_count, cond=ev),
            fb_reasons=ring_write(sur.fb_reasons, plan.reason, sur.fb_count, cond=ev),
            fb_count=sur.fb_count + i32(ev),
        )

    # ------------------------------------------- the generation, in halves
    def _ask_half(self, state: SurrogateWorkflowState) -> Tuple[Any, Any]:
        state = apply_compute(state, self.dtype_policy)
        mstates = list(state.monitors)
        self._run_hooks("pre_step", mstates)
        self._run_hooks("pre_ask", mstates)
        pop, astate = self._dispatch_ask(state)
        self._run_hooks("post_ask", mstates, pop)
        plan = self._screen_plan(state.sur, pop)
        raw_perm = pop.to(torch.float32)[plan.order]
        cand = pop[plan.order]
        for t in self.pop_transforms:
            cand = t(cand)
        self._run_hooks("pre_eval", mstates, cand)
        return cand, (astate, tuple(mstates), (cand, raw_perm, plan))

    def _tell_half(self, state: SurrogateWorkflowState, ctx: Any, fitness: Any, pstate: Any,
                   refit_inline: bool) -> SurrogateWorkflowState:
        astate, mstates_t, (cand, raw_perm, plan) = ctx
        mstates = list(mstates_t)
        if not isinstance(fitness, torch.Tensor):
            fitness = self.host_link.to_device(fitness)
        if fitness.ndim != 1:
            raise ValueError(
                "surrogate screening is single-objective (the rank predicates and the "
                f"worst-finite fill are); got fitness of shape {tuple(fitness.shape)}"
            )
        n = fitness.shape[0]
        eval_mask = torch.arange(n, device=fitness.device) < plan.n_eval
        flipped = self._flip(fitness)
        filled = masked_worst_finite_fill(flipped, eval_mask)
        # monitors see the evaluation-order batch, inert rows filled, in the
        # user's direction
        self._run_hooks("post_eval", mstates, cand, filled * self.opt_direction[0])
        fit = quarantine_nonfinite(filled) if self.quarantine_nonfinite else filled
        fit = torch.index_copy(fit, 0, plan.order, fit)  # back to ask order for tell
        astate = ingest_fitness(self, astate, mstates, fit, self._use_init(state))
        astate = apply_storage(astate, self.dtype_policy)
        sur = self._update_sur(state.sur, state.generation, raw_perm, flipped, eval_mask, plan,
                               refit_inline)
        sur = apply_storage(sur, self.dtype_policy)
        self._run_hooks("post_tell", mstates)
        new_state = state.replace(generation=state.generation + 1, algo=astate, prob=pstate,
                                  monitors=tuple(mstates), first_step=False, sur=sur)
        return finish_step(self.monitors, self._hook_table, new_state)

    def _step_impl(self, state: SurrogateWorkflowState) -> SurrogateWorkflowState:
        if not self._screening:
            return super()._step_impl(state)
        cand, ctx = self._ask_half(state)
        plan = ctx[2][2]
        fitness, pstate = self._screened_evaluate(state.prob, cand, plan.full_eval,
                                                  self._k_for(plan.order.shape[0]))
        return self._tell_half(state, ctx, fitness, pstate, refit_inline=True)

    def _pipeline_ask_impl(self, state: SurrogateWorkflowState) -> Tuple[Any, Any]:
        """``((candidates, rows to evaluate), ctx)`` when screening: only
        the leading ``n_eval`` rows reach the problem
        (:meth:`host_evaluate`)."""
        if not self._screening:
            return super()._pipeline_ask_impl(state)
        cand, ctx = self._ask_half(state)
        return (cand, ctx[2][2].n_eval), ctx

    def _pipeline_tell_impl(self, state: SurrogateWorkflowState, ctx: Any, fitness: Any,
                            pstate: Any) -> SurrogateWorkflowState:
        if not self._screening:
            return super()._pipeline_tell_impl(state, ctx, fitness, pstate)
        # the refit is the executor's (dispatch_refit), one owner per driver
        return self._tell_half(state, ctx, fitness, pstate, refit_inline=False)

    # ------------------------------------------------- executor host hooks
    def host_evaluate(self, pstate: Any, cand: Any, eval_chunk: Optional[int]):
        """The executor's host evaluation: the candidates and their row
        count reach the host in one copy; only the ``n_eval`` leading rows
        are evaluated (in slices of ``eval_chunk``), and the fitness is
        padded back to the batch's width with +inf, which the tell masks
        out."""
        from .pipelined import chunked_evaluate

        if not self._screening:
            return chunked_evaluate(self.problem, pstate, host_candidates(self.host_link, cand),
                                    eval_chunk)
        host_cand, n_eval = host_candidates(self.host_link, cand)
        n = int(n_eval)
        width = tree_flatten(host_cand)[0][0].shape[0]
        fit, ps = chunked_evaluate(self.problem, pstate,
                                   tree_map(lambda x: x[:n], host_cand), eval_chunk)
        if n >= width:
            return fit, ps
        if isinstance(fit, torch.Tensor):
            return torch.cat([fit, fit.new_full((width - n,), float("inf"))]), ps
        fit = np.asarray(fit)
        return np.concatenate([fit, np.full((width - n,), np.inf, fit.dtype)]), ps

    def refit_due(self, generation: int) -> bool:
        """The executor's cadence predicate after each tell (pure in the
        absolute generation, so a resumed run keeps the schedule)."""
        return self._screening and generation >= 1 and generation % self.refit_every == 0

    def dispatch_refit(self, state: Any, generation: int) -> Any:
        """Refit on the current archive and splice the model into the
        state: the inline refit's body and seed, at the same generations.
        Nothing is read back, so the work queues on the card's stream."""
        return state.replace(sur=self._refit_impl(state.sur, int(generation)))

    def _refit_impl(self, sur: SurrogateState, gen: int) -> SurrogateState:
        # gen is the post-tell generation: the archive already holds its rows
        return sur.replace(model=self._refit_model(sur, sur.archive, gen), refits=sur.refits + 1,
                           last_refit_gen=_i32(gen, sur.last_refit_gen))

    # ------------------------------------------------------------- reporting
    def surrogate_report(self, state: Any) -> dict:
        """The ``surrogate`` section of the JAX package's ``run_report``:
        archive fill, refits, the screened-against-true ledger, the health
        readings and the fallback events, oldest first (a host read)."""
        out: dict = {
            "enabled": bool(self._screening),
            "model": getattr(self.surrogate, "kind", None) if self.surrogate is not None else None,
            "screen_frac": self.screen_frac,
        }
        sur = getattr(state, "sur", None)
        if sur is None or not self._screening:
            return sanitize_json(out)
        slots = ring_slots(int(sur.fb_count), self.fallback_log)
        gens = sur.fb_gens.cpu().numpy()
        reasons = sur.fb_reasons.cpu().numpy()
        out.update(
            archive={
                "capacity": self._archive.capacity,
                "fill": int(self._archive.fill(sur.archive)),
                "writes": int(sur.archive.count),
            },
            refit={
                "count": int(sur.refits),
                "every": self.refit_every,
                "last_generation": int(sur.last_refit_gen),
                # the model an ask reads is at most this many generations old
                "max_staleness_gens": self.refit_every,
            },
            counters={name: int(getattr(sur, name)) for name in (
                "candidates_seen", "true_evals", "screened_out", "generations", "screened_gens",
                "fallback_gens", "warmup_gens")},
            health={
                "rank_floor": self.rank_floor,
                "unc_ceiling": self.unc_ceiling,
                "last_rank_corr": float(sur.last_rank_corr),
                "last_uncertainty": float(sur.last_uncertainty),
                "fallback_armed": bool(sur.fallback_next),
            },
            fallback_events=[{"generation": int(gens[s]), "reason": int(reasons[s])}
                             for s in slots],
        )
        return sanitize_json(out)
