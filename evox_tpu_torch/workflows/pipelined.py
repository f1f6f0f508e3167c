"""The generation loop for host problems — the port of
``evox_tpu/workflows/pipelined.py``.

``run_host_pipelined`` runs a :class:`~evox_tpu_torch.workflows.std.
StdWorkflow` whose problem lives on the host through the
:class:`~evox_tpu_torch.core.executor.GenerationExecutor`: the host
``evaluate`` runs on the calling thread and the user's per-generation host
work (``on_generation``: logging, plotting, metrics) for generation ``g``
on a background lane while generation ``g+1`` is asked and evaluated.
At ``max_staleness=0`` the dependency chain evaluate → tell → ask →
evaluate is untouched, so the states equal a ``wf.step`` loop's bit for
bit; ``max_staleness=K > 0`` keeps ``K+1`` evaluations in flight with
stale tells. For a problem that runs on the card use ``wf.run``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.executor import GenerationExecutor
from ..utils.common import tree_flatten, tree_map
from .checkpoint import WorkflowCheckpointer


def chunked_evaluate(problem: Any, pstate: Any, cand: Any, eval_chunk: Optional[int]):
    """``problem.evaluate`` over row slices of at most ``eval_chunk``
    candidates, the fitness concatenated. Chunking is invisible exactly
    when the host ``evaluate`` scores rows independently of their batch.
    The problem state threads through the chunks in order and the last
    chunk's state is kept. A problem that returns tensors gets a tensor
    concatenation, one that returns numpy gets numpy."""
    if eval_chunk is None:
        return problem.evaluate(pstate, cand)
    if eval_chunk < 1:
        raise ValueError(f"eval_chunk must be >= 1, got {eval_chunk}")
    n = tree_flatten(cand)[0][0].shape[0]
    if eval_chunk >= n:
        return problem.evaluate(pstate, cand)
    fits = []
    for lo in range(0, n, eval_chunk):
        part = tree_map(lambda x: x[lo:lo + eval_chunk], cand)
        fit, pstate = problem.evaluate(pstate, part)
        fits.append(fit)
    if any(isinstance(f, torch.Tensor) for f in fits):
        return torch.cat([torch.as_tensor(f) for f in fits], dim=0), pstate
    return np.concatenate([np.asarray(f) for f in fits], axis=0), pstate


def run_host_pipelined(
    wf: Any,
    state: Any,
    n_steps: int,
    on_generation: Optional[Callable[[int, Any, Any], None]] = None,
    checkpointer: Optional[WorkflowCheckpointer] = None,
    resume_from: Any = None,
    restarts: Any = None,
    eval_chunk: Optional[int] = None,
    max_staleness: Optional[int] = None,
    executor: Optional[GenerationExecutor] = None,
):
    """Run ``n_steps`` generations of ``wf`` (a :class:`StdWorkflow` whose
    problem is external), ``on_generation(gen_index, state, fitness)`` on
    the executor's hook lane (it may read the state's tensors; an error it
    raises surfaces before the next tell). Returns the final state, equal to
    ``for _ in range(n_steps): state = wf.step(state)``.

    ``checkpointer=`` snapshots whenever ``state.generation`` reaches a
    multiple of its cadence, and the final state; ``resume_from=`` (a
    :class:`WorkflowCheckpointer` or a directory) restores the newest intact
    snapshot and makes ``n_steps`` the total. A host problem that keeps
    state on its object (its own RNG) is outside the snapshot: a resume
    reproduces the straight run when ``evaluate`` is deterministic.

    ``eval_chunk=``: evaluate in row slices of at most this many candidates
    (:func:`chunked_evaluate`). ``restarts=`` (``IPOPRestarts``) runs the
    IPOP policy over pipelined segments.

    ``max_staleness=K`` (``None``, the default, takes the ``executor``'s
    configured bound, else 0): admit tells up to ``K`` generations stale —
    up to ``K+1`` host evaluations in flight on worker threads, each tell
    grafted onto the newest told state with its own ask's artifacts
    (:class:`~evox_tpu_torch.core.executor.GenerationExecutor`). ``K=0``
    equals a ``wf.step`` loop bit for bit; ``K>0`` trades the freshness of
    each update for throughput when host evaluations can run concurrently.

    ``executor=``: the executor to drive (its counters accumulate and
    surface in ``run_report()["executor"]``); a fresh one otherwise."""
    if not wf.external:
        raise ValueError(
            "run_host_pipelined is for external (host) problems; problems that "
            "run on the card should use wf.run()"
        )
    if restarts is not None:
        from .ipop import ipop_run

        return ipop_run(
            wf, state, n_steps, restarts,
            segment=lambda w, s, c, ck: run_host_pipelined(
                w, s, c, on_generation=on_generation, checkpointer=ck,
                eval_chunk=eval_chunk, max_staleness=max_staleness, executor=executor,
            ),
            checkpointer=checkpointer,
            resume_from=resume_from,
        )
    ex = executor if executor is not None else GenerationExecutor(max_staleness=max_staleness or 0)
    return ex.run_host(wf, state, n_steps, on_generation=on_generation,
                       checkpointer=checkpointer, resume_from=resume_from,
                       eval_chunk=eval_chunk, max_staleness=max_staleness)
