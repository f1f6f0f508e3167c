"""Plot helpers for decision- and objective-space trajectories — the port
of ``evox_tpu/vis_tools/plot.py``. The four entry points of the
reference's plotly module as matplotlib figures; ``animated=True`` gives a
``FuncAnimation`` stepping through the generations instead of a static
figure of the last one (save it with ``anim.save(..., writer="pillow")``).
matplotlib is imported at the first call, so the module loads without it.

Every function takes a list of per-generation arrays, numpy or tensors on
any device (what :class:`~evox_tpu_torch.monitors.PopMonitor` and
``EvalMonitor`` histories hold).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.common import host_array


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _as_list(history: Sequence[Any]) -> List[np.ndarray]:
    return [host_array(h) for h in history]


def _animate(fig, update, n_frames: int, interval: int):
    from matplotlib.animation import FuncAnimation

    return FuncAnimation(fig, update, frames=n_frames, interval=interval, blit=False)


def plot_dec_space(
    population_history: Sequence[Any],
    lb: Optional[Any] = None,
    ub: Optional[Any] = None,
    animated: bool = False,
    interval: int = 100,
    **_: Any,
):
    """2-D decision-space scatter over generations (reference
    plot.plot_dec_space)."""
    hist = _as_list(population_history)
    if hist[0].shape[1] != 2:
        raise ValueError("plot_dec_space draws 2-D decision spaces only")
    plt = _mpl()
    fig, ax = plt.subplots()
    sc = ax.scatter(hist[-1][:, 0], hist[-1][:, 1], s=12)
    if lb is not None and ub is not None:
        lb, ub = host_array(lb), host_array(ub)
        ax.set_xlim(lb[0], ub[0])
        ax.set_ylim(lb[1], ub[1])
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    if not animated:
        return fig

    def update(i):
        sc.set_offsets(hist[i])
        ax.set_title(f"generation {i}")
        return (sc,)

    return _animate(fig, update, len(hist), interval)


def plot_obj_space_1d(
    fitness_history: Sequence[Any], animated: bool = False, interval: int = 100, **_: Any
):
    """Single-objective progress: min/mean/max fitness per generation.
    ``animated=True`` grows the curves generation by generation."""
    hist = _as_list(fitness_history)
    plt = _mpl()
    gens = np.arange(len(hist))
    mins = np.array([h.min() for h in hist])
    means = np.array([h.mean() for h in hist])
    maxs = np.array([h.max() for h in hist])
    fig, ax = plt.subplots()
    lines = [
        ax.plot(gens, mins, label="min")[0],
        ax.plot(gens, means, label="mean")[0],
        ax.plot(gens, maxs, label="max")[0],
    ]
    ax.set_xlabel("generation")
    ax.set_ylabel("fitness")
    ax.legend()
    if not animated:
        return fig

    series = (mins, means, maxs)

    def update(i):
        for line, ys in zip(lines, series):
            line.set_data(gens[: i + 1], ys[: i + 1])
        ax.set_title(f"generation {i}")
        return lines

    return _animate(fig, update, len(hist), interval)


def plot_obj_space_2d(
    fitness_history: Sequence[Any],
    problem_pf: Optional[Any] = None,
    animated: bool = False,
    interval: int = 100,
    **_: Any,
):
    """2-objective scatter (optionally against the true Pareto front)."""
    hist = _as_list(fitness_history)
    plt = _mpl()
    fig, ax = plt.subplots()
    if problem_pf is not None:
        pf = host_array(problem_pf)
        ax.scatter(pf[:, 0], pf[:, 1], s=4, c="lightgray", label="true PF")
    sc = ax.scatter(hist[-1][:, 0], hist[-1][:, 1], s=12, label="population")
    ax.set_xlabel("f1")
    ax.set_ylabel("f2")
    ax.legend()
    if not animated:
        return fig

    def update(i):
        sc.set_offsets(hist[i])
        ax.set_title(f"generation {i}")
        return (sc,)

    return _animate(fig, update, len(hist), interval)


def plot_obj_space_3d(
    fitness_history: Sequence[Any],
    problem_pf: Optional[Any] = None,
    animated: bool = False,
    interval: int = 100,
    **_: Any,
):
    """3-objective scatter (optionally against the true Pareto front)."""
    hist = _as_list(fitness_history)
    plt = _mpl()
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    if problem_pf is not None:
        pf = host_array(problem_pf)
        ax.scatter(pf[:, 0], pf[:, 1], pf[:, 2], s=4, c="lightgray", label="true PF")
    last = hist[-1]
    sc = ax.scatter(last[:, 0], last[:, 1], last[:, 2], s=12, label="population")
    ax.set_xlabel("f1")
    ax.set_ylabel("f2")
    ax.set_zlabel("f3")
    ax.legend()
    if not animated:
        return fig

    def update(i):
        sc._offsets3d = (hist[i][:, 0], hist[i][:, 1], hist[i][:, 2])
        ax.set_title(f"generation {i}")
        return (sc,)

    return _animate(fig, update, len(hist), interval)
