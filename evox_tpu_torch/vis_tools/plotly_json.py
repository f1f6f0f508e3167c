"""Plotly-compatible figure JSON with no plotly dependency — the port of
``evox_tpu/vis_tools/plotly_json.py``, with the same output.

A plotly figure is JSON, so these functions build the structure of the
reference's plotly animations (frames, a generation slider, play and pause
buttons) as plain dicts:

- load them wherever plotly exists: ``plotly.io.from_json(json.dumps(d))``;
- or render standalone: :func:`save_html` writes a self-contained page
  that pulls plotly.js from its CDN.

The four entry points: ``plot_dec_space``, ``plot_obj_space_1d`` (min,
max, median and mean curves), ``plot_obj_space_2d`` and
``plot_obj_space_3d`` (a scatter a generation). Each takes a history list
(numpy arrays, or tensors on any device) and returns ``{"data": ...,
"layout": ..., "frames": ...}``.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Sequence

import numpy as np

from ..utils.common import host_array


def _hist(history: Sequence[Any]) -> List[np.ndarray]:
    return [host_array(h) for h in history]


def _padded_range(lo: float, hi: float, pad: float = 0.1):
    r = hi - lo
    return [float(lo - pad * r), float(hi + pad * r)]


def _slider_steps(n: int):
    return [
        {
            "label": i,
            "method": "animate",
            "args": [
                [str(i)],
                {
                    "frame": {"duration": 200, "redraw": True},
                    "mode": "immediate",
                    "transition": {"duration": 200},
                },
            ],
        }
        for i in range(n)
    ]


def _animation_layout(n_frames: int) -> dict:
    """Generation slider + play/pause buttons (the reference's controls)."""
    return {
        "sliders": [
            {
                "currentvalue": {"prefix": "Generation: "},
                "pad": {"b": 1, "t": 10},
                "len": 0.8,
                "x": 0.2,
                "y": 0,
                "yanchor": "top",
                "xanchor": "left",
                "steps": _slider_steps(n_frames),
            }
        ],
        "updatemenus": [
            {
                "type": "buttons",
                "x": 0.2,
                "xanchor": "right",
                "y": 0,
                "yanchor": "top",
                "direction": "left",
                "pad": {"r": 10, "t": 30},
                "buttons": [
                    {
                        "label": "Play",
                        "method": "animate",
                        "args": [
                            None,
                            {
                                "frame": {"duration": 200, "redraw": True},
                                "fromcurrent": True,
                                "mode": "immediate",
                                "transition": {"duration": 200, "easing": "linear"},
                            },
                        ],
                    },
                    {
                        "label": "Pause",
                        "method": "animate",
                        "args": [
                            [None],
                            {
                                "frame": {"duration": 0, "redraw": True},
                                "mode": "immediate",
                                "transition": {"duration": 0},
                            },
                        ],
                    },
                ],
            }
        ],
        "legend": {"x": 1, "y": 1, "xanchor": "auto"},
        "margin": {"l": 0, "r": 0, "t": 0, "b": 0},
    }


def _scatter(x, y, z=None, mode="markers", name=None, **extra) -> dict:
    d = {
        "type": "scatter3d" if z is not None else "scatter",
        "mode": mode,
        "x": np.asarray(x).tolist(),
        "y": np.asarray(y).tolist(),
    }
    if z is not None:
        d["z"] = np.asarray(z).tolist()
    if name is not None:
        d["name"] = name
    d.update(extra)
    return d


def plot_dec_space(population_history: Sequence[Any], **layout_kw) -> dict:
    """Animated 2-D decision-space scatter (reference plot.py:6-139)."""
    hist = _hist(population_history)
    allp = np.concatenate(hist, axis=0)
    frames = [
        {
            "name": str(i),
            "data": [_scatter(pop[:, 0], pop[:, 1], marker={"color": "#636EFA"})],
        }
        for i, pop in enumerate(hist)
    ]
    layout = _animation_layout(len(hist))
    layout["xaxis"] = {"range": _padded_range(allp[:, 0].min(), allp[:, 0].max())}
    layout["yaxis"] = {"range": _padded_range(allp[:, 1].min(), allp[:, 1].max())}
    layout.update(layout_kw)
    return {"data": frames[0]["data"], "layout": layout, "frames": frames}


def plot_obj_space_1d(
    fitness_history: Sequence[Any], animation: bool = True, **layout_kw
) -> dict:
    """Min/max/median/mean fitness curves over generations (reference
    plot.py:141-318); ``animation=True`` reveals them generation by
    generation with the slider."""
    hist = _hist(fitness_history)
    gen = list(range(len(hist)))
    series = {
        "Min": [float(np.min(f)) for f in hist],
        "Max": [float(np.max(f)) for f in hist],
        "Median": [float(np.median(f)) for f in hist],
        "Average": [float(np.mean(f)) for f in hist],
    }
    full = [
        _scatter(gen, v, mode="lines", name=k) for k, v in series.items()
    ]
    base_layout = {
        "legend": {"x": 1, "y": 1, "xanchor": "auto"},
        "margin": {"l": 0, "r": 0, "t": 0, "b": 0},
    }
    if not animation:
        base_layout.update(layout_kw)
        return {"data": full, "layout": base_layout}
    frames = [
        {
            "name": str(i),
            "data": [
                _scatter(gen[: i + 1], v[: i + 1], mode="lines", name=k)
                for k, v in series.items()
            ],
        }
        for i in gen
    ]
    layout = _animation_layout(len(hist))
    layout["xaxis"] = {"range": [0, max(len(hist) - 1, 1)]}
    lo = min(min(v) for v in series.values())
    hi = max(max(v) for v in series.values())
    layout["yaxis"] = {"range": _padded_range(lo, hi)}
    layout.update(layout_kw)
    return {"data": frames[0]["data"], "layout": layout, "frames": frames}


def _obj_scatter_nd(
    fitness_history: Sequence[Any],
    problem_pf: Optional[Any],
    sort_points: bool,
    dims: int,
    **layout_kw,
) -> dict:
    hist = _hist(fitness_history)
    if sort_points:
        hist = [f[np.lexsort(f.T[::-1])] for f in hist]
    pf_traces = []
    if problem_pf is not None:
        pf = host_array(problem_pf)
        pf_traces.append(
            _scatter(
                *(pf[:, k] for k in range(dims)),
                name="Pareto Front",
                marker={"color": "#FFA15A", "size": 2 if dims == 3 else 4},
            )
        )
    frames = [
        {
            "name": str(i),
            "data": pf_traces
            + [
                _scatter(
                    *(f[:, k] for k in range(dims)),
                    name="Population",
                    marker={"color": "#636EFA", "size": 2 if dims == 3 else 4},
                )
            ],
        }
        for i, f in enumerate(hist)
    ]
    layout = _animation_layout(len(hist))
    allf = np.concatenate(hist, axis=0)
    axes = ["xaxis", "yaxis", "zaxis"][:dims]
    ranges = {
        ax: {"range": _padded_range(allf[:, k].min(), allf[:, k].max())}
        for k, ax in enumerate(axes)
    }
    if dims == 3:
        layout["scene"] = ranges
    else:
        layout.update(ranges)
    layout.update(layout_kw)
    return {"data": frames[0]["data"], "layout": layout, "frames": frames}


def plot_obj_space_2d(
    fitness_history: Sequence[Any],
    problem_pf: Optional[Any] = None,
    sort_points: bool = False,
    **layout_kw,
) -> dict:
    """Animated 2-objective scatter + optional true front (ref :320-451)."""
    return _obj_scatter_nd(fitness_history, problem_pf, sort_points, 2, **layout_kw)


def plot_obj_space_3d(
    fitness_history: Sequence[Any],
    problem_pf: Optional[Any] = None,
    sort_points: bool = False,
    **layout_kw,
) -> dict:
    """Animated 3-objective scatter + optional true front (ref :453+)."""
    return _obj_scatter_nd(fitness_history, problem_pf, sort_points, 3, **layout_kw)


def to_json(fig: dict) -> str:
    """Serialize a figure dict; ``plotly.io.from_json``-compatible."""
    return json.dumps(fig)


def _script_safe(obj: Any) -> str:
    """JSON for embedding inside a <script> element: '</' must not appear
    literally or a '</script>' inside any user string would terminate the
    element early (same guard plotly.io.to_html applies)."""
    return json.dumps(obj).replace("</", "<\\/")


def save_html(fig: dict, path: str, title: str = "evox_tpu_torch") -> None:
    """Standalone HTML page rendering the figure with plotly.js from the
    CDN — viewable in any browser, no Python plotly required."""
    import html as _html

    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script></head>
<body><div id="fig" style="width:100%;height:95vh;"></div>
<script>
Plotly.newPlot("fig", {_script_safe(fig["data"])}, {_script_safe(fig["layout"])})
  .then(function(gd) {{ Plotly.addFrames(gd, {_script_safe(fig.get("frames", []))}); }});
</script></body></html>
"""
    with open(path, "w") as f:
        f.write(html)
