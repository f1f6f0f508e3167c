"""Visualisation helpers — the port of ``evox_tpu/vis_tools``: matplotlib
figures (``plot``, matplotlib imported lazily) and plotly figure JSON
(``plotly_json``, numpy and json only)."""

from . import plot, plotly_json
from .plot import (
    plot_dec_space,
    plot_obj_space_1d,
    plot_obj_space_2d,
    plot_obj_space_3d,
)

__all__ = [
    "plot",
    "plotly_json",
    "plot_dec_space",
    "plot_obj_space_1d",
    "plot_obj_space_2d",
    "plot_obj_space_3d",
]
