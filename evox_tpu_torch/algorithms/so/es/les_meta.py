"""LES's bundled meta-trained parameters — the part of
``evox_tpu/algorithms/so/es/les_meta.py`` that LES needs to load them.

``data/les_params.npz`` (this package's own copy of the JAX package's file)
holds the 214 floats of the two networks as one flat vector, in
``jax.flatten_util.ravel_pytree``'s order of the flax parameter tree:
dict keys sorted (``lr`` before ``weights``, ``Dense_0`` before
``Dense_1``, ``bias`` before ``kernel``), each leaf row-major. A flax
``Dense`` kernel is ``(in, out)``, applied as ``x @ kernel + bias``.

The meta-training (``sample_task``, ``task_eval``, ``les_score``,
``meta_train``) is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ....core.device import DeviceLike, resolve_device

PARAMS_PATH = Path(__file__).parent / "data" / "les_params.npz"

# the networks' layers in ravel order: (network, layer, in, out)
LAYERS = (
    ("lr", "Dense_0", 6, 16),
    ("lr", "Dense_1", 16, 2),
    ("weights", "Dense_0", 3, 8),
    ("weights", "Dense_1", 3, 8),
    ("weights", "Dense_2", 3, 1),
)
N_PARAMS = sum(fan_out + fan_in * fan_out for _, _, fan_in, fan_out in LAYERS)  # 214

Params = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def unravel(flat: np.ndarray, device: torch.device) -> Params:
    """The parameter dict ``{network: {layer: {"bias", "kernel"}}}`` from
    the flat vector, in ravel order."""
    flat = np.asarray(flat, dtype=np.float32)
    if flat.shape != (N_PARAMS,):
        raise ValueError(f"expected {N_PARAMS} LES parameters, got shape {flat.shape}")
    params: Params = {}
    at = 0
    for net, layer, fan_in, fan_out in LAYERS:
        bias = flat[at : at + fan_out]
        at += fan_out
        kernel = flat[at : at + fan_in * fan_out].reshape(fan_in, fan_out)
        at += fan_in * fan_out
        params.setdefault(net, {})[layer] = {
            "bias": torch.from_numpy(bias.copy()).to(device),
            "kernel": torch.from_numpy(kernel.copy()).to(device),
        }
    return params


def load_params(path: Path = PARAMS_PATH, device: DeviceLike = None) -> Optional[Params]:
    """The bundled parameters on ``device`` (``None`` means ``"cuda"``), or
    ``None`` when there is no file or it holds another number of floats."""
    dev = resolve_device(device)
    if not Path(path).exists():
        return None
    flat = np.load(path)["flat"]
    if flat.shape != (N_PARAMS,):  # the architecture drifted past the file
        return None
    return unravel(flat, dev)
