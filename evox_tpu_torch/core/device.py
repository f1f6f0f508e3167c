"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.

    Raises when CUDA is asked for, explicitly or by default, and is not
    available: nothing in the port goes on quietly on the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch paths there (as the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available, and evox_tpu_torch runs on the GPU unless "
            "asked otherwise; pass device='cpu' to run the plain PyTorch "
            "paths on the CPU"
        )
    return dev


def same_device(tensor: torch.Tensor, device: torch.device) -> bool:
    """True when ``tensor`` lies on ``device`` (an index-less ``cuda``
    matches any card)."""
    return tensor.device.type == device.type and (
        device.index is None or tensor.device.index == device.index
    )


def check_device(tensor: torch.Tensor, device: torch.device, name: str) -> None:
    if not same_device(tensor, device):
        raise ValueError(f"{name} lies on {tensor.device}, expected {device}")
