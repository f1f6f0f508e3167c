"""Brax as an :class:`EnvSpec` — the port of
``evox_tpu/problems/neuroevolution/control/brax_adapter.py``.

Brax is physics written in JAX, and the port imports no JAX: with brax
installed, :func:`brax_env` raises ``NotImplementedError`` (a standing
limit, ROADMAP). Without it, it raises the JAX package's missing-dependency
``ImportError``.
"""

from __future__ import annotations

import importlib.util
import sys

from .envs import EnvSpec


def _brax_present() -> bool:
    """Whether brax can be imported, found without importing it: brax's
    import loads JAX. A module already in ``sys.modules`` counts."""
    if "brax" in sys.modules:
        return True
    return importlib.util.find_spec("brax") is not None


def brax_env(
    env_name: str,
    backend: str = "generalized",
    max_steps: int = 1000,
    terminate_on_done: bool = True,
) -> EnvSpec:
    """Refuse a brax environment: ImportError without brax, and
    NotImplementedError with it (brax runs on JAX, which the port does not
    import)."""
    if not _brax_present():
        raise ImportError(
            "brax is not installed; use the built-in control envs "
            "(evox_tpu_torch.problems.neuroevolution.control.envs) instead"
        )
    raise NotImplementedError(
        f"brax_env({env_name!r}): brax is physics written in JAX, and evox_tpu_torch imports "
        "no JAX; use the built-in control envs (control.envs) or a host env "
        "(hostenv.HostEnvProblem)"
    )
