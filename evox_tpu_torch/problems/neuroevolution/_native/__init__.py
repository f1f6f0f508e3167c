"""The native vectorized env engine (``vecenv.cpp``) through ``ctypes`` —
the port of ``evox_tpu/problems/neuroevolution/_native/__init__.py``.

Classic-control dynamics batched in C++ behind the :class:`HostVectorEnv`
protocol that :class:`~evox_tpu_torch.problems.neuroevolution.hostenv.
HostEnvProblem` steps. ``vecenv.cpp`` here is the port's own copy of the
JAX package's source, byte for byte. It is compiled with ``g++`` at first
use (never when this module is imported) with the reference's flags, into
``evox_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags; the compiler writes a file of its own and the
finished library is renamed into place, so processes that build at once
race benignly. A failed build raises with the compiler's output;
:func:`native_available` reports whether the engine loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "vecenv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "_build"
# -ffp-contract=off: no FMA contraction, so trajectories match numpy's
# separate multiply and add rounding (the equivalence the tests hold)
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++14", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvecenv-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile ``vecenv.cpp`` unless its library exists; the library path."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++/c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:  # the compiler is not run again each call
            raise RuntimeError(_BUILD_ERROR)
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _BUILD_ERROR = f"native vecenv unavailable: {e}"
            raise RuntimeError(_BUILD_ERROR) from e
        lib.vecenv_create.restype = ctypes.c_void_p
        lib.vecenv_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.vecenv_destroy.restype = None
        lib.vecenv_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.vecenv_obs_dim, lib.vecenv_act_dim, lib.vecenv_state_dim):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        f32 = ctypes.POINTER(ctypes.c_float)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        f64 = ctypes.POINTER(ctypes.c_double)
        lib.vecenv_reset.restype = None
        lib.vecenv_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint64, f32]
        lib.vecenv_step.restype = None
        lib.vecenv_step.argtypes = [ctypes.c_void_p, f32, f32, f32, u8, u8]
        lib.vecenv_get_state.restype = None
        lib.vecenv_get_state.argtypes = [ctypes.c_void_p, f64]
        lib.vecenv_set_state.restype = None
        lib.vecenv_set_state.argtypes = [ctypes.c_void_p, f64]
        _LIB = lib
        return lib


def native_available() -> bool:
    """True if the C++ engine builds (or was built) and loads."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeVectorEnv:
    """The C++ batched classic-control env, a ``HostVectorEnv``.

    One env per individual; an env that terminated or was truncated
    freezes (state held, reward 0) until the next reset, as EnvPool's do.

    Args:
        env_name: ``cartpole`` | ``pendulum`` | ``mountain_car`` | ``acrobot``.
        num_envs: population size.
        max_steps: truncation horizon.
        num_threads: C++ worker threads stepping the batch (1 = inline).
    """

    def __init__(self, env_name: str, num_envs: int, max_steps: int = 500,
                 num_threads: int = 1):
        self._lib = _load()
        self._h = self._lib.vecenv_create(env_name.encode(), num_envs, max_steps, num_threads)
        if not self._h:
            raise ValueError(
                f"unknown env {env_name!r} or invalid sizes "
                f"(num_envs={num_envs}, max_steps={max_steps})"
            )
        self.env_name = env_name
        self.num_envs = num_envs
        self.max_steps = max_steps
        self.num_threads = num_threads
        self.obs_dim = self._lib.vecenv_obs_dim(self._h)
        self.act_dim = self._lib.vecenv_act_dim(self._h)
        self.state_dim = self._lib.vecenv_state_dim(self._h)
        self._obs = np.empty((num_envs, self.obs_dim), dtype=np.float32)
        self._reward = np.empty((num_envs,), dtype=np.float32)
        self._term = np.empty((num_envs,), dtype=np.uint8)
        self._trunc = np.empty((num_envs,), dtype=np.uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vecenv_destroy(h)
            self._h = None

    def reset(self, seed: int) -> np.ndarray:
        self._lib.vecenv_reset(self._h, ctypes.c_uint64(int(seed) & (2**64 - 1)),
                               _ptr(self._obs, ctypes.c_float))
        return self._obs.copy()

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        actions = np.ascontiguousarray(actions, dtype=np.float32)
        if actions.shape != (self.num_envs, self.act_dim):
            raise ValueError(f"actions shape {actions.shape} != {(self.num_envs, self.act_dim)}")
        self._lib.vecenv_step(
            self._h, _ptr(actions, ctypes.c_float), _ptr(self._obs, ctypes.c_float),
            _ptr(self._reward, ctypes.c_float), _ptr(self._term, ctypes.c_uint8),
            _ptr(self._trunc, ctypes.c_uint8),
        )
        return self._obs.copy(), self._reward.copy(), self._term.astype(bool), \
            self._trunc.astype(bool)

    def get_state(self) -> np.ndarray:
        """Every env's float64 state, ``(num_envs, state_dim)``."""
        out = np.empty((self.num_envs, self.state_dim), dtype=np.float64)
        self._lib.vecenv_get_state(self._h, _ptr(out, ctypes.c_double))
        return out

    def set_state(self, state: np.ndarray) -> None:
        """Overwrite every env's state; clears the done flags and the step
        counter."""
        state = np.ascontiguousarray(state, dtype=np.float64)
        if state.shape != (self.num_envs, self.state_dim):
            raise ValueError(f"state shape {state.shape} != {(self.num_envs, self.state_dim)}")
        self._lib.vecenv_set_state(self._h, _ptr(state, ctypes.c_double))
