"""Build the port's CUDA sources at first use.

Each source under ``evox_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``. Libraries go to ``evox_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one loads at once. Nothing is compiled
when a module is imported: the first kernel launch builds, or
:func:`build` builds every source in parallel ahead of time.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from the
toolkit's default prefix ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES: Dict[str, Path] = {
    name: CSRC / f"{name}.cu"
    for name in ("rollout", "rollout_mlp", "dominance", "topk", "digest", "smallmm")
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: every multiply and add rounds on its own, as the
    # plain PyTorch version's separate operations do, so kernel and plain
    # version agree bit for bit (csrc/rollout.cu, "Numerics")
    "-fmad=false",
    # registers, spills and shared memory of each kernel, kept in the log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built on the machine with the card"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> Optional[str]:
    """nvcc's output (ptxas register and spill report) for the built library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together; return ``name -> library path``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, so)
    errors = []
    for name, (proc, tmp, so) in running.items():
        output, _ = proc.communicate()
        so.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{SOURCES[name].name}: nvcc exited {proc.returncode}\n{output}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if missing)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence[Any], restype: Any = ctypes.c_int) -> Any:
    """``symbol`` of the library built from ``csrc/<name>.cu``, with its C
    signature declared (pointers and the stream as ``c_void_p``)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return fn


def check_launch(name: str, err: int, what: str) -> None:
    """Raise when a C entry point of ``csrc/<name>.cu`` returned a CUDA
    error instead of 0."""
    if err != 0:
        text = function(name, "evox_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)(err)
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({text.decode()})")
