"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, then loaded with ``ctypes``: a
source without PyTorch's headers builds in seconds.  The wrappers check the
tensors' device, dtype, shape and contiguity before they pass pointers, and
launch with the tensors' device current.  The library goes into ``.torch_ext/`` at the repository root (ignored by git),
named by a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing is built or loaded at import: the first
kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported function: argument types, int result
SIGNATURES = {
    "lstm_fwd": {
        "lstm_fwd_layer": [_P] * 9 + [_I] * 4 + [_P],
        "lstm_fwd_stack": [_P] * 10 + [_I] * 5 + [_P],
    },
    "lstm_bwd": {
        "lstm_bwd_layer": [_P] * 10 + [_I] * 4 + [_P],
        "lstm_bwd_stack": [_P] * 11 + [_I] * 5 + [_P],
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # nvcc's output (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    build_log[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = _I
            _loaded[name] = lib
    return lib


def check(err: int, fn: str) -> None:
    """Raise if a C entry point reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
