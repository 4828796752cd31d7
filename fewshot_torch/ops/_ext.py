"""Build and load the port's CUDA kernels; what their wrappers share.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, then loaded with ``ctypes``: a
source without PyTorch's headers builds in seconds.  The wrappers check the
tensors' device, dtype, shape and contiguity before they pass pointers, and
launch with the tensors' device current (the helpers below).  The library
goes into ``.torch_ext/`` at the repository root (ignored by git), named by
a hash of its source, the ``csrc/`` headers it includes and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.  Nothing is built or loaded at import: the first
kernel launch builds.  ``build`` also takes another compiler, flags and
source directory: ``data/native.py`` builds the C++ data tier with g++
through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: argument types, int result
SIGNATURES = {
    "lstm_fwd": {
        "lstm_fwd_layer": [_P] * 9 + [_I] * 5 + [_P],
        "lstm_fwd_persist": [_P] * 12 + [_I] * 5 + [_P],
        "lstm_persist_ok": [_I] * 3,
        "lstm_fwd_persist_clusters": [_I],
        "lstm_fwd_stack": [_P] * 10 + [_I] * 5 + [_P],
        "lstm_stack_persist_ok": [_I] * 4,
        "lstm_fwd_stack_persist_tiles": [_I] * 2,
        "lstm_fwd_stack_persist": [_P] * 15 + [_I] * 7 + [_P],
    },
    "lstm_bwd": {
        "lstm_bwd_layer": [_P] * 10 + [_I] * 5 + [_P],
        "lstm_bwd_persist": [_P] * 13 + [_I] * 5 + [_P],
        "lstm_bwd_persist_clusters": [_I],
        "lstm_bwd_stack": [_P] * 11 + [_I] * 5 + [_P],
        "lstm_bwd_stack_persist_tiles": [_I] * 2,
        "lstm_bwd_stack_persist": [_P] * 16 + [_I] * 7 + [_P],
    },
    "head_ce": {
        "head_ce_fwd": [_P] * 6 + [_I] * 4 + [_P],
        "head_ce_fwd_split": [_P] * 6 + [_I] * 4 + [_P],
        "head_ce_fwd_splits": [_I] * 3,
        "head_ce_bwd": [_P] * 10 + [_I] * 5 + [_P],
    },
    "prefix_attn": {
        "prefix_attn_fwd": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
        "prefix_attn_bwd_dq": [_P] * 11 + [_I] * 6 + [_F, _I, _P],
        "prefix_attn_bwd_dkv": [_P] * 14 + [_I] * 6 + [_F, _I, _P],
    },
    "decode_attn": {
        "decode_attn": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
        "decode_attn_smem": [_I] * 3,
    },
}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype arg
SMEM_BYTES = 227 * 1024        # shared memory one block may use (H100)

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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str, csrc: Path = CSRC, suffix: str = ".cu") -> list[Path]:
    """csrc/<name><suffix> and every header it includes by a quoted path,
    directly or through another header, in the order first reached."""
    found: list[Path] = []
    todo = [csrc / f"{name}{suffix}"]
    while todo:
        f = todo.pop(0)
        if f in found:
            continue
        found.append(f)
        todo += [f.parent / inc for inc in _INCLUDE.findall(f.read_text())]
    return found


def library_path(name: str, csrc: Path = CSRC, flags=NVCC_FLAGS,
                 suffix: str = ".cu") -> Path:
    """Where the library of csrc/<name><suffix> goes: named by a hash of
    its sources' bytes and the compiler flags."""
    h = hashlib.sha256()
    for f in sources(name, csrc, suffix):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, csrc: Path = CSRC, compiler=None, flags=NVCC_FLAGS,
          suffix: str = ".cu") -> Path:
    """Compile csrc/<name><suffix> (nvcc unless `compiler` names another)
    unless a library of the same hash exists; the compiler's output is
    kept beside the library (<library>.log)."""
    src = csrc / f"{name}{suffix}"
    out = library_path(name, csrc, flags, suffix)
    log = out.with_name(out.name + ".log")
    if out.exists():
        if log.exists():
            build_log[name] = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cc = compiler or _nvcc()
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed on {src.name}:\n"
                           f"{proc.stderr}")
    build_log[name] = proc.stdout + proc.stderr
    log.write_text(build_log[name])
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


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def stream(x: torch.Tensor) -> int:
    """The handle of x's device's current stream, the launches' last
    argument."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_tensors(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one device, 16-byte aligned
    (they stage 16-byte pieces)."""
    for x in tensors:
        if x.device != tensors[0].device or not x.is_contiguous():
            raise ValueError("inputs must be contiguous, on one device")
        if x.data_ptr() % 16:
            raise ValueError("inputs must be 16-byte aligned")


def contiguous_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of x (any strides) in dtype, in one pass."""
    return torch.empty(x.shape, dtype=dtype, device=x.device).copy_(x)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd will ask for a backward through a kernel."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)
