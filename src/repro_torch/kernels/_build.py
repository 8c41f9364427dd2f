"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exports plain C functions.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at the repo
root (the hash is of the source and the flags, so an edited source never
loads a stale library) and loaded with ``ctypes``.  Nothing is built when
the package is imported: ``load`` builds at a kernel's first launch, and
``build_all`` builds every source at once, one ``nvcc`` each, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]
# Per-source flags.  sparse_dot's scores must round every product and
# sum as the plain PyTorch version does, so no mul+add is contracted.
EXTRA_FLAGS = {"fused_encode": [], "sparse_dot": ["-fmad=false"]}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS[name]


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    """Start one nvcc into a private temp file; ``_finish`` renames it."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name, proc, tmp, target) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict[str, str]:
    """Build every source that has no current library, all nvcc processes
    at once.  Returns each built source's compiler output (register and
    shared-memory use per kernel)."""
    started = {n: _start(n) for n in EXTRA_FLAGS if not _target(n).exists()}
    return {n: _finish(n, *job) for n, job in started.items()}


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.
    ``argtypes`` maps each exported launch function to its ctypes
    argument types (``c_void_p`` for every pointer and the stream, else a
    pointer would be cut to a 32-bit int); each returns a CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(target))
            for fn, types in argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise if the launch function of ``csrc/<name>.cu`` returned a CUDA
    error code (a refused launch never runs, and a later synchronize
    would not report it)."""
    if status != 0:
        text = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")


def check_tensor(name: str, t, dtype, ndim: int, device=None) -> None:
    """A kernel argument must be a contiguous CUDA tensor of ``dtype``
    and rank ``ndim`` (on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}; the plain version serves CPU tensors")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
