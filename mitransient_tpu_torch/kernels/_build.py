"""Build, load and count the port's CUDA kernels.

The sources under ``mitransient_tpu_torch/csrc/`` are compiled by ``nvcc``
into one shared library with a plain C interface, at first use, into
``build/`` at the root of the checkout, and bound with ``ctypes``.  The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt.  Nothing here runs at import time.

Flags: ``--fmad=false`` keeps ``a*b + c`` as two rounded operations, the
arithmetic of the plain PyTorch versions; ``-prec-div`` stays at its IEEE
default, and ``--use_fast_math`` is never used.

Wrappers that launch a kernel call :func:`count_launch` once per launch;
``chip_smoke.py`` reads the counts to show that a run went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/*.cu: name -> argtypes (all return int cudaError_t)
_SIGNATURES = {
    "mitr_closest_hit": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P),
    "mitr_ray_test": (_P, _I, _P, _P, _P, _P, _I, _P, _P),
    "mitr_splat_accumulate": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register / shared-memory report)


_lib: ctypes.CDLL | None = None
_build_info: BuildInfo | None = None
_launches: dict[str, int] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmitr_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile the kernels unless this exact library exists already."""
    global _build_info
    if _build_info is not None:
        return _build_info
    path = library_path()
    if path.exists():
        _build_info = BuildInfo(path, 0.0, "")
        return _build_info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    _build_info = BuildInfo(path, seconds, res.stdout + res.stderr)
    return _build_info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mitr_error_string.argtypes = (ctypes.c_int,)
        lib.mitr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().mitr_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({err})")


def count_launch(kernel: str) -> None:
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def require(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Check one kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def stream_of(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
