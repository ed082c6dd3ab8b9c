"""Build, load and count the port's CUDA kernels.

The sources under ``mitransient_tpu_torch/csrc/`` are compiled by ``nvcc``
at first use, one process per source started together, then linked into one
shared library with a plain C interface in ``build/`` at the root of the
checkout, and bound with ``ctypes``.  The library's file name carries a
hash of the sources and flags, so an edited source is rebuilt.  Nothing
here runs at import time.

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
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

# the dynamic shared memory a block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232448

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points of csrc/*.cu: name -> argtypes (all return int cudaError_t)
_SIGNATURES = {
    "mitr_closest_hit": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P),
    "mitr_ray_test": (_P, _I, _P, _P, _P, _P, _I, _P, _P),
    "mitr_splat_accumulate": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "mitr_reduce_rows_tiles": (_P, _P, _L, _I, _I, _P, _P, _P, _P),
    "mitr_reduce_rows_runs": (_P, _P, _I, _L, _P, _I, _P, _P),
    "mitr_bvh_query": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
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
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    log = []

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(job, others=()):
        cmd, proc = job
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            for _, other in others:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources()]
        jobs = [start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
                for src, obj in zip(sources(), objs)]
        for job in jobs:
            finish(job, jobs)
        tmp = os.path.join(tmpdir, path.name)
        finish(start([nvcc, *GENCODE, "-shared", "-o", tmp, *objs]))
        os.replace(tmp, path)
    _build_info = BuildInfo(path, time.perf_counter() - t0, "".join(log))
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
