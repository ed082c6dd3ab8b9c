"""The PyTorch port imports neither jax nor the JAX package."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import mitransient_tpu_torch as mt
for info in pkgutil.walk_packages(mt.__path__, "mitransient_tpu_torch."):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "mitransient_tpu."))
             or m == "mitransient_tpu")
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax():
    """Every module of the port, imported in a fresh process, leaves jax
    and mitransient_tpu out of sys.modules."""
    res = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_public_api():
    import mitransient_tpu_torch as mt

    for name in ("load_dict", "cornell_box", "render", "set_variant",
                 "variant"):
        assert callable(getattr(mt, name)), name


def test_kernel_loader_needs_nvcc(monkeypatch):
    """Without a CUDA toolkit the loader raises; it never falls back."""
    from mitransient_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_kernel_library_name_tracks_sources():
    """The built library's name hashes the sources and flags, so an edited
    kernel is rebuilt rather than a stale library loaded."""
    from mitransient_tpu_torch.kernels import _build

    names = sorted(p.name for p in _build.sources())
    assert names == ["intersect.cu", "splat.cu"]
    p1 = _build.library_path()
    assert p1 == _build.library_path()
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
