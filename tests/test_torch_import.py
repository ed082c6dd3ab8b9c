"""The PyTorch port imports neither jax nor the JAX package."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, os, pkgutil, sys, tempfile
sys.path[:0] = [{repo!r}, os.path.join({repo!r}, "tests")]
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.io_exr import read_exr, write_exr
import torch_cases
for info in pkgutil.walk_packages(mt.__path__, "mitransient_tpu_torch."):
    importlib.import_module(info.name)
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "scene.xml")
    with open(path, "w") as f:
        f.write({xml!r})
    mt.load_file(path, device="cpu")
    mt.set_variant("mono_polarized")
    scene = mt.load_file(path, device="cpu")
    steady, _transient = mt.render(scene, spp=2, seed=0)
    assert steady.shape[-1] == 4
    mt.vis_polarized.polarization_generate_false_color(steady.numpy(), "aolp")
    nlos = mt.load_dict(torch_cases.nlos_scene(sx=2, sy=2, bins=40),
                        device="cpu")
    mt.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], nlos)
    _steady, transient = mt.render(nlos, spp=2, seed=0)
    assert transient.shape == (2, 2, 40, 4)
    write_exr(os.path.join(td, "f.exr"), transient[:, :, 0, :3].numpy())
    assert read_exr(os.path.join(td, "f.exr"))[1] == ["B", "G", "R"]
    mt.set_variant("rgb")
    from mitransient_tpu_torch.parallel import make_mesh, render_sharded
    box = mt.cornell_box()
    box["sensor"]["film"].update(width=4, height=4, temporal_bins=8)
    steady, _transient = render_sharded(mt.load_dict(box, device="cpu"),
                                        make_mesh(devices=["cpu"] * 2), spp=2)
    assert steady.shape == (4, 4, 3)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "mitransient_tpu."))
             or m == "mitransient_tpu")
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


# a rough gold box on a checkered floor, seen by a perspective sensor
_XML = """<scene version="3.0.0">
    <sensor type="perspective"><film type="transient_hdr_film">
        <integer name="width" value="4"/><integer name="height" value="4"/>
    </film></sensor>
    <shape type="rectangle" id="floor"><bsdf type="diffuse">
        <texture type="checkerboard" name="reflectance"/>
    </bsdf></shape>
    <shape type="cube" id="box"><bsdf type="roughconductor">
        <string name="material" value="Au"/>
    </bsdf></shape>
</scene>
"""


def test_port_imports_without_jax():
    """Every module of the port, imported in a fresh process, a scene
    loaded from an XML file, its render under the mono_polarized variant
    with a false-color map, a polarized NLOS capture, an EXR frame of
    it written and read back by ``io_exr`` and a sharded render on 2 CPU
    shards leave jax and mitransient_tpu out of sys.modules."""
    res = subprocess.run([sys.executable, "-c",
                          _PROBE.format(repo=REPO, xml=_XML)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_public_api():
    import mitransient_tpu_torch as mt

    for name in ("load_dict", "load_file", "cornell_box", "render",
                 "set_variant",
                 "variant", "save_film_state", "load_film_state",
                 "render_aovs", "render_backward", "render_forward",
                 "traverse", "is_monochromatic", "is_polarized", "is_rgb",
                 "log", "set_log_level"):
        assert callable(getattr(mt, name)), name
    assert isinstance(mt.__version__, str)
    for name in ("tonemap_transient", "tonemap_grad_transient",
                 "save_frames", "save_video", "show_video",
                 "rainbow_visualization"):
        assert callable(getattr(mt.vis, name)), name
    for name in ("degree_of_polarization", "tonemap_transient",
                 "polarization_generate_false_color",
                 "show_video_polarized"):
        assert callable(getattr(mt.vis_polarized, name)), name
    from mitransient_tpu_torch import parallel

    for name in ("make_mesh", "render_sharded",
                 "render_nlos_exhaustive_sharded", "render_backward_sharded",
                 "init_distributed", "global_mesh", "replicate", "fetch",
                 "process_index", "process_count", "dryrun_multichip"):
        assert callable(getattr(parallel, name)), name
    for name in ("focus_emitter_at_relay_wall_3dpoint",
                 "focus_emitter_at_relay_wall_uv",
                 "focus_emitter_at_relay_wall_pixel", "scan_confocal"):
        assert callable(getattr(mt.nlos, name)), name


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
    assert names == ["bvh.cu", "gather.cu", "intersect.cu", "splat.cu"]
    p1 = _build.library_path()
    assert p1 == _build.library_path()
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
