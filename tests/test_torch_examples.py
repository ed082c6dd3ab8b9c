"""Every example script of the PyTorch port (``examples/torch/``) runs end
to end in ``--quick`` mode on the CPU (``--device cpu``), in-process as
tests/test_examples.py runs the JAX package's."""
import os
import runpy
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")

SCRIPTS = [
    "transient/render_cbox_diffuse.py",
    "transient/render_cbox_volumetric.py",
    "transient/frequency_space_rendering.py",
    "transient/rainbow_visualization.py",
    "transient_nlos/simple_nlos_scenes.py",
    "polarization/render_cbox_polarized.py",
    "polarization/transient_nlos_polarization.py",
    "diff_transient/optimize_reflectance.py",
    "diff_transient/optimize_staircase_texture.py",
    "diff_transient/forward_time_gradients.py",
    "angulararea_emitter/render_angular_vs_area.py",
]


def _run(rel, tmp_path, monkeypatch, *extra):
    torch.set_num_threads(2)
    path = os.path.join(EXAMPLES, rel)
    monkeypatch.setattr(sys, "argv", [path, "--quick", "--device", "cpu",
                                      "--out", str(tmp_path), *extra])
    monkeypatch.chdir(REPO)
    runpy.run_path(path, run_name="__main__")


@pytest.mark.parametrize("rel", SCRIPTS, ids=[s.split("/")[-1][:-3]
                                              for s in SCRIPTS])
def test_torch_example_quick(rel, tmp_path, monkeypatch):
    _run(rel, tmp_path, monkeypatch)


def test_torch_complex_nlos_quick(tmp_path, monkeypatch):
    """The reference's Z room, where its example corpus is there
    (``MITR_REFERENCE_EXAMPLES``), as tests/test_examples.py skips without
    it."""
    root = os.environ.get("MITR_REFERENCE_EXAMPLES", "")
    if not os.path.exists(os.path.join(root, "transient-nlos",
                                       "nlos-z-room.xml")):
        pytest.skip("the reference's example corpus is not there")
    _run("transient_nlos/complex_nlos_scenes.py", tmp_path, monkeypatch,
         "--spp", "8")
