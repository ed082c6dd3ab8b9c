"""The texel-recovery cells (entry ``grad_texels``) at their CPU-test size:
each planted fault makes the run incorrect, the swapped-axes one through
``texel_grad_gap`` alone; a traced run reports the texture's metrics and
an untraced one none; the entry and its reference import no JAX (the
reference not the port either)."""
import contextlib
import json
import subprocess
import sys

import pytest
import torch

import mitransient_tpu_torch as mt
from harness import spec
from test_portbench_run import (
    _faulty,
    _half_backward,
    _render_fault,
    _run,
    cells_of,
)

CELLS = cells_of("grad_texels")
TEXTURE_METRICS = {"texture_share.grad", "textured_lanes.grad"}


def _swapped_backward(cell):
    """The texel gradient handed on with its u and v axes swapped: the
    same norm, loss and film, the gradient on the wrong texels."""
    path = spec.load_cell(cell).traffic["parameter"]

    def render_backward(scene, grad_in, **kw):
        grads = mt.render_backward(scene, grad_in, **kw)
        grads[path] = grads[path].transpose(0, 1).contiguous()
        return grads
    return render_backward


# the planted faults, the one table of them: this test reads them at the
# CPU-test size, ``scripts/torch_texel_faults.py`` at the cell's own
FAULTS = ("unchanged", "half", "altered", "swapped")


@contextlib.contextmanager
def planted(kind, cell):
    """The program with the fault ``kind`` planted: ``unchanged`` Adam's
    step a no-op, ``half`` the backward at half the spp, ``altered`` the
    centre pixel's transient x 10, ``swapped`` the texel gradient with its
    u and v axes swapped."""
    step = torch.optim.Adam.step
    if kind == "unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield {"unchanged": lambda: mt,
               "half": lambda: _faulty(render_backward=_half_backward),
               "altered": lambda: _faulty(render=_render_fault("altered")),
               "swapped": lambda: _faulty(
                   render_backward=_swapped_backward(cell))}[kind]()
    finally:
        torch.optim.Adam.step = step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", FAULTS)
def test_texel_faults_are_caught(cell, kind):
    with planted(kind, cell) as program:
        res = _run(cell, program=program)
    assert res["correct"] is False
    if kind == "swapped":
        c = res["compared"]
        assert c["texel_grad_gap"]["value"] > c["texel_grad_gap"]["limit"]
        for name in ("loss_gap", "film_rel_l1", "grad_norm_gap"):
            assert c[name]["value"] <= c[name]["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_texture_metrics_traced_only(cell):
    names = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert TEXTURE_METRICS <= names
    traced = _run(cell, trace=True)["metrics"]
    for name in TEXTURE_METRICS:
        assert 0.0 < traced[name]["value"] < 100.0, name
    assert not TEXTURE_METRICS & set(_run(cell)["metrics"])


def test_entry_and_reference_import_no_jax():
    code = ("import json, sys; sys.path[:0] = ['portbench', '.']; "
            "top = lambda: sorted({m.split('.')[0] for m in sys.modules}); "
            "import reference.textured; ref = top(); "
            "import entries.grad_texels; print(json.dumps([ref, top()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(spec.ROOT), check=True).stdout
    ref, entry = (set(names) for names in json.loads(out))
    jax = {"jax", "jaxlib", "flax", "mitransient_tpu"}
    assert "reference" in ref and "entries" in entry
    assert not ref & (jax | {"mitransient_tpu_torch"})
    assert not entry & jax
