"""Whole runs of the harness on the CPU at each cell's tiny size,
``tests/tiny/<cell>.json`` (the card's look skipped): the last line's
schema, ``correct`` true on the program, false on the bfloat16 control
and with the timed path broken underneath, no result without a card,
and no module of JAX or the JAX package loaded."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import mitransient_tpu_torch as mt
import run
from harness import spec

SEED = 2**31 + 4242
TINY_DIR = Path(__file__).resolve().parent / "tiny"
# the manifest's cells that have a CPU-test size; test_portbench_spec
# asks one of every cell, so a cell without it fails there, by name
CELLS = [w["name"] for w in spec.load_json(
    spec.ROOT / "BENCHMARK.json")["workloads"]
    if (TINY_DIR / f"{w['name']}.json").is_file()]


def tiny(cell):
    """The cell's CPU-test size, ``tests/tiny/<cell>.json``: the film,
    traffic and focus-pixel overrides that ``run_cell`` takes as
    ``shrink``."""
    path = TINY_DIR / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"cell {cell!r} has no CPU-test size: add "
                                f"{path.relative_to(spec.ROOT)}")
    return spec.load_json(path)


def cells_of(entry):
    """The cells whose ``cells/<cell>.json`` names ``entry``."""
    return [c for c in CELLS if spec.load_json(
        spec.BENCH_DIR / "cells" / f"{c}.json")["entry"] == entry]


def _run(cell, trace=False, program=mt, control=False):
    return run.run_cell(cell, SEED, 0.2, trace, device="cpu", mt=program,
                        shrink=tiny(cell), control=control,
                        log=lambda _m: None)


def _faulty(**fns):
    """The package with some functions replaced."""
    proxy = types.SimpleNamespace(**{k: getattr(mt, k) for k in dir(mt)
                                     if not k.startswith("__")})
    for k, f in fns.items():
        setattr(proxy, k, f)
    return proxy


@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_control_not(cell):
    res = _run(cell, control=True)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert line["failed"] == 0
    limits = spec.load_cell(cell).cell["check"]["limits"]
    assert set(line["compared"]) == set(limits)
    assert any(v > limits[k] for k, v in line["control"].items())
    names = {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_traced_line_carries_breakdown():
    res = _run("cbox.render", trace=True)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.load_cell("cbox.render").per_layer}
    assert set(res["metrics"]) <= per_layer


def _render_fault(kind):
    def render(scene, spp=None, seed=0, **kw):
        if kind == "half":  # half the samples, the mean over the rest
            return mt.render(scene, spp=spp // 2, seed=seed, **kw)
        out = list(mt.render(scene, spp=spp, seed=seed, **kw))
        if kind == "unchanged":  # the film as it started
            out[:2] = [torch.zeros_like(out[0]), torch.zeros_like(out[1])]
        else:  # one answer altered where it is produced: the centre's
            out[1] = out[1].clone()
            h, w = out[1].shape[:2]
            out[1][h // 2, w // 2] *= 10.0
        return tuple(out)
    return render


@pytest.mark.parametrize("cell", cells_of("render"))
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_render_faults_are_caught(cell, kind):
    res = _run(cell, program=_faulty(render=_render_fault(kind)))
    assert res["correct"] is False


def _half_backward(scene, grad_in, spp=None, seed=0, **kw):
    """The backward over half the samples, the mean over them."""
    return mt.render_backward(scene, grad_in, spp=spp // 2, seed=seed, **kw)


@pytest.mark.parametrize("cell", cells_of("grad_step"))
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_grad_faults_are_caught(cell, kind, monkeypatch):
    if kind == "unchanged":  # the step leaves its state as it was
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        program = mt
    elif kind == "half":
        program = _faulty(render_backward=_half_backward)
    else:
        program = _faulty(render=_render_fault("altered"))
    assert _run(cell, program=program)["correct"] is False


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cbox.render",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(spec.ROOT), env=env)
    assert res.returncode != 0 and res.stdout == ""


def test_run_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['portbench', '.']; import run; "
            "from harness import spec, trace, readers; "
            "import entries.render, entries.grad_step; "
            "import mitransient_tpu_torch; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(spec.ROOT), check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("mitransient_tpu_torch", mt)
    assert "mitransient_tpu_torch" not in run.forbidden_modules()
