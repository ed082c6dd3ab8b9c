"""The manifest and the files it names: every cell, configuration,
traffic mix, entry, metric and CPU-test size is found by name, and the
manifest keeps to the benchmark's contract on names, keys and bounds."""
import json
import re

import pytest

from entries.render import film_of
from harness import spec
from test_portbench_run import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
TINY_KEYS = {"film", "traffic", "focus_pixel"}
TINY_FILM = 64  # the widest side a CPU-test film may have


def test_manifest_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.workload["chips"] in (1, 4)
    assert {"setup", "call", "work", "release", "program_outputs",
            "reference_outputs", "compare"} <= set(dir(c.entry))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    moved = {m["moves"] for m in c.per_layer}
    assert moved <= e2e
    assert set(c.cell["check"]["limits"]) and all(
        v > 0 for v in c.cell["check"]["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_tiny_size(cell):
    """``tests/tiny/<cell>.json`` shrinks the cell's film to at most
    ``TINY_FILM`` pixels a side and none of its traffic's numbers, and
    names only keys that the cell's configuration and traffic have."""
    size = tiny(cell)
    assert set(size) <= TINY_KEYS, set(size) - TINY_KEYS
    c = spec.load_cell(cell)
    full = film_of(c.config["scene"])
    film = size.get("film", {})
    assert {"width", "height"} <= set(film)
    assert set(film) <= set(full), set(film) - set(full)
    for key in ("width", "height"):
        assert 0 < film[key] <= min(full[key], TINY_FILM), (key, film[key])
    traffic = size.get("traffic", {})
    assert set(traffic) <= set(c.traffic), set(traffic) - set(c.traffic)
    for key, val in traffic.items():
        if isinstance(val, (int, float)):
            assert val <= c.traffic[key], (key, val, c.traffic[key])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_names_units_and_bounds():
    names = [m["name"] for m in METRICS] + CELLS + [
        c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert "bound" not in m
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for c in MANIFEST["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
