"""Everything of one cell, found by name: its entry in ``BENCHMARK.json``,
``cells/<cell>.json``, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``entries/<entry>.py`` and one reader ``metrics/<metric>.py`` for each
metric that ``BENCHMARK.json`` gives the cell.  Nothing here names a cell,
a configuration or a metric: a later change adds them as files and
manifest entries."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    workload: dict  # the BENCHMARK.json entry
    cell: dict  # cells/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    entry: object  # the entries/<entry>.py module
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH_DIR / "cells" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{wl['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
    entry = importlib.import_module(f"entries.{cell['entry']}")
    return Cell(name, wl, cell, config, traffic, entry,
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
