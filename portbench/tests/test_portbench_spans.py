"""The per-layer metrics read from the program's own spans and counters
(``harness/spans.py``): a traced run of each cell on the CPU reports each
of them as a number in [0, 100], an untraced run none, and each reader
gives None where the program recorded nothing or has no tracing module."""
import types

import pytest

import mitransient_tpu_torch as mt
from harness import spans, spec
from test_portbench_run import CELLS, _run

SPAN_METRICS = [m for m in spec.load_json(spec.ROOT / "BENCHMARK.json")
                ["per_layer"] if m["source"].startswith("program_")]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_span_metrics(cell):
    names = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert names
    res = _run(cell, trace=True)
    assert names <= set(res["metrics"])
    for name in names:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and 0.0 <= value <= 100.0, name
        assert res["metrics"][name]["unit"] == "%"


def test_untraced_run_reports_none():
    res = _run("cbox.render")
    assert not {m["name"] for m in SPAN_METRICS} & set(res["metrics"])


def _record(window_s=1.0):
    return types.SimpleNamespace(trace=object(), window_s=window_s)


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_reader_none_when_nothing_recorded(metric, monkeypatch):
    monkeypatch.setattr(mt.trace, "summary",
                        lambda: {"spans": {}, "counters": {}})
    assert spec.metric_reader(metric)(_record()) is None
    untraced = types.SimpleNamespace(trace=None, window_s=1.0)
    assert spec.metric_reader(metric)(untraced) is None


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_reader_none_without_the_tracing_module(metric, monkeypatch):
    """An older checkout of the program: no ``mitransient_tpu_torch.trace``."""
    def no_module(name):
        raise ModuleNotFoundError(name)

    monkeypatch.setattr(spans.importlib, "import_module", no_module)
    assert spec.metric_reader(metric)(_record()) is None


def test_shares_from_a_summary(monkeypatch):
    monkeypatch.setattr(mt.trace, "summary", lambda: {
        "spans": {"mitr:rng": {"count": 3, "host_s": 0.5, "self_s": 0.5,
                               "device_s": 0.25},
                  "mitr:sync": {"count": 1, "host_s": 0.1, "self_s": 0.1,
                                "device_s": 0.1}},
        "counters": {"lanes.launched": 400, "lanes.active": 100}})
    run = _record(window_s=2.0)
    assert spans.device_share(run, "mitr:rng") == 12.5
    assert spans.host_share(run, "mitr:sync") == 5.0
    assert spans.device_share(run, "mitr:adjoint") == 0.0
    assert spans.counter_share(run, "lanes.active", "lanes.launched") == 25.0
