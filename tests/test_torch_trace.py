"""The port's spans and counters (``mitransient_tpu_torch/trace.py``) on the
CPU: nothing is recorded without a profiler and spans change no bit of a
render; under a profiler a render records one root, its bounces, the
sample streams' spans under them and the lane counters; sessions, threads,
the union of intervals, the profiler's own events and the launch counts."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mitransient_tpu_torch as mt
from mitransient_tpu_torch import kernels, trace
from mitransient_tpu_torch.kernels import _build
from torch_cases import nlos_z_scene, small_cbox

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return mt.load_dict(small_cbox(mt), device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU profiler, as a session of its own: a span that
    finds no profiler ends the session before it."""
    with trace.span("mitr:render"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_name(records, name):
    return [i for i, r in enumerate(records) if r.name == name]


def test_no_profiler_records_nothing_and_spans_change_no_bit(scene):
    assert trace.span("mitr:render") is trace.span("mitr:bounce")
    trace.count("lanes.active", 7)
    before, summary = trace.records(), trace.summary()
    plain = mt.render(scene, spp=16, seed=5)
    assert trace.records() == before and trace.summary() == summary
    traced, _prof = _profiled(lambda: mt.render(scene, spp=16, seed=5))
    assert len(_by_name(trace.records(), "mitr:render")) == 1
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("regenerate", [True, False])
def test_render_records_its_bounces_streams_and_lanes(scene, regenerate):
    spp = 16
    (_s, _t, stats), _prof = _profiled(lambda: mt.render(
        scene, spp=spp, seed=3, regenerate=regenerate, return_stats=True))
    recs = trace.records()
    (root,) = _by_name(recs, "mitr:render")
    assert recs[root].parent is None and recs[root].root == root
    bounces = _by_name(recs, "mitr:bounce")
    assert len(bounces) == stats["loop_iters"]
    for b in bounces:
        assert recs[b].parent == root and recs[b].root == root
        assert any(r.name == "mitr:rng" and r.parent == b for r in recs)
    assert all(r.root == root and r.end_ns >= r.start_ns for r in recs)
    hw = 16 * 16
    # one wavefront of n lanes a bounce: the regen loop's HW x lanes a
    # pixel, a multi-pass pass's HW x its spp (both 16 here)
    counters = trace.summary()["counters"]
    assert counters["lanes.launched"] == stats["loop_iters"] * hw * 16
    assert hw * spp <= counters["lanes.active"] <= counters["lanes.launched"]


def test_nlos_capture_records_its_bounces_laser_nee_and_lanes():
    sc = mt.load_dict(nlos_z_scene(8, 8), device="cpu")
    mt.nlos.focus_emitter_at_relay_wall_pixel([4, 4], sc)
    hw, spp, per_pass = 64, 16, 8  # two passes of 8 spp
    kw = dict(spp=spp, seed=7, max_lanes=hw * per_pass, return_stats=True)
    plain = mt.render(sc, **kw)
    traced, _prof = _profiled(lambda: mt.render(sc, **kw))
    for a, b in zip(plain[:2], traced[:2]):
        assert torch.equal(a, b)
    stats = traced[2]
    recs = trace.records()
    (root,) = _by_name(recs, "mitr:render")
    bounces = _by_name(recs, "mitr:bounce")
    assert len(bounces) == stats["loop_iters"] == 2 * sc.integrator.max_depth
    assert all(recs[b].parent == root for b in bounces)
    nee = _by_name(recs, "mitr:laser_nee")
    assert sorted(recs[i].parent for i in nee) == bounces
    assert all(any(r.name == "mitr:rng" and r.parent == b for r in recs)
               for b in bounces)
    # prepare_nlos's reads of the device tables and its uploads
    assert any(recs[i].parent == root for i in _by_name(recs, "mitr:sync"))
    counters = trace.summary()["counters"]
    assert counters["lanes.launched"] == stats["loop_iters"] * hw * per_pass
    assert hw * spp <= counters["lanes.active"] <= counters["lanes.launched"]
    # a closest hit and a shadow ray counted for each active lane
    assert 2 * counters["lanes.active"] == int(stats["rays"])


def test_summary_times_and_self_times(scene):
    _profiled(lambda: mt.render(scene, spp=16, seed=3))
    spans = trace.summary()["spans"]
    render, bounce = spans["mitr:render"], spans["mitr:bounce"]
    assert render["count"] == 1
    assert render["self_s"] < render["host_s"] - 0.9 * bounce["host_s"]
    for s in spans.values():
        assert 0.0 <= s["self_s"] <= s["host_s"]
        assert s["device_s"] == pytest.approx(s["host_s"], rel=1e-6)  # CPU
    assert spans["mitr:rng"]["count"] >= bounce["count"]
    assert spans["mitr:sync"]["count"] >= 1  # the regen loop's live check


def test_backward_records_the_adjoint_sweep(scene):
    grad = torch.ones((16, 16, 120, 3))
    _profiled(lambda: mt.render_backward(scene, (None, grad), spp=2,
                                         seed=1))
    recs = trace.records()
    (root,) = _by_name(recs, "mitr:render_backward")
    (adjoint,) = _by_name(recs, "mitr:adjoint")
    assert recs[adjoint].root == root
    depth = scene.integrator.max_depth
    swept = [b for b in _by_name(recs, "mitr:bounce")
             if recs[b].parent == adjoint]
    primal = [b for b in _by_name(recs, "mitr:bounce")
              if recs[b].parent == root]
    assert len(swept) == len(primal) == depth
    assert all(r.root == root for r in recs)


def test_session_starts_afresh_after_the_profiler_restarts(scene):
    _profiled(lambda: mt.render(scene, spp=8, seed=1))
    first = len(trace.records())
    mt.render(scene, spp=8, seed=1)  # no profiler: its spans find none
    _profiled(lambda: mt.render(scene, spp=8, seed=1))
    recs = trace.records()
    assert len(_by_name(recs, "mitr:render")) == 1 and len(recs) == first
    assert trace.summary()["spans"]["mitr:render"]["count"] == 1


def test_span_on_another_thread_corrupts_no_parent(monkeypatch):
    # a plain thread does not inherit the profiler's state (autograd's
    # device thread does): stand in for it
    monkeypatch.setattr(trace, "_enabled", lambda: True)
    monkeypatch.setattr(trace, "_stale", True)
    opened, resume = threading.Event(), threading.Event()

    def worker():
        with trace.span("other"):
            opened.set()
            resume.wait(10)
            with trace.span("other.inner"):
                pass

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        assert opened.wait(10)
        with trace.span("main.inner"):
            resume.set()
            t.join(10)
        assert not t.is_alive()
        with trace.span("main.after"):
            pass
    recs = {r.name: (i, r) for i, r in enumerate(trace.records())}
    main_i, main = recs["main"]
    other_i, other = recs["other"]
    assert other.thread != main.thread == threading.get_ident()
    assert other.parent is None and other.root == main_i
    assert recs["other.inner"][1].parent == other_i
    assert recs["other.inner"][1].thread == other.thread
    assert recs["main.inner"][1].parent == main_i
    assert recs["main.after"][1].parent == main_i
    assert all(r.end_ns is not None for _i, r in recs.values())


@pytest.mark.parametrize("intervals, covered", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlapping
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 9.0)], 10.0),  # nested
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 1.5), (1.5, 2.0)], 3.0),  # unsorted
    ([(0.0, 1.0), (1.0, 1.0), (3.0, 4.0)], 2.0),  # empty and touching
])
def test_union_of_intervals(intervals, covered):
    assert trace._union(intervals) == pytest.approx(covered)


def test_profiler_event_matches_the_recorders_stamps(scene):
    _out, prof = _profiled(lambda: mt.render(scene, spp=8, seed=2))
    (root,) = [r for r in trace.records() if r.name == "mitr:render"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "mitr:render"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert abs(start - root.start_ns) < 1_000_000
    assert abs(end - root.end_ns) < 1_000_000


def test_counts_under_a_profiler():
    mask = torch.tensor([True, False, True, True])
    _profiled(lambda: (trace.count("n", 3), trace.count("n", 4),
                       trace.count("mask", mask),
                       trace.count("tensor", torch.tensor(5))))
    counters = trace.summary()["counters"]
    assert counters == {"n": 7, "mask": 3, "tensor": 5}


def test_launch_counts_live_in_trace_alone():
    assert kernels.launch_counts is trace.launch_counts
    assert kernels.reset_launch_counts is trace.reset_launch_counts
    assert not hasattr(_build, "_launches")
    assert not hasattr(_build, "count_launch")
    trace.reset_launch_counts()
    trace.count_launch("splat_accumulate")  # always on: no profiler
    trace.count_launch("splat_accumulate")
    assert kernels.launch_counts() == {"splat_accumulate": 2}
    trace.reset_launch_counts()
    assert kernels.launch_counts() == {}
