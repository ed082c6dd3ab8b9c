"""Spans and counters of the port, recorded while a ``torch.profiler``
session records.

The render and gradient paths open spans at their layer boundaries
(:func:`span`) and add counts there (:func:`count`).  Nothing is recorded
unless ``torch.autograd._profiler_enabled()`` is true, that is while a
``torch.profiler`` session records, as ``record_function`` behaves: with
the profiler off a span is one shared no-op object behind that one check,
and a count returns at once.  There is no other switch.  The first span
that finds a profiler recording after one that found none starts a new
session, so each profiled window is one session.

A span records its name, its parent (the innermost open span of its
thread, or None), its root (shared by every span of one root call, such as
``mitr:render`` or ``mitr:render_backward``; a span opened on another
thread while a root is open, as on autograd's device thread, joins that
root), its thread, host enter and exit stamps from ``time.time_ns()`` (the
clock of the profiler's own events) and, where the CUDA runtime is
initialised, two CUDA events recorded on the current stream at enter and
exit.  It also opens a ``torch.profiler.record_function`` range of its
name, so that a trace exported with CPU activity (``export_chrome_trace``)
shows the spans above the kernels.

:func:`summary` synchronises and reads the session: per span name its
count, host seconds, host self seconds (the duration less what its child
spans cover) and device seconds (the union of its event intervals, which
include the device's idle time inside the span; on the CPU the host
intervals), and the counters.

The kernels' launch counts (:func:`count_launch`) live here too, in a
tally of the same kind, and are counted always, profiler or not.

A pass body captured into a CUDA graph (``passgraph.py``) runs inside
:func:`capturing`: there no span is opened (a span records CUDA events,
which a capture cannot hold), and counts and launches go to a
:class:`CaptureSink` instead, whatever the profiler: a tensor count
becomes a device accumulator that the graph fills on every replay, a
Python count and a launch a number the graph stands for.
:func:`replay_counts` adds them after each replay, as the body's eager
run would have.  A count that should not add work to the graph asks
:func:`recording` first, and then counts only where a span would record.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: int | None  # index in records() of the enclosing span
    root: int  # index in records() of the root span of the call
    thread: int  # threading.get_ident() of the thread that opened it
    start_ns: int | None  # time.time_ns() at enter; None while entering
    end_ns: int | None  # at exit; None while open


class _Tally:
    """Counts by name: Python ints added at once, tensors kept as they are
    (no synchronisation) and added when read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ints: dict[str, int] = {}
        self.tensors: dict[str, list] = {}

    def add(self, name: str, value) -> None:
        with self.lock:
            if isinstance(value, torch.Tensor):
                self.tensors.setdefault(name, []).append(value)
            else:
                self.ints[name] = self.ints.get(name, 0) + value

    def read(self) -> dict[str, int]:
        with self.lock:
            out = dict(self.ints)
            tensors = {k: list(v) for k, v in self.tensors.items()}
        for name, ts in tensors.items():
            out[name] = out.get(name, 0) + sum(int(t) for t in ts)
        return out

    def clear(self) -> None:
        with self.lock:
            self.ints.clear()
            self.tensors.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NOOP = _Noop()


class _Session:
    """What one profiled window recorded.  Its CUDA events live until the
    next session replaces it, since :func:`summary` reads them all."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[list] = []  # SpanRecord fields
        self.events: list = []  # per record: (enter, exit) CUDA events
        self.counters = _Tally()
        self.root: int | None = None  # the open root span
        self.cuda = torch.cuda.is_initialized()
        self.anchor = None  # the origin of the events' times
        if self.cuda:
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()


_local = threading.local()
_stale = True  # the last span found no profiler: the next one starts anew
_session_lock = threading.Lock()
_session = _Session()


def _current() -> _Session:
    global _session, _stale
    if _stale:
        with _session_lock:
            if _stale:
                _session = _Session()
                _stale = False
    return _session


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "session", "index", "rf", "ev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ses = self.session = _current()
        stack = _stack()
        top = stack[-1] if stack else None
        parent = top.index if top is not None and top.session is ses else None
        self.ev = ((torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
                   if ses.cuda else None)
        with ses.lock:
            index = self.index = len(ses.records)
            if parent is not None:
                root = ses.records[parent][2]
            elif ses.root is not None:
                root = ses.root
            else:
                root = ses.root = index
            ses.records.append([self.name, parent, root,
                                threading.get_ident(), None, None])
            ses.events.append(self.ev)
        stack.append(self)
        self.rf = torch.autograd.profiler.record_function(self.name)
        ses.records[index][4] = time.time_ns()
        self.rf.__enter__()
        if self.ev is not None:
            self.ev[0].record()
        return self

    def __exit__(self, exc_type, exc, tb):
        ses = self.session
        if self.ev is not None:
            self.ev[1].record()
        self.rf.__exit__(exc_type, exc, tb)
        t1 = time.time_ns()
        _stack().pop()
        with ses.lock:
            ses.records[self.index][5] = t1
            if ses.root == self.index:
                ses.root = None


class CaptureSink:
    """What a pass body counted while it was captured into a CUDA graph:
    per counter a Python int or a device accumulator (allocated in the
    capture, so that each replay sets it anew), and the hand-written
    kernels' launches."""

    def __init__(self):
        self.ints: dict[str, int] = {}
        self.tensors: dict[str, torch.Tensor] = {}
        self.launches: dict[str, int] = {}

    def add(self, name: str, value) -> None:
        if not isinstance(value, torch.Tensor):
            self.ints[name] = self.ints.get(name, 0) + value
            return
        if value.dtype == torch.bool:
            value = value.sum()
        acc = self.tensors.get(name)
        if acc is None:
            self.tensors[name] = value.clone()
        else:
            acc.add_(value)


def _sink() -> CaptureSink | None:
    return getattr(_local, "sink", None)


@contextlib.contextmanager
def capturing(sink: CaptureSink):
    """Spans are no-ops, and counts and launches go to ``sink``, inside."""
    _local.sink = sink
    try:
        yield sink
    finally:
        _local.sink = None


def replay_counts(sink: CaptureSink) -> None:
    """Count one replay of the graph whose capture filled ``sink``: its
    launches always, its counters while a profiler records (a copy of
    each accumulator, which the next replay overwrites)."""
    for kernel, n in sink.launches.items():
        _launches.add(kernel, n)
    if not _enabled():
        return
    for name, n in sink.ints.items():
        count(name, n)
    for name, acc in sink.tensors.items():
        count(name, acc.clone())


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    records, else the shared no-op (always inside :func:`capturing`)."""
    global _stale
    if _enabled():
        return _NOOP if _sink() is not None else _Span(name)
    _stale = True
    return _NOOP


def recording() -> bool:
    """Whether a span opened here records: a profiler records and no
    capture is under way.  A count that would put work into a captured
    graph, which every later replay runs, traced or not, asks this
    first."""
    return _enabled() and _sink() is None


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profiler records: a
    Python int, a device tensor (kept, and read by :func:`summary`) or a
    bool mask (its true lanes, summed on the device).  Never synchronises.
    Inside :func:`capturing` the sink takes it, profiler or not."""
    sink = _sink()
    if sink is not None:
        sink.add(name, value)
        return
    if not _enabled():
        return
    if isinstance(value, torch.Tensor) and value.dtype == torch.bool:
        value = value.sum()
    _current().counters.add(name, value)


def records() -> list[SpanRecord]:
    """The spans of the last session, in the order they were opened."""
    ses = _session
    with ses.lock:
        return [SpanRecord(*r) for r in ses.records]


def _union(intervals) -> float:
    """The total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summary() -> dict:
    """``{"spans": {name: {"count", "host_s", "self_s", "device_s"}},
    "counters": {name: int}}`` of the last session (empty where it
    recorded nothing).  Synchronises with the device."""
    ses = _session
    with ses.lock:
        recs = [SpanRecord(*r) for r in ses.records]
        events = list(ses.events)
    if ses.cuda:
        torch.cuda.synchronize()
    closed = [i for i, r in enumerate(recs) if r.end_ns is not None]
    children: dict[int, list] = {}
    for i in closed:
        if recs[i].parent is not None:
            children.setdefault(recs[i].parent, []).append(i)
    spans: dict[str, dict] = {}
    device: dict[str, list] = {}  # ms on the card, ns on the host
    for i in closed:
        r = recs[i]
        host = (r.end_ns - r.start_ns) * 1e-9
        inner = _union((max(recs[c].start_ns, r.start_ns),
                        min(recs[c].end_ns, r.end_ns))
                       for c in children.get(i, ()))
        s = spans.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": 0.0})
        s["count"] += 1
        s["host_s"] += host
        s["self_s"] += host - inner * 1e-9
        ev = events[i]
        if ev is not None:
            iv = (ses.anchor.elapsed_time(ev[0]),
                  ses.anchor.elapsed_time(ev[1]))
        else:
            iv = (r.start_ns, r.end_ns)
        device.setdefault(r.name, []).append(iv)
    scale = 1e-3 if ses.cuda else 1e-9
    for name, ivs in device.items():
        spans[name]["device_s"] = _union(ivs) * scale
    return {"spans": spans, "counters": ses.counters.read()}


_launches = _Tally()


def count_launch(kernel: str) -> None:
    """Count one launch of the hand-written kernel ``kernel`` (always; in
    a capture, one launch of each replay)."""
    sink = _sink()
    if sink is not None:
        sink.launches[kernel] = sink.launches.get(kernel, 0) + 1
        return
    _launches.add(kernel, 1)


def launch_counts() -> dict[str, int]:
    return _launches.read()


def reset_launch_counts() -> None:
    _launches.clear()
