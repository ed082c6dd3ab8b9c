"""The program's own spans and counters: what ``mitransient_tpu_torch.trace``
recorded while the traced window's profiler ran (a ``--trace 1`` run).
Each reader gets None, never 0, where the program has no such module (an
older checkout) or the window recorded nothing.  A span that a window
which recorded others never opened took no time there: its share is 0."""
from __future__ import annotations

import importlib


def summary(run):
    """The program's ``trace.summary()`` of the traced window, or None."""
    if run.trace is None:
        return None
    try:
        trace = importlib.import_module("mitransient_tpu_torch.trace")
    except ImportError:
        return None
    s = trace.summary()
    if not s["spans"] and not s["counters"]:
        return None
    return s


def _span_share(run, name: str, key: str):
    s = summary(run)
    if s is None or run.window_s <= 0:
        return None
    return 100.0 * s["spans"].get(name, {key: 0.0})[key] / run.window_s


def device_share(run, name: str):
    """Percent of the window covered by the device intervals of the span
    ``name``: the union of its CUDA events' intervals, each from the
    span's enter to its exit on the device's timeline, so that it counts
    the device's idle time inside the span as well."""
    return _span_share(run, name, "device_s")


def host_share(run, name: str):
    """Percent of the window that the host spent inside the span ``name``."""
    return _span_share(run, name, "host_s")


def counter_share(run, part: str, whole: str):
    """100 x the counter ``part`` over the counter ``whole``."""
    s = summary(run)
    if s is None or not s["counters"].get(whole) or part not in s["counters"]:
        return None
    return 100.0 * s["counters"][part] / s["counters"][whole]
