"""Arithmetic shared by the metric readers in ``metrics/``.  A reader takes
the run's record (``run.py``) and returns a number, or None where the run
has nothing to read (then the metric is left out of the line); a share of
a roofline is never returned as 0 for want of a reading."""
from __future__ import annotations

from . import roofline


def samples_per_s(run):
    """Pixel samples completed a second over the window (H x W x spp a
    render, scan points x spp a capture, from the cell's data)."""
    if not run.samples:
        return None
    return run.samples / run.window_s


def launches_per_msample(run):
    """Device kernels launched in the traced window per 10^6 samples."""
    if run.trace is None or not run.samples:
        return None
    return run.trace.n_kernels / (run.samples / 1e6)


def idle_share(run):
    """Percent of the traced window in which no kernel, copy or set ran."""
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)


def kernel_seconds(run, names) -> float:
    """Device seconds of the kernels whose short names are in ``names``."""
    return sum(s for k, (_n, s) in run.trace.kernels.items() if k in names)


def intersect_roofline(run, names):
    """Percent of the ray kernels' device time that the least work of the
    window's rays needs: every ray of the renders' ``rays`` count (closest
    hits and shadow rays) read once with a one-byte answer, tested against
    every triangle of the scene (``MT_OPS`` each)."""
    if run.trace is None or not run.rays:
        return None
    t = kernel_seconds(run, names)
    if t <= 0:
        return None
    need, _by = roofline.bound_s(
        roofline.ray_bytes(run.rays, run.rays, 1),
        run.rays * run.triangles * roofline.MT_OPS)
    return 100.0 * need / t


def splat_roofline(run, names):
    """Percent of the splat kernel's device time that the least work of the
    window's film events needs: each event (one a ray of ``rays`` times the
    cell's ``splat_events_per_ray``: a 4-byte bin and C floats) read once,
    and each film sector a render touches read and written once; one add
    an event and channel."""
    if run.trace is None or not run.rays:
        return None
    t = kernel_seconds(run, names)
    if t <= 0:
        return None
    events = run.rays * run.events_per_ray
    n_bytes = (events * (4 + 4 * run.channels)
               + 2 * 32 * run.sectors_per_call * run.calls)
    need, _by = roofline.bound_s(n_bytes, events * run.channels)
    return 100.0 * need / t
