"""Share of a gradient step's traced window that the threefry sample
streams hold on the device: 100 x the device seconds of the program's
``mitr:rng`` spans (``core/rng.py:uniform``: the camera rays and
``draw_bounce_block`` of the multi-pass primal, of the PRB primal replay
and of the adjoint sweep) over the window.  A span's device interval runs
from its enter event to its exit event, so it includes the device's idle
time inside the span: the share is the streams' hold on the device's
timeline."""
from harness.spans import device_share


def read(run):
    return device_share(run, "mitr:rng")
