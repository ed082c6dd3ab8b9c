"""Share of a gradient step's traced window that the texture lookup holds
on the device: 100 x the device seconds of the program's ``mitr:texture``
spans (``bsdf/api.py:_apply_texture``: the bilinear four-tap atlas lookup
of every lane, textured or not) over the window.  It opens only where the
lookup runs eagerly: the two sweeps of ``render_backward`` and a
multi-pass pass run before its graph is captured; a replayed pass opens
no span.  The lookup's backward, K8 on the four taps, runs later under
``mitr:adjoint``'s table gradients, outside this span.  A span's device
interval runs from its enter event to its exit event, so it includes
the device's idle time inside the span.  None where the program recorded no
such span: a program without it (older than the span) says nothing."""
from harness.spans import device_share, summary


def read(run):
    s = summary(run)
    if s is None or "mitr:texture" not in s["spans"]:
        return None
    return device_share(run, "mitr:texture")
