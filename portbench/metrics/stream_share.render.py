"""Share of a render cell's traced window that the sample streams hold on
the device: 100 x the device seconds of the program's ``mitr:rng`` spans
(``core/rng.py:uniform``, which the multi-pass ``Sampler`` and
``draw_bounce_block`` draw through, and the regen loop's PCG
``hash_uniform``) over the window.  A span's device interval runs from its
enter event to its exit event, so it includes the device's idle time
inside the span: in the host-bound regen loop the device waits there for
the streams' launches, and the share is the streams' hold on the device's
timeline, not their kernels' busy time."""
from harness.spans import device_share


def read(run):
    return device_share(run, "mitr:rng")
