"""Share of a gradient step's traced window that the PRB adjoint sweep
holds on the device: 100 x the device seconds of the program's
``mitr:adjoint`` spans (``integrators/prb.py:sample_adjoint`` in backward
mode, with its per-bounce ``table_grads``, whose backward runs K8) over
the window.  A span's device interval runs from its enter event to its
exit event, so it includes the device's idle time inside the span: the
share is the sweep's hold on the device's timeline."""
from harness.spans import device_share


def read(run):
    return device_share(run, "mitr:adjoint")
