"""Share of an NLOS capture cell's traced window that the laser NEE holds
on the device: 100 x the device seconds of the program's
``mitr:laser_nee`` spans (``integrators/nlos_path.py:_laser_nee`` in each
bounce: the path vertex -> illuminated wall point segment with its shadow
ray, both BSDF terms and the laser's emission) over the window.  A span's
device interval runs from its enter event to its exit event, so it
includes the device's idle time inside the span: the share is the laser
NEE's hold on the device's timeline."""
from harness.spans import device_share


def read(run):
    return device_share(run, "mitr:laser_nee")
