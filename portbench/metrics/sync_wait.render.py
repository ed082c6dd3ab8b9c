"""Share of a render cell's traced window that the host spends reading
device values: 100 x the host seconds of the program's ``mitr:sync`` spans
(the regen loop's check for live lanes every ``LIVE_CHECK_EVERY`` bounces,
the camera's upload from pageable host memory, the film's opt-in sample
validation) over the window.  A sync waits for every launch before it to
finish, so the share is time in which the host issued nothing because it
waited for the device."""
from harness.spans import host_share


def read(run):
    return host_share(run, "mitr:sync")
