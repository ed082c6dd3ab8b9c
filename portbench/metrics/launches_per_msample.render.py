"""Device kernels launched in the traced window per 10^6 samples
completed."""
from harness.readers import launches_per_msample as read  # noqa: F401
