"""Share of the film splat's roofline: kernel K3 (``csrc/splat.cu``) by
the name the profiler gives it."""
from harness.readers import splat_roofline

KERNELS = ("splat_kernel",)


def read(run):
    return splat_roofline(run, KERNELS)
