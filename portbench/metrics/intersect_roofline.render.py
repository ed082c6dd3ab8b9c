"""Share of the ray kernels' roofline: the soup kernels K1 and K2
(``csrc/intersect.cu``) and the BVH kernels (``csrc/bvh.cu``) by the
names the profiler gives them.  A change that replaces them names its
kernels in a new metric."""
from harness.readers import intersect_roofline

KERNELS = ("closest_hit_kernel", "any_hit_kernel", "bvh_tree_kernel",
           "bvh_super_kernel")


def read(run):
    return intersect_roofline(run, KERNELS)
