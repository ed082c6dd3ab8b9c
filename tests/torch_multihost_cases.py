"""The configurations of the port's two-process test, shared by the test
(tests/test_torch_multihost.py) and its workers; no jax here."""
import numpy as np

from torch_cases import nlos_scene

RENDER = dict(spp=16, seed=0)
BACKWARD = dict(spp=8, seed=0)
EXHAUSTIVE = dict(spp=8, seed=0)
# the fused exhaustive capture and the point-by-point one
EXHAUSTIVE_VARIANTS = ("rgb", "mono_polarized")


def cbox(pkg) -> dict:
    """tests/multihost_worker.py's box: 8x8, 30 bins of 0.6 from OPL 0,
    depth 3, no Russian roulette."""
    d = pkg.cornell_box()
    d["sensor"]["film"].update(width=8, height=8, temporal_bins=30,
                               start_opl=0.0, bin_width_opl=0.6)
    d["integrator"].update(max_depth=3, rr_depth=99)
    return d


def ones_t():
    return np.ones((8, 8, 30, 3), np.float32)


def exhaustive() -> dict:
    """A 2x2 scan x 3x2 lasers exhaustive capture of ``nlos_scene``, 200
    bins (the first arrival near bin 101): 6 laser points over 4 shards of
    two processes."""
    d = nlos_scene(sx=2, sy=2, bins=200)
    d["integrator"]["capture_type"] = "exhaustive"
    d["relay_wall"]["nlos_sensor"]["film"].update(
        exhaustive_scan=True, laser_scan_width=3, laser_scan_height=2)
    return d
