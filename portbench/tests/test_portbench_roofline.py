"""The frozen roofline arithmetic gives ``chip_smoke.py``'s bounds at its
shapes (K1 and K2 on 2^21 rays of the 36-triangle box, K3's film
sectors)."""
import numpy as np
import pytest
import torch

import chip_smoke
from harness import roofline


@pytest.mark.parametrize("n_active", [1 << 21, 1_234_567, 0])
@pytest.mark.parametrize("out_bytes", [8, 1])
def test_ray_bounds(n_active, out_bytes):
    n, m = 1 << 21, 36
    b = roofline.ray_bytes(n, n_active, out_bytes)
    assert b == chip_smoke.ray_bytes(n, n_active, out_bytes)
    ops = n_active * m * roofline.MT_OPS
    ms, by = chip_smoke._bound(b + m * 36, ops)
    s, by2 = roofline.bound_s(b + m * 36, ops)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_peaks_are_chip_smokes():
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == chip_smoke.FP32_OPS_PER_S
    assert roofline.MT_OPS == chip_smoke.MT_OPS


def test_film_sectors_match_splat_bound():
    """The sectors a film holds are the sectors its events touched."""
    rng = np.random.default_rng(3)
    hw, t, c, lanes = 64, 7, 3, 4 * 64
    bins = torch.from_numpy(rng.integers(0, t + 1, lanes).astype(np.int32))
    vals = torch.from_numpy(
        (rng.random((lanes, c)) * (rng.random((lanes, 1)) < 0.5))
        .astype(np.float32))
    sectors, _ = chip_smoke.splat_bound([bins, vals], hw, t + 1)
    film = torch.zeros((c, t + 1, hw))
    pix = torch.arange(lanes) % hw
    for lane in range(lanes):
        film[:, bins[lane], pix[lane]] += vals[lane]
    # the overflow bin counts in splat_bound's t_pad; keep it as a bin
    trans = film.permute(2, 1, 0).reshape(hw, 1, t + 1, c)
    assert roofline.film_sectors(trans) == sectors
