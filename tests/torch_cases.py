"""Inputs and comparison rules shared by the port's tests and chip_smoke.py.

Everything is made with numpy from a seed, so the JAX reference and the
PyTorch port see the same arrays.  This module imports neither jax nor the
JAX package, so it also runs on a machine that has only PyTorch.
"""
from __future__ import annotations

import numpy as np

GOLDEN_RTOL = 5e-4  # test_golden's tolerance: rtol, and atol as a share of max
GOLDEN_ATOL_SCALE = 5e-5


def small_cbox(mt, w=16, h=16, bins=120, max_depth=6):
    """The cbox_rgb golden's scene (tests/golden_configs.py:_small_cbox)."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = w
    d["sensor"]["film"]["height"] = h
    d["sensor"]["film"]["temporal_bins"] = bins
    d["integrator"]["max_depth"] = max_depth
    return d


def golden_mismatch(got: np.ndarray, want: np.ndarray) -> dict:
    """Compare a render with a golden under test_golden's rule (rtol 5e-4,
    atol 5e-5 * max|want|).  Returns the share of elements within that
    tolerance and the relative mean error mean|got - want| / mean|want|."""
    scale = float(np.abs(want).max()) or 1.0
    ok = np.isclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL_SCALE * scale)
    return {
        "shape_ok": got.shape == want.shape,
        "frac_ok": float(ok.mean()),
        "n_bad": int((~ok).sum()),
        "rel_mean_err": float(np.abs(got - want).mean()
                              / max(float(np.abs(want).mean()), 1e-30)),
    }


def physics_checks(steady: np.ndarray, transient: np.ndarray,
                   red_green: bool = True) -> list[str]:
    """The cbox physics checks of the verify recipe; returns failures.

    First arrival (camera -> light distance) in bins 15-18, transient /
    steady energy ratio in (0.9, 1.0001], everything finite and, at a
    width of at least 32, the red wall left and the green wall right."""
    fails = []
    if not (np.all(np.isfinite(steady)) and np.all(np.isfinite(transient))):
        fails.append("non-finite values")
    prof = transient.sum(axis=(0, 1, 3))
    nz = np.nonzero(prof)[0]
    if nz.size == 0 or not 15 <= nz[0] <= 18:
        fails.append(f"first arrival bin {nz[:1]} not in 15-18")
    ratio = transient.sum() / steady.sum()
    if not 0.9 < ratio <= 1.0001:
        fails.append(f"transient/steady ratio {ratio}")
    if red_green:
        h, w, _ = steady.shape
        left, right = steady[h // 2, int(w * 6 / 256)], steady[h // 2, int(w * 249 / 256)]
        if not (left[0] > left[1] and right[1] > right[0]):
            fails.append(f"red/green walls: left {left}, right {right}")
    return fails


def random_soup(rng: np.random.Generator, m: int):
    """m random triangles in [-1, 1]^3; the last one repeats triangle 0,
    an exact tie that the lower index must win."""
    v0 = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    e1 = rng.normal(0.0, 0.4, (m, 3)).astype(np.float32)
    e2 = rng.normal(0.0, 0.4, (m, 3)).astype(np.float32)
    v0[-1], e1[-1], e2[-1] = v0[0], e1[0], e2[0]
    return v0, e1, e2


def random_rays(rng: np.random.Generator, n: int, soup=None):
    """Rays from random points of [-0.99, 0.99]^3 in random directions.
    A quarter have a short maxt, a tenth are inactive; with ``soup`` given
    a fifth aim at the centroid of triangle 0 (the tied pair)."""
    o = rng.uniform(-0.99, 0.99, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if soup is not None:
        v0, e1, e2 = soup
        k = n // 5
        d[:k] = (v0[0] + (e1[0] + e2[0]) / 3.0) - o[:k]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, np.inf, np.float32)
    short = rng.random(n) < 0.25
    maxt[short] = rng.uniform(0.05, 1.5, short.sum()).astype(np.float32)
    active = rng.random(n) >= 0.1
    return o, d, maxt, active


def camera_rays(rng: np.random.Generator, n: int, R: np.ndarray,
                origin: np.ndarray, tan_half: np.ndarray):
    """Jittered pinhole rays over the whole image of a camera."""
    u, v = rng.random(n), rng.random(n)
    d_cam = np.stack([(1 - 2 * u) * tan_half[0], (1 - 2 * v) * tan_half[1],
                      np.ones(n)], axis=-1)
    d = d_cam @ R.T
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(origin, (n, 3)).astype(np.float32)
    return o, d


def splat_events(rng: np.random.Generator, lanes: int, hw: int, bins: int,
                 channels: int = 3):
    """One event set for a (channels, bins + 1, hw) film: bins in [0, bins]
    (bin ``bins`` is the overflow slot, about 5% of lanes), values with
    about 30% exact zeros (inactive lanes)."""
    n = lanes * hw
    b = rng.integers(0, bins, n).astype(np.int32)
    b[rng.random(n) < 0.05] = bins
    v = rng.random((n, channels)).astype(np.float32)
    v[rng.random(n) < 0.3] = 0.0
    return b, v
