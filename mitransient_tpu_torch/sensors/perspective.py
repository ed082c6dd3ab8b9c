"""Pinhole perspective camera (counterpart of
``mitransient_tpu/sensors/perspective.py``).

Conventions: the camera looks along its local +z (Mitsuba ``look_at``),
film u grows right / v grows down, pixel (0, 0) top-left; the camera-space
x axis is the look_at 'left' vector, so ``x_cam = (1 - 2u) * tan_half_x``
reproduces Mitsuba's image orientation.  :func:`sample_rays` generates the
multi-pass render's camera rays from the threefry stream; the regen
integrator draws its own from the PCG hash (``integrators/path_regen.py``,
``gen_ray``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import trace
from ..core.math import divide, normalize
from ..core.records import Ray
from ..core.rng import Sampler
from ..scene.schema import SensorConfig


class CameraArrays(NamedTuple):
    """Device-side camera parameters."""

    R: torch.Tensor  # (3, 3) columns = camera x/y/z axes in world space
    origin: torch.Tensor  # (3,)
    tan_half: torch.Tensor  # (2,) [x, y]


def build_camera(cfg: SensorConfig, device="cpu") -> CameraArrays:
    m = cfg.to_world.m
    w, h = cfg.film.width, cfg.film.height
    aspect = w / h
    t = math.tan(math.radians(cfg.fov) / 2.0)
    axis = cfg.fov_axis
    if axis == "smaller":
        axis = "x" if w <= h else "y"
    elif axis == "larger":
        axis = "x" if w >= h else "y"
    tx, ty = (t, t / aspect) if axis == "x" else (t * aspect, t)
    f32 = torch.float32
    with trace.span("mitr:sync"):  # copies from pageable host memory
        return CameraArrays(
            R=torch.tensor(m[:3, :3], dtype=f32, device=device),
            origin=torch.tensor(m[:3, 3], dtype=f32, device=device),
            tan_half=torch.tensor([tx, ty], dtype=f32, device=device),
        )


def sample_rays(
    cam: CameraArrays,
    sampler: Sampler,
    width: int,
    height: int,
    spp: int,
    crop_offset: tuple[int, int] = (0, 0),
    full_size: tuple[int, int] | None = None,
):
    """Generate ``height * width * spp`` camera rays on the camera's device,
    spp-major (lane = s * HW + pixel, the layout of the film splat).

    ``width`` / ``height`` are the data (crop window) dimensions; with a
    crop, ``crop_offset`` places the window on the full sensor and
    ``full_size`` gives the full film size for the uv mapping (the
    projection is that of the full sensor).

    Returns (Ray, pix (N,) int64, ray_weight (N,)).  Draws sampler dims 0-1
    (the pixel jitter)."""
    fw, fh = full_size if full_size is not None else (width, height)
    ox, oy = crop_offset
    hw = width * height
    n = hw * spp
    dev = cam.origin.device
    pix = torch.arange(n, dtype=torch.int64, device=dev) % hw
    px = (pix % width).to(torch.float32) + float(ox)
    py = (pix // width).to(torch.float32) + float(oy)

    jitter = sampler.next_2d()  # dims 0-1
    u = divide(px + jitter[:, 0], fw)
    v = divide(py + jitter[:, 1], fh)
    d_cam = torch.stack([(1.0 - 2.0 * u) * cam.tan_half[0],
                         (1.0 - 2.0 * v) * cam.tan_half[1],
                         torch.ones_like(u)], dim=-1)
    d_world = normalize(d_cam @ cam.R.T)
    o = cam.origin.expand(n, 3).contiguous()  # the ray kernels take (N, 3)
    return (Ray.make(o, d_world), pix,
            torch.ones((n,), dtype=torch.float32, device=dev))
