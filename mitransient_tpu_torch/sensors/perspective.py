"""Pinhole perspective camera (counterpart of
``mitransient_tpu/sensors/perspective.py``).

Conventions: the camera looks along its local +z (Mitsuba ``look_at``),
film u grows right / v grows down, pixel (0, 0) top-left; the camera-space
x axis is the look_at 'left' vector, so ``x_cam = (1 - 2u) * tan_half_x``
reproduces Mitsuba's image orientation.  Ray generation of the regen
integrator lives in ``integrators/path_regen.py`` (``gen_ray``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

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
    return CameraArrays(
        R=torch.tensor(m[:3, :3], dtype=f32, device=device),
        origin=torch.tensor(m[:3, 3], dtype=f32, device=device),
        tan_half=torch.tensor([tx, ty], dtype=f32, device=device),
    )
