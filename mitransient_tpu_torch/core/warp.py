"""Sample warps used by the diffuse lobe (counterpart of
``mitransient_tpu/core/warp.py``: concentric disk and cosine hemisphere)."""
from __future__ import annotations

import math

import torch

from .math import cos_sin, safe_sqrt

INV_PI = 1.0 / math.pi


def square_to_uniform_disk_concentric(sample: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric disk mapping (low-distortion)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad1 = torch.abs(x) > torch.abs(y)
    r = torch.where(quad1, x, y)
    safe_x = torch.where(is_zero, 1.0, x)
    safe_y = torch.where(is_zero, 1.0, y)
    phi = torch.where(
        quad1,
        (math.pi / 4.0) * (safe_y / safe_x),
        (math.pi / 2.0) - (math.pi / 4.0) * (safe_x / safe_y),
    )
    phi = torch.where(is_zero, 0.0, phi)
    r = torch.where(is_zero, 0.0, r)
    c, s = cos_sin(phi)
    return torch.stack([r * c, r * s], dim=-1)


def square_to_cosine_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere (+z) sample; pdf = cos(theta)/pi."""
    p = square_to_uniform_disk_concentric(sample)
    px, py = p[..., 0], p[..., 1]
    z = safe_sqrt(1.0 - px * px - py * py)
    return torch.stack([px, py, z], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v[..., 2], 0.0) * INV_PI
