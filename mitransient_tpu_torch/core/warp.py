"""Sample warps (counterpart of ``mitransient_tpu/core/warp.py``): the
concentric disk and cosine hemisphere of the diffuse lobe, the uniform
sphere and hemisphere, and the Henyey-Greenstein phase function of the
media."""
from __future__ import annotations

import math

import torch

from .math import cos_sin, safe_sqrt

INV_PI = 1.0 / math.pi
INV_FOUR_PI = 1.0 / (4.0 * math.pi)
TWO_PI = 2.0 * math.pi


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


def square_to_uniform_sphere(sample: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * sample[..., 1]
    r = safe_sqrt(1.0 - z * z)
    c, s = cos_sin(TWO_PI * sample[..., 0])
    return torch.stack([r * c, r * s, z], dim=-1)


def square_to_uniform_sphere_pdf() -> float:
    return INV_FOUR_PI


def square_to_uniform_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    z = sample[..., 1]
    r = safe_sqrt(1.0 - z * z)
    c, s = cos_sin(TWO_PI * sample[..., 0])
    return torch.stack([r * c, r * s, z], dim=-1)


def square_to_hg(sample: torch.Tensor, g: torch.Tensor):
    """Henyey-Greenstein phase direction about +z -> (dir (N, 3), pdf (N,));
    ``g`` (N,) per lane.  Near-isotropic lanes (|g| < 1e-3) sample the
    uniform sphere."""
    g = torch.broadcast_to(g, sample[..., 0].shape)
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 0.5, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe
                                     + 2.0 * g_safe * sample[..., 1])
    cos_theta_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * sample[..., 1], cos_theta_hg)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    c, s = cos_sin((2.0 * math.pi) * sample[..., 0])
    d = torch.stack([sin_theta * c, sin_theta * s, cos_theta], dim=-1)
    return d, hg_pdf(cos_theta, g)


def hg_pdf(cos_theta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Henyey-Greenstein phase value and pdf, with ``cos_theta`` measured
    from the propagation direction (g > 0 peaks forward), as
    :func:`square_to_hg` samples it."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOUR_PI * (1.0 - g * g) / torch.clamp_min(
        denom * safe_sqrt(denom), 1e-12)
