"""Orthonormal shading frames (counterpart of ``mitransient_tpu/core/frame.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math import dot, normalize


def coordinate_system(n: torch.Tensor):
    """Duff et al. 2017 branchless ONB from a unit normal ``(..., 3)``.

    Returns tangent ``s`` and bitangent ``t`` with ``cross(s, t) = n``.
    """
    nx, ny, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


class Frame(NamedTuple):
    """Orthonormal frame; ``n`` is the +z axis (shading normal)."""

    s: torch.Tensor  # (..., 3)
    t: torch.Tensor  # (..., 3)
    n: torch.Tensor  # (..., 3)

    @staticmethod
    def from_normal(n: torch.Tensor) -> "Frame":
        n = normalize(n)
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)],
                           dim=-1)

    def to_world(self, v: torch.Tensor) -> torch.Tensor:
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])
