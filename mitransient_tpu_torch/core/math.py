"""Small vector-math helpers over ``(..., 3)`` float32 tensors.

Counterpart of ``mitransient_tpu/core/math.py``.  Dot products are written
out component by component (``ax*bx + ay*by + az*bz``) so that every
operation rounds on its own, in a fixed order, on every device; a
reduction such as ``torch.sum(a * b, -1)`` leaves the order to the backend.
"""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> shape ``(...)``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.sqrt(torch.clamp_min(dot(a, a), 1e-24))[..., None]


def safe_div(a, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with 0 where ``|b|`` is (denormal-)zero (broadcasts)."""
    bz = torch.abs(b) < 1e-20
    return torch.where(bz, 0.0, a / torch.where(bz, 1.0, b))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2): ``pdf_a^2 / (pdf_a^2 + pdf_b^2)``, 0 when
    ``pdf_a == 0`` or the ratio is not finite."""
    a2 = pdf_a * pdf_a
    w = safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0)
