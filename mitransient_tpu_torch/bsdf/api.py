"""BSDF evaluation/sampling over the loaded BSDF table, diffuse lobe only.

Counterpart of ``mitransient_tpu/bsdf/api.py``.  The loader refuses every
other BSDF kind (ROADMAP item 11), so each function here evaluates the
diffuse lobe and masks lanes whose kind is not diffuse (misses, -1).

Conventions (matching Mitsuba): directions are in the local shading frame,
+z = normal, pointing away from the surface; ``wi`` is toward the viewer.
``eval_pdf`` returns f * |cos_theta_o|; ``sample`` returns weight =
f * |cos| / pdf, which for a diffuse lobe is the reflectance.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.records import BSDFSample
from ..core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from ..scene.scene import BSDF_DIFFUSE, BSDFParams


class LaneBSDF(NamedTuple):
    """Per-lane gathered BSDF parameters."""

    kind: torch.Tensor  # (N,) int32, -1 for lanes without a hit
    reflectance: torch.Tensor  # (N, C)


def gather_lane_bsdf(bp: BSDFParams, bsdf_id: torch.Tensor) -> LaneBSDF:
    """Per-lane BSDF parameter gather."""
    i = torch.clamp_min(bsdf_id, 0)
    return LaneBSDF(
        kind=torch.where(bsdf_id >= 0, bp.kind.index_select(0, i), -1),
        reflectance=bp.reflectance.index_select(0, i),
    )


def is_smooth(lb: LaneBSDF) -> torch.Tensor:
    """Lanes whose BSDF has a non-delta component (NEE applies)."""
    return lb.kind == BSDF_DIFFUSE


def eval_pdf(lb: LaneBSDF, wi: torch.Tensor, wo: torch.Tensor,
             active: torch.Tensor):
    """Returns (f*cos (N, C), pdf (N,)) of the diffuse lobe."""
    ok = active & (wi[:, 2] > 0.0) & (wo[:, 2] > 0.0) & is_smooth(lb)
    co = wo[:, 2]
    f = lb.reflectance * (co / math.pi)[:, None]
    pdf = square_to_cosine_hemisphere_pdf(wo)
    return (torch.where(ok[:, None], f, 0.0), torch.where(ok, pdf, 0.0))


def sample(lb: LaneBSDF, wi: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
           active: torch.Tensor) -> BSDFSample:
    """Cosine-hemisphere sample of the diffuse lobe per lane.  ``u1`` (the
    lobe-selection draw of the JAX package) is unused by a diffuse lobe."""
    n = wi.shape[0]
    diffuse = is_smooth(lb)
    wo_diff = square_to_cosine_hemisphere(u2)
    pdf_diff = square_to_cosine_hemisphere_pdf(wo_diff)
    wo = torch.where(diffuse[:, None], wo_diff, 0.0)
    weight = torch.where(diffuse[:, None], lb.reflectance, 0.0)
    pdf = torch.where(diffuse, pdf_diff, 0.0)
    # a diffuse lane samples the upper hemisphere: wi must be above it
    lane_ok = active & (~diffuse | (wi[:, 2] > 0.0))
    ok = lane_ok & (pdf > 0.0) & (weight != 0.0).any(dim=-1)
    return BSDFSample(
        wo=wo,
        pdf=torch.where(ok, pdf, 0.0),
        eta=torch.ones((n,), dtype=torch.float32, device=wi.device),
        delta=torch.zeros((n,), dtype=torch.bool, device=wi.device),
        weight=torch.where(ok[:, None], weight, 0.0),
    )
