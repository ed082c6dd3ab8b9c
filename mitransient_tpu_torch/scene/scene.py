"""Loaded scene tables and device-side scene queries.

Counterpart of ``mitransient_tpu/scene/scene.py`` for the slice the port
runs today: triangle soups without an acceleration structure, diffuse
BSDFs and area emitters.  Everything the device touches lives in
:class:`SceneData`, a NamedTuple of flat tensors on one device.  Row
lookups are plain ``index_select`` gathers; the JAX package's one-hot
matmuls (``ops/gather.py``) were a TPU workaround and give the same values.

The tables keep every leaf of the JAX package's ``SceneData`` except the
media (ROADMAP item 15), including those the diffuse/area slice does not
read (conductor IORs, delta-emitter frames, geometry deltas), so that
``convert.py`` carries a JAX scene across whole and later slices add code,
not table changes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.frame import Frame
from ..core.math import dot, safe_div
from ..core.records import DirectionSample, Ray, SurfaceInteraction
from ..ops.intersect import closest_hit as _closest_hit_q
from ..ops.intersect import ray_test as _ray_test_q

# BSDF kind codes (same values as the JAX package)
BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1
BSDF_ROUGH_CONDUCTOR = 2
BSDF_DIELECTRIC = 3
BSDF_NULL = 4
BSDF_ROUGH_PLASTIC = 5

# Emitter kind codes
EM_AREA = 0
EM_PROJECTOR = 1
EM_ANGULAR_AREA = 2
EM_POINT = 3


class Triangles(NamedTuple):
    v0: torch.Tensor  # (M, 3)
    e1: torch.Tensor  # (M, 3) v1 - v0
    e2: torch.Tensor  # (M, 3) v2 - v0
    ng: torch.Tensor  # (M, 3) unit geometric normal
    uv0: torch.Tensor  # (M, 2)
    uv_e1: torch.Tensor  # (M, 2)
    uv_e2: torch.Tensor  # (M, 2)
    area: torch.Tensor  # (M,)
    shape_id: torch.Tensor  # (M,) int32
    bsdf_id: torch.Tensor  # (M,) int32
    emitter_id: torch.Tensor  # (M,) int32, -1 = none
    medium_id: torch.Tensor  # (M,) int32 interior medium, -1 = vacuum


class BSDFParams(NamedTuple):
    kind: torch.Tensor  # (B,) int32
    two_sided: torch.Tensor  # (B,) bool
    reflectance: torch.Tensor  # (B, C) diffuse albedo
    eta_re: torch.Tensor  # (B, C)
    eta_im: torch.Tensor  # (B, C)
    alpha: torch.Tensor  # (B,)
    eta_ratio: torch.Tensor  # (B,)
    alpha_v: torch.Tensor  # (B,)


class EmitterParams(NamedTuple):
    kind: torch.Tensor  # (E,) int32
    radiance: torch.Tensor  # (E, C)
    position: torch.Tensor  # (E, 3)
    direction: torch.Tensor  # (E, 3)
    frame_s: torch.Tensor  # (E, 3)
    frame_t: torch.Tensor  # (E, 3)
    tan_half_fov: torch.Tensor  # (E,)
    cos_beam: torch.Tensor  # (E,)
    cos_cutoff: torch.Tensor  # (E,)
    area: torch.Tensor  # (E,) total shape surface area
    tri_start: torch.Tensor  # (E,) int32 range into em_tri_* below
    tri_count: torch.Tensor  # (E,) int32
    em_tri_idx: torch.Tensor  # (K,) int32 triangle-soup index
    em_tri_cdf: torch.Tensor  # (K,) float32 CDF within each emitter's range
    em_tri_v0: torch.Tensor  # (K, 3) compact per-slot geometry
    em_tri_e1: torch.Tensor  # (K, 3)
    em_tri_e2: torch.Tensor  # (K, 3)
    em_tri_ng: torch.Tensor  # (K, 3)
    em_tri_shape: torch.Tensor  # (K,) int32


class GeomParams(NamedTuple):
    """Per-shape rigid-motion deltas (all zero after loading).  They exist
    for geometry gradients, which the port does not have yet (ROADMAP
    item 14); primal renders strip them with :func:`primal_sd`."""

    translate: torch.Tensor  # (S, 3)
    rotate: torch.Tensor  # (S, 3) axis-angle radians
    pivot: torch.Tensor  # (S, 3)


class SceneData(NamedTuple):
    tri: Triangles
    bsdf: BSDFParams
    emitter: EmitterParams
    geom: GeomParams | None = None


def primal_sd(sd: SceneData) -> SceneData:
    """Strip the geometry deltas for a primal render."""
    return sd._replace(geom=None) if sd.geom is not None else sd


# --------------------------------------------------------------------------
# Ray queries
# --------------------------------------------------------------------------

def ray_intersect(sd: SceneData, ray: Ray,
                  active: torch.Tensor) -> SurfaceInteraction:
    """Closest hit + shading record (``mi.Scene.ray_intersect``).  The
    kernel's inputs are detached: visibility is a discrete choice."""
    t, prim = _closest_hit_q(
        sd.tri.v0, sd.tri.e1, sd.tri.e2, ray.o.detach(), ray.d.detach(),
        ray.maxt.detach(), active)
    return _si_from_t_prim(sd, ray, t, prim)


def _si_from_t_prim(sd: SceneData, ray: Ray, t, prim) -> SurfaceInteraction:
    """Shading record from a traversal result (t, prim)."""
    if sd.geom is not None:
        raise NotImplementedError(
            "geometry deltas (differentiable shape poses) are not ported yet "
            "(ROADMAP item 14); render primal_sd(scene.data)")
    valid = prim >= 0
    prim_c = torch.clamp_min(prim, 0)
    tri = sd.tri

    def row(a):
        return a.index_select(0, prim_c)

    v0, e1, e2, ng = row(tri.v0), row(tri.e1), row(tri.e2), row(tri.ng)
    p = ray.o + ray.d * torch.where(valid, t, 0.0)[:, None]
    # Barycentrics of p in the winning triangle (projection method).
    w = p - v0
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(w, e1)
    d21 = dot(w, e2)
    denom = d00 * d11 - d01 * d01
    inv = safe_div(1.0, denom)
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    uv = row(tri.uv0) + row(tri.uv_e1) * u[:, None] + row(tri.uv_e2) * v[:, None]
    # Flat shading: the shading normal is the geometric normal.
    frame = Frame.from_normal(ng)
    wi = frame.to_local(-ray.d)

    def ids(table):
        return torch.where(valid, row(table), -1)

    return SurfaceInteraction(
        valid=valid,
        t=torch.where(valid, t, float("inf")),
        p=p,
        n=ng,
        frame=frame,
        uv=uv,
        wi=wi,
        prim=torch.where(valid, prim, -1),
        shape_id=ids(tri.shape_id),
        bsdf_id=ids(tri.bsdf_id),
        emitter_id=ids(tri.emitter_id),
    )


def ray_test(sd: SceneData, o: torch.Tensor, d_unit: torch.Tensor,
             dist: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Occlusion between ``o`` and ``o + d_unit * dist`` (shadow ray), with
    the far end shortened by 0.1%; cf. ``mi.Scene.ray_test``."""
    maxt = dist * (1.0 - 1e-3)
    return _ray_test_q(sd.tri.v0, sd.tri.e1, sd.tri.e2, o.detach(),
                       d_unit.detach(), maxt.detach(), active)


# --------------------------------------------------------------------------
# Emitters (area emitters only; the loader refuses other kinds)
# --------------------------------------------------------------------------

def _sample_emitter_triangle(sd: SceneData, em_idx: torch.Tensor,
                             u: torch.Tensor):
    """Pick a triangle of emitter ``em_idx`` area-proportionally via the
    per-emitter CDF segment; returns (rescaled u, emitter-triangle slot)."""
    em = sd.emitter
    start = em.tri_start.index_select(0, em_idx)
    end = start + em.tri_count.index_select(0, em_idx)
    k = torch.arange(em.em_tri_cdf.shape[0], dtype=torch.int32,
                     device=u.device)[None, :]
    in_seg = (k >= start[:, None]) & (k < end[:, None])
    below = in_seg & (u[:, None] > em.em_tri_cdf[None, :])
    slot = start + below.sum(dim=1, dtype=torch.int32)
    slot = torch.minimum(torch.maximum(slot, start), end - 1)
    cdf_prev = torch.cat([em.em_tri_cdf.new_zeros(1), em.em_tri_cdf[:-1]])
    cdf_lo = torch.where(slot > start, cdf_prev.index_select(0, slot), 0.0)
    pmf = torch.clamp_min(em.em_tri_cdf.index_select(0, slot) - cdf_lo, 1e-30)
    u2 = torch.clamp((u - cdf_lo) / pmf, 0.0, 1.0 - 1e-7)
    return u2, slot


def _uniform_triangle_point(sd: SceneData, slot: torch.Tensor,
                            u1: torch.Tensor, u2: torch.Tensor):
    """Uniform barycentric sample of emitter-triangle ``slot``, gathered
    from the compact per-emitter table."""
    su = torch.sqrt(torch.clamp_min(u1, 0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    em = sd.emitter
    p = (em.em_tri_v0.index_select(0, slot)
         + em.em_tri_e1.index_select(0, slot) * b1[:, None]
         + em.em_tri_e2.index_select(0, slot) * b2[:, None])
    return p, em.em_tri_ng.index_select(0, slot)


def sample_emitter_direction(
    sd: SceneData,
    ref_p: torch.Tensor,
    sample2: torch.Tensor,
    test_visibility: bool,
    active: torch.Tensor,
):
    """Next-event estimation sample (``mi.Scene.sample_emitter_direction``).

    Returns (DirectionSample, em_weight (N, C)).  ``em_weight`` = emitter
    radiance / pdf with visibility applied; pdf includes the uniform 1/E
    emitter-selection probability.
    """
    em = sd.emitter
    E = em.kind.shape[0]
    n = ref_p.shape[0]
    dev = ref_p.device
    if E == 0:
        zero = torch.zeros((n,), dtype=torch.float32, device=dev)
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        ds = DirectionSample(
            p=z3, n=z3, d=z3, dist=zero, pdf=zero,
            delta=torch.zeros((n,), dtype=torch.bool, device=dev),
            emitter_id=torch.full((n,), -1, dtype=torch.int32, device=dev))
        return ds, torch.zeros((n, em.radiance.shape[-1]), device=dev)

    u_sel = sample2[:, 0]
    em_idx = torch.clamp_max((u_sel * E).to(torch.int32), E - 1)
    u0 = torch.clamp(u_sel * E - em_idx.to(torch.float32), 0.0, 1.0 - 1e-7)
    sel_pdf = 1.0 / E

    u0b, slot = _sample_emitter_triangle(sd, em_idx, u0)
    p, n_em = _uniform_triangle_point(sd, slot, u0b, sample2[:, 1])
    area = torch.clamp_min(em.area.index_select(0, em_idx), 1e-30)

    d_vec = p - ref_p
    dist = torch.sqrt(torch.clamp_min(dot(d_vec, d_vec), 1e-20))
    d = d_vec / dist[:, None]
    cos_em = dot(n_em, -d)
    # solid-angle pdf at ref of an area emitter: dist^2 / (cos * A)
    pdf = safe_div(dist * dist, torch.clamp_min(cos_em, 0.0) * area) * sel_pdf
    spec = emitter_eval_direction(sd, em_idx, cos_em)

    valid = active & (pdf > 0.0) & (torch.abs(spec).sum(dim=-1) > 0.0)
    if test_visibility:
        o = ref_p + d * 1e-4  # offset along the connection
        occluded = ray_test(sd, o, d, dist - 2e-4, valid)
        valid = valid & ~occluded

    weight = torch.where(valid[:, None], safe_div(spec, pdf[:, None]), 0.0)
    ds = DirectionSample(
        p=p, n=n_em, d=d, dist=dist,
        pdf=torch.where(valid, pdf, 0.0),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        emitter_id=torch.where(valid, em_idx, -1),
    )
    return ds, weight


def emitter_eval_direction(sd: SceneData, em_idx: torch.Tensor,
                           cos_em: torch.Tensor) -> torch.Tensor:
    """Radiance leaving an area emitter toward the reference point: its
    constant radiance from the front side, 0 from the back."""
    rad = sd.emitter.radiance.index_select(0, em_idx)
    return torch.where((cos_em > 0.0)[:, None], rad, 0.0)


def pdf_emitter_direction(sd: SceneData, ref_p: torch.Tensor,
                          si: SurfaceInteraction) -> torch.Tensor:
    """Solid-angle pdf of NEE having sampled the direction that hit ``si``
    (for MIS at emitter hits).  Zero for non-emitter hits and back faces."""
    E = sd.emitter.kind.shape[0]
    if E == 0:
        return torch.zeros(ref_p.shape[:-1], dtype=torch.float32,
                           device=ref_p.device)
    em = si.emitter_id
    has_em = em >= 0
    area = torch.clamp_min(
        sd.emitter.area.index_select(0, torch.clamp_min(em, 0)), 1e-30)
    d_vec = si.p - ref_p
    dist2 = dot(d_vec, d_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    d = d_vec / dist[:, None]
    cos_em = dot(si.n, -d)
    pdf = safe_div(dist2, torch.clamp_min(cos_em, 0.0) * area) / E
    return torch.where(has_em & (cos_em > 0.0), pdf, 0.0)


def emitter_eval_hit(sd: SceneData, si: SurfaceInteraction,
                     ray_d: torch.Tensor) -> torch.Tensor:
    """Radiance emitted at a surface hit toward the viewer.  (N, C)."""
    E = sd.emitter.kind.shape[0]
    n = si.t.shape[0]
    if E == 0:
        return torch.zeros((n, sd.bsdf.reflectance.shape[-1]),
                           dtype=torch.float32, device=si.t.device)
    em = si.emitter_id
    cos_em = dot(si.n, -ray_d)
    val = emitter_eval_direction(sd, torch.clamp_min(em, 0), cos_em)
    return torch.where((em >= 0)[:, None], val, 0.0)
