"""Loaded scene tables and device-side scene queries.

Counterpart of ``mitransient_tpu/scene/scene.py``: triangle soups, with
the chunked acceleration structure of ``ops/accel.py`` above 4096
triangles, the BSDF table with its texture and bump-map atlases, and the
area, angulararea, projector and point emitters.  Everything the device
touches lives in :class:`SceneData`, a NamedTuple of flat tensors on one
device.  Row lookups of the tables that carry a gradient (the BSDF
reflectance, texels, emitter radiance and position, shape poses) go
through ``ops.gather.gather_rows``, whose backward adds the lanes onto the
rows in a fixed order (kernel K8 on the card); the other tables' are
plain ``index_select`` gathers.  The JAX package's one-hot matmuls
(``ops/gather.py``) were a TPU workaround and give the same values.  The emitter queries compute only the branches of the emitter
kinds the scene holds (``SceneData.emitter_kinds``), and the BSDF code only
the lobes of the BSDF kinds it holds (``SceneData.bsdf_kinds``): the JAX
package's static ``KindsStatic``.

The tables keep every leaf of the JAX package's ``SceneData``, the
participating media (:class:`MediumParams`) among them, so that
``convert.py`` carries a JAX scene across whole.  The per-shape geometry deltas (:class:`GeomParams`, zero after
loading) exist for geometry gradients: with them, :func:`ray_intersect`
re-derives the hit distance from the moved triangle's plane and NEE moves
its emitter points, so that autograd reaches the shape poses; primal
renders strip them (:func:`primal_sd`).  The port adds tables derived
from those leaves (:data:`DERIVED_FIELDS`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.frame import Frame
from ..core.math import (
    cos_sin,
    cross,
    divide,
    dot,
    normalize,
    replace_grad,
    safe_div,
    sqrt,
)
from ..core.records import DirectionSample, Ray, SurfaceInteraction
from ..ops.bvh import BVH_MODE
from ..ops.accel import TREE_FIELDS, Accel
from ..ops.gather import gather_rows
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


# fields of each record that the port derives from its other fields (or,
# for the accel's trees, from its bounds); convert.py rebuilds them and
# leaves them out of the JAX package's leaves
DERIVED_FIELDS = {"tri": ("table",), "emitter": ("em_tri_key",),
                  "accel": TREE_FIELDS}

ALL_BSDF_KINDS = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR,
                  BSDF_DIELECTRIC, BSDF_NULL, BSDF_ROUGH_PLASTIC)


class BSDFKinds(NamedTuple):
    """What the BSDF table holds, known on the host: the sorted kind codes
    and whether any row is two-sided.  The lobes of absent kinds and the
    two-sided flip are not computed.  The default stands for any table."""

    kinds: tuple = ALL_BSDF_KINDS
    any_two_sided: bool = True

    def has(self, code: int) -> bool:
        return code in self.kinds


def bsdf_kinds(kind, two_sided) -> BSDFKinds:
    """The :class:`BSDFKinds` of a BSDF table's ``kind`` and ``two_sided``
    columns (host arrays or tensors)."""
    return BSDFKinds(tuple(sorted({int(k) for k in kind.tolist()})),
                     bool(np.any(np.asarray(two_sided.tolist(), bool))))


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
    # the ray kernels' layout of v0, e1, e2 (ops/intersect.py:tri_table),
    # built once per scene; the port's own, not a leaf of the JAX package
    table: torch.Tensor  # (M, 12) f32


class BSDFParams(NamedTuple):
    kind: torch.Tensor  # (B,) int32
    two_sided: torch.Tensor  # (B,) bool
    reflectance: torch.Tensor  # (B, C) diffuse albedo / specular tint
    eta_re: torch.Tensor  # (B, C) conductor IOR (real)
    eta_im: torch.Tensor  # (B, C) conductor IOR (imaginary)
    alpha: torch.Tensor  # (B,) GGX roughness along the tangent
    eta_ratio: torch.Tensor  # (B,) dielectric int_ior / ext_ior
    alpha_v: torch.Tensor  # (B,) GGX roughness along the bitangent
    # textured reflectance: one padded atlas of every texture of the scene,
    # read by a bilinear 4-tap lookup at (tex_id, uv); None without textures
    tex_id: torch.Tensor | None = None  # (B,) int32, -1 = untextured
    tex_hw: torch.Tensor | None = None  # (B, 2) f32 (height, width)
    tex_uv: torch.Tensor | None = None  # (B, 4) f32 (su, sv, ou, ov)
    textures: torch.Tensor | None = None  # (NT, TH, TW, C) f32
    # shading-normal perturbation (bumpmap / normalmap wrappers): a
    # 3-channel atlas of (height, dh/dx, dh/dy) in texel units for a bump
    # map, or the tangent-space normal for a normal map
    bump_id: torch.Tensor | None = None  # (B,) int32, -1 = unperturbed
    bump_hw: torch.Tensor | None = None  # (B, 2) f32
    bump_uv: torch.Tensor | None = None  # (B, 4) f32
    bump_scale: torch.Tensor | None = None  # (B,) f32
    bump_kind: torch.Tensor | None = None  # (B,) int32 1 = bump, 2 = normal
    bump_textures: torch.Tensor | None = None  # (NB, TH, TW, 3) f32


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
    # the port's own: (owning emitter << 32) + the float bits of
    # em_tri_cdf, which increases along the table, so that one
    # searchsorted finds a slot within its emitter's segment
    em_tri_key: torch.Tensor  # (K,) int64


class GeomParams(NamedTuple):
    """Per-shape rigid-motion deltas, the differentiable geometry: a
    translation and an axis-angle rotation about ``pivot`` (the shape's
    to_world origin), all zero after loading.  Gradients with respect to
    them are d(render)/d(shape pose) at the current pose.  To move a shape,
    set ``traverse(scene)['<key>.to_world.translate']`` and ``update()``,
    which re-bakes the soup on the host.  Primal renders strip them with
    :func:`primal_sd`."""

    translate: torch.Tensor  # (S, 3)
    rotate: torch.Tensor  # (S, 3) axis-angle radians
    pivot: torch.Tensor  # (S, 3)


class MediumParams(NamedTuple):
    """Participating media, each the interior of the shapes whose triangles
    name it (``Triangles.medium_id``): extinction ``sigma_t`` (the scale of
    a heterogeneous medium's density), single-scattering albedo, HG
    anisotropy ``g``, a density grid (constant (1, 1, 1) ones where no
    medium has a grid) with its world -> [0, 1]^3 affine, and the tracking
    majorant (sigma_t times the grid's largest density).  A scene without
    media holds one zero row."""

    sigma_t: torch.Tensor  # (M,)
    albedo: torch.Tensor  # (M, C)
    g: torch.Tensor  # (M,)
    grid: torch.Tensor  # (M, GZ, GY, GX) density
    grid_w2l: torch.Tensor  # (M, 3, 4) local = A @ [p; 1]
    majorant: torch.Tensor  # (M,)


class SceneData(NamedTuple):
    tri: Triangles
    bsdf: BSDFParams
    emitter: EmitterParams
    # the sorted emitter kind codes present (:func:`emitter_kinds` of
    # ``emitter.kind``), known on the host
    emitter_kinds: tuple[int, ...]
    # the BSDF kinds present and two-sidedness (:func:`bsdf_kinds`)
    bsdf_kinds: BSDFKinds
    # chunked acceleration structure for scenes above ACCEL_MIN_TRIS
    # triangles (ops/accel.py); None for small scenes
    accel: Accel | None = None
    geom: GeomParams | None = None
    medium: MediumParams | None = None


def emitter_kinds(kind) -> tuple[int, ...]:
    """The sorted distinct codes of an emitter kind table (host array or
    tensor)."""
    return tuple(sorted({int(k) for k in kind.tolist()}))


def _has(sd: SceneData, code: int) -> bool:
    return code in sd.emitter_kinds


def _has_delta(sd: SceneData) -> bool:
    return _has(sd, EM_PROJECTOR) or _has(sd, EM_POINT)


def _has_shape(sd: SceneData) -> bool:
    return _has(sd, EM_AREA) or _has(sd, EM_ANGULAR_AREA)


def em_tri_key_table(tri_count: np.ndarray, cdf: np.ndarray) -> np.ndarray:
    """``EmitterParams.em_tri_key`` of an emitter table's ``tri_count``
    (E,) and ``em_tri_cdf`` (K,): each slot's owning emitter in the high
    32 bits and its CDF's float bits (non-negative, so ordered as the
    floats are) in the low ones."""
    owner = np.zeros(cdf.shape[0], np.int64)
    seg = np.repeat(np.arange(tri_count.shape[0]), tri_count)
    owner[:seg.shape[0]] = seg
    bits = np.ascontiguousarray(cdf, np.float32).view(np.int32)
    return (owner << 32) + bits.astype(np.int64)


def is_delta_kind(kind: torch.Tensor) -> torch.Tensor:
    return (kind == EM_PROJECTOR) | (kind == EM_POINT)


class GeomDelta(NamedTuple):
    """Per-lane rigid delta in Rodrigues vector form: a point moves as
    ``p + a w x (p - piv) + b w x (w x (p - piv)) + tr`` and a direction as
    the same without pivot and translation.  At zero deltas every added
    term is exactly zero, so the attach changes no primal bit."""

    w: torch.Tensor  # (N, 3) axis-angle
    a: torch.Tensor  # (N,) sin(t) / t
    b: torch.Tensor  # (N,) (1 - cos t) / t^2
    tr: torch.Tensor  # (N, 3)
    piv: torch.Tensor  # (N, 3)

    def point(self, p: torch.Tensor) -> torch.Tensor:
        c1 = cross(self.w, p - self.piv)
        c2 = cross(self.w, c1)
        return p + self.a[:, None] * c1 + self.b[:, None] * c2 + self.tr

    def vector(self, v: torch.Tensor) -> torch.Tensor:
        c1 = cross(self.w, v)
        c2 = cross(self.w, c1)
        return v + self.a[:, None] * c1 + self.b[:, None] * c2


def geom_delta_of(geom: GeomParams, shape_ids: torch.Tensor) -> GeomDelta:
    """The rigid deltas of shapes ``shape_ids`` (clamped at 0), lane by
    lane.  The angle is clamped at 1e-6 and small angles take the Taylor
    forms, so the gradient stays finite at zero."""
    idx = torch.clamp_min(shape_ids, 0)
    w = gather_rows(geom.rotate, idx)
    theta2 = dot(w, w)
    theta = sqrt(torch.clamp_min(theta2, 1e-12))
    cos_t, sin_t = cos_sin(theta)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - divide(theta2, 6.0), sin_t / theta)
    b = torch.where(small, 0.5 - divide(theta2, 24.0),
                    (1.0 - cos_t) / torch.clamp_min(theta2, 1e-12))
    return GeomDelta(w=w, a=a, b=b, tr=gather_rows(geom.translate, idx),
                     piv=geom.pivot.index_select(0, idx))


def primal_sd(sd: SceneData) -> SceneData:
    """Strip the geometry deltas for a primal render: there the attach
    costs work and changes no bit.  The differentiable renders that need
    gradients through hit points (full AD) keep them."""
    return sd._replace(geom=None) if sd.geom is not None else sd


# --------------------------------------------------------------------------
# Ray queries
# --------------------------------------------------------------------------

def ray_intersect(sd: SceneData, ray: Ray, active: torch.Tensor,
                  bvh_mode: str = BVH_MODE) -> SurfaceInteraction:
    """Closest hit + shading record (``mi.Scene.ray_intersect``).  The
    kernel's inputs are detached: the hit triangle is a discrete choice,
    and the kernels have no autograd.  Derivatives re-enter through the
    shading record, built from the tables (and, with ``sd.geom``, the hit
    distance re-derived from the moved triangle's plane), as the
    reference's attached ray_intersect (transientpath.py:148-151).
    ``bvh_mode`` is the traversal mode of scenes with an accel."""
    t, prim = _closest_hit_q(
        sd.tri.v0, sd.tri.e1, sd.tri.e2, ray.o.detach(), ray.d.detach(),
        ray.maxt.detach(), active, accel=sd.accel, bvh_mode=bvh_mode,
        table=sd.tri.table)
    return _si_from_t_prim(sd, ray, t, prim)


def _si_from_t_prim(sd: SceneData, ray: Ray, t, prim) -> SurfaceInteraction:
    """Shading record from a traversal result (t, prim).  With
    ``sd.geom`` the hit triangle moves by its shape's delta, and ``t``
    takes the derivative of the distance to the moved triangle's plane
    while its value stays the kernel's bit for bit."""
    valid = prim >= 0
    prim_c = torch.clamp_min(prim, 0)
    tri = sd.tri

    def row(a):
        return a.index_select(0, prim_c)

    v0, e1, e2, ng = row(tri.v0), row(tri.e1), row(tri.e2), row(tri.ng)
    if sd.geom is not None:
        gd = geom_delta_of(sd.geom, row(tri.shape_id))
        v0, e1, e2, ng = gd.point(v0), gd.vector(e1), gd.vector(e2), \
            gd.vector(ng)
        denom = dot(ray.d, ng)
        ok_den = torch.abs(denom) > 1e-12
        t_plane = dot(v0 - ray.o, ng) / torch.where(ok_den, denom, 1.0)
        # misses carry t = inf: keep them out of the arithmetic
        t_fin = torch.where(valid, t, 0.0)
        t_att = torch.where(ok_den & valid, t_plane, t_fin)
        t = torch.where(valid, replace_grad(t_fin, t_att), t)
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
    uv_e1, uv_e2 = row(tri.uv_e1), row(tri.uv_e2)
    uv = row(tri.uv0) + uv_e1 * u[:, None] + uv_e2 * v[:, None]
    # Flat shading: the shading normal is the geometric normal, unless a
    # bump or normal map perturbs it.
    n_sh = ng
    if sd.bsdf.bump_textures is not None:
        n_sh = _perturbed_normal(sd.bsdf, row(tri.bsdf_id), ng, uv, e1, e2,
                                 uv_e1, uv_e2)
    frame = Frame.from_normal(n_sh)
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


def atlas_lookup(atlas: torch.Tensor, tid: torch.Tensor, h: torch.Tensor,
                 w: torch.Tensor, tuv: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear 4-tap lookup with repeat wrapping in slot ``tid`` (N,) of a
    padded (NT, TH, TW, C) atlas, whose texture there is ``h`` x ``w``
    ((N,) f32, at least 1), at ``uv`` (N, 2) mapped by ``tuv`` (N, 4) =
    (su, sv, ou, ov).  Texel centres lie at (i + 0.5) / w.  -> (N, C)."""
    u = uv[:, 0] * tuv[:, 0] + tuv[:, 2]
    v = uv[:, 1] * tuv[:, 1] + tuv[:, 3]
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    nt, th, tw, C = atlas.shape
    flat = atlas.reshape(nt * th * tw, C)
    base = torch.clamp_min(tid, 0).to(torch.int64) * th

    def tap(xi, yi):
        # floor modulo (jnp.mod): the to_uv offsets give negative texels
        xi = torch.remainder(xi, w).to(torch.int64)
        yi = torch.remainder(yi, h).to(torch.int64)
        return gather_rows(flat, (base + yi) * tw + xi)

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1.0, y0)
    c01 = tap(x0, y0 + 1.0)
    c11 = tap(x0 + 1.0, y0 + 1.0)
    return ((c00 * (1.0 - fx) + c10 * fx) * (1.0 - fy)
            + (c01 * (1.0 - fx) + c11 * fx) * fy)


def _perturbed_normal(bp: BSDFParams, bsdf_id, ng, uv, e1, e2, uv_e1, uv_e2):
    """Bump- or normal-mapped shading normal (Mitsuba bumpmap.cpp /
    normalmap.cpp).  The tangents dp/du, dp/dv come from inverting the hit
    triangle's 2x2 uv-edge system; the height gradients were taken on the
    host in texel units, so one bilinear lookup gives them."""
    idx = torch.clamp_min(bsdf_id, 0)

    def col(a):
        return a.index_select(0, idx)

    bid = col(bp.bump_id)
    hw = col(bp.bump_hw)
    h = torch.clamp_min(hw[:, 0], 1.0)
    w = torch.clamp_min(hw[:, 1], 1.0)
    tuv = col(bp.bump_uv)
    val = atlas_lookup(bp.bump_textures, bid, h, w, tuv, uv)

    # uv-edge system -> world-space tangents
    u1, v1 = uv_e1[:, 0], uv_e1[:, 1]
    u2, v2 = uv_e2[:, 0], uv_e2[:, 1]
    det = u1 * v2 - v1 * u2
    ok_uv = torch.abs(det) > 1e-12
    inv = safe_div(1.0, det)[:, None]
    dp_du = (v2[:, None] * e1 - v1[:, None] * e2) * inv
    dp_dv = (u1[:, None] * e2 - u2[:, None] * e1) * inv
    # project the tangents into the surface plane (flat shading: n == ng)
    t_u = dp_du - ng * dot(ng, dp_du)[:, None]
    t_v = dp_dv - ng * dot(ng, dp_dv)[:, None]
    ok_uv = ok_uv & (dot(t_u, t_u) > 1e-16) & (dot(t_v, t_v) > 1e-16)

    # bump map: chain the texel-unit gradients through the uv transform and
    # the resolution to dh/du, dh/dv, then tilt the tangents
    scale = col(bp.bump_scale)
    dh_du = val[:, 1] * w * tuv[:, 0] * scale
    dh_dv = val[:, 2] * h * tuv[:, 1] * scale
    n_bump = cross(t_u + ng * dh_du[:, None], t_v + ng * dh_dv[:, None])
    # normal map: the tangent-space normal in an orthonormal (t_u, b, ng)
    tang = normalize(t_u)
    bitang = cross(ng, tang)
    n_nm = tang * val[:, 0:1] + bitang * val[:, 1:2] + ng * val[:, 2:3]
    n_new = torch.where((col(bp.bump_kind) == 2)[:, None], n_nm, n_bump)
    nn = dot(n_new, n_new)
    # orient with the geometric normal; fall back to ng where degenerate
    n_new = normalize(torch.where((nn > 1e-16)[:, None], n_new, ng))
    n_new = n_new * torch.where(dot(n_new, ng) < 0.0, -1.0, 1.0)[:, None]
    return torch.where(((bid >= 0) & ok_uv)[:, None], n_new, ng)


def ray_test(sd: SceneData, o: torch.Tensor, d_unit: torch.Tensor,
             dist: torch.Tensor, active: torch.Tensor,
             bvh_mode: str = BVH_MODE) -> torch.Tensor:
    """Occlusion between ``o`` and ``o + d_unit * dist`` (shadow ray), with
    the far end shortened by 0.1%; cf. ``mi.Scene.ray_test``."""
    maxt = dist * (1.0 - 1e-3)
    return _ray_test_q(sd.tri.v0, sd.tri.e1, sd.tri.e2, o.detach(),
                       d_unit.detach(), maxt.detach(), active, accel=sd.accel,
                       bvh_mode=bvh_mode, table=sd.tri.table)


# --------------------------------------------------------------------------
# Emitters
# --------------------------------------------------------------------------

def _sample_emitter_triangle(sd: SceneData, em_idx: torch.Tensor,
                             u: torch.Tensor):
    """Pick a triangle of emitter ``em_idx`` area-proportionally via the
    per-emitter CDF segment; returns (rescaled u, emitter-triangle slot).

    A binary search over ``em_tri_key``: the slot is the first of the
    segment whose CDF is not below ``u``, the slot that the JAX package's
    compare-and-count picks (the count of segment entries below ``u``)."""
    em = sd.emitter
    start = em.tri_start.index_select(0, em_idx)
    end = start + em.tri_count.index_select(0, em_idx)
    key = (em_idx.to(torch.int64) << 32) + u.contiguous().view(
        torch.int32).to(torch.int64)
    slot = torch.searchsorted(em.em_tri_key, key).to(torch.int32)
    # a delta emitter's empty segment gives end - 1 = start - 1: clamp it
    # into the table (its point is discarded)
    slot = torch.clamp_min(torch.minimum(torch.maximum(slot, start), end - 1),
                           0)
    cdf_prev = torch.cat([em.em_tri_cdf.new_zeros(1), em.em_tri_cdf[:-1]])
    cdf_lo = torch.where(slot > start, cdf_prev.index_select(0, slot), 0.0)
    pmf = torch.clamp_min(em.em_tri_cdf.index_select(0, slot) - cdf_lo, 1e-30)
    u2 = torch.clamp((u - cdf_lo) / pmf, 0.0, 1.0 - 1e-7)
    return u2, slot


def _uniform_triangle_point(sd: SceneData, slot: torch.Tensor,
                            u1: torch.Tensor, u2: torch.Tensor):
    """Uniform barycentric sample of emitter-triangle ``slot``, gathered
    from the compact per-emitter table.  With ``sd.geom`` the point and
    normal move by the emitter shape's delta, so that NEE carries the
    gradient of a moving light."""
    su = sqrt(torch.clamp_min(u1, 0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    em = sd.emitter
    p = (em.em_tri_v0.index_select(0, slot)
         + em.em_tri_e1.index_select(0, slot) * b1[:, None]
         + em.em_tri_e2.index_select(0, slot) * b2[:, None])
    ng = em.em_tri_ng.index_select(0, slot)
    if sd.geom is not None:
        gd = geom_delta_of(sd.geom, em.em_tri_shape.index_select(0, slot))
        p, ng = gd.point(p), gd.vector(ng)
    return p, ng


def sample_emitter_direction(
    sd: SceneData,
    ref_p: torch.Tensor,
    sample2: torch.Tensor,
    test_visibility: bool,
    active: torch.Tensor,
    bvh_mode: str = BVH_MODE,
):
    """Next-event estimation sample (``mi.Scene.sample_emitter_direction``).

    Returns (DirectionSample, em_weight (N, C)).  ``em_weight`` = emitter
    radiance / pdf with visibility applied; pdf includes the uniform 1/E
    emitter-selection probability.  A delta emitter (projector, point)
    gives its position with pdf 1 and ``delta`` set; an angulararea
    emitter is sampled as an area emitter.
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
    has_delta = _has_delta(sd)
    has_shape = _has_shape(sd)

    u_sel = sample2[:, 0]
    em_idx = torch.clamp_max((u_sel * E).to(torch.int32), E - 1)
    u0 = torch.clamp(u_sel * E - em_idx.to(torch.float32), 0.0, 1.0 - 1e-7)
    sel_pdf = 1.0 / E
    if has_delta:
        is_delta = is_delta_kind(em.kind.index_select(0, em_idx))
        p_delta = gather_rows(em.position, em_idx)
        n_delta = -em.direction.index_select(0, em_idx)
    else:
        is_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
    if has_shape:
        u0b, slot = _sample_emitter_triangle(sd, em_idx, u0)
        p, n_em = _uniform_triangle_point(sd, slot, u0b, sample2[:, 1])
        area = torch.clamp_min(em.area.index_select(0, em_idx), 1e-30)
        if has_delta:
            p = torch.where(is_delta[:, None], p_delta, p)
            n_em = torch.where(is_delta[:, None], n_delta, n_em)
    else:
        p, n_em = p_delta, n_delta

    d_vec = p - ref_p
    dist = sqrt(torch.clamp_min(dot(d_vec, d_vec), 1e-20))
    d = d_vec / dist[:, None]
    cos_em = dot(n_em, -d)
    # solid-angle pdf at ref: dist^2 / (cos * A) for an area emitter, 1 for
    # a delta emitter
    if has_shape:
        pdf = safe_div(dist * dist, torch.clamp_min(cos_em, 0.0) * area)
        if has_delta:
            pdf = torch.where(is_delta, 1.0, pdf)
        pdf = pdf * sel_pdf
    else:
        pdf = torch.full((n,), sel_pdf, dtype=torch.float32, device=dev)
    spec = emitter_eval_direction(sd, em_idx, p, n_em, d, dist, cos_em)

    valid = active & (pdf > 0.0) & (torch.abs(spec).sum(dim=-1) > 0.0)
    if test_visibility:
        o = ref_p + d * 1e-4  # offset along the connection
        occluded = ray_test(sd, o, d, dist - 2e-4, valid, bvh_mode)
        valid = valid & ~occluded

    weight = torch.where(valid[:, None], safe_div(spec, pdf[:, None]), 0.0)
    ds = DirectionSample(
        p=p, n=n_em, d=d, dist=dist,
        pdf=torch.where(valid, pdf, 0.0),
        delta=is_delta,
        emitter_id=torch.where(valid, em_idx, -1),
    )
    return ds, weight


def emitter_eval_direction(sd: SceneData, em_idx: torch.Tensor,
                           p: torch.Tensor, n_em: torch.Tensor,
                           d: torch.Tensor, dist: torch.Tensor,
                           cos_em: torch.Tensor) -> torch.Tensor:
    """Radiance leaving emitter point ``p`` toward a reference point that
    sees it along ``d`` at ``dist``: an area emitter's constant radiance
    from its front side (``cos_em > 0``); an angulararea emitter's, times
    a falloff that is 1 within the beam width and falls linearly to 0 at
    the cutoff angle; a projector's irradiance / dist^2 inside its
    frustum; a point's intensity / dist^2.  (N, C).  ``p`` and ``n_em``
    are unused by these kinds; they keep the JAX signature."""
    em = sd.emitter
    rad = gather_rows(em.radiance, em_idx)
    front = (cos_em > 0.0)[:, None]
    branches = []  # (kind code, value)
    if _has(sd, EM_AREA):
        branches.append((EM_AREA, torch.where(front, rad, 0.0)))
    if _has(sd, EM_ANGULAR_AREA):
        cb = em.cos_beam.index_select(0, em_idx)
        cc = em.cos_cutoff.index_select(0, em_idx)
        t_lin = safe_div(cos_em - cc, torch.clamp_min(cb - cc, 1e-9))
        falloff = torch.clamp(t_lin, 0.0, 1.0)
        branches.append((EM_ANGULAR_AREA,
                         torch.where(front, rad * falloff[:, None], 0.0)))
    if _has_delta(sd):
        inv_d2 = (1.0 / torch.clamp_min(dist * dist, 1e-20))[:, None]
    if _has(sd, EM_PROJECTOR):
        # the frame of the projector, seen from it toward the point
        v = -d
        z = dot(v, em.direction.index_select(0, em_idx))
        x = dot(v, em.frame_s.index_select(0, em_idx))
        y = dot(v, em.frame_t.index_select(0, em_idx))
        zt = z * em.tan_half_fov.index_select(0, em_idx)
        inside = (z > 0) & (torch.abs(x) <= zt) & (torch.abs(y) <= zt)
        branches.append((EM_PROJECTOR,
                         torch.where(inside[:, None], rad, 0.0) * inv_d2))
    if _has(sd, EM_POINT):
        branches.append((EM_POINT, rad * inv_d2))
    if len(branches) == 1:
        return branches[0][1]
    kind = em.kind.index_select(0, em_idx)
    val = torch.zeros_like(rad)
    for code, v_k in branches:
        val = torch.where((kind == code)[:, None], v_k, val)
    return val


def pdf_emitter_direction(sd: SceneData, ref_p: torch.Tensor,
                          si: SurfaceInteraction) -> torch.Tensor:
    """Solid-angle pdf of NEE having sampled the direction that hit ``si``
    (for MIS at emitter hits).  Zero for non-emitter hits, back faces and
    delta emitters."""
    E = sd.emitter.kind.shape[0]
    if E == 0 or not _has_shape(sd):
        return torch.zeros(ref_p.shape[:-1], dtype=torch.float32,
                           device=ref_p.device)
    em = si.emitter_id
    em_c = torch.clamp_min(em, 0)
    has_em = em >= 0
    if _has_delta(sd):
        has_em = has_em & ~is_delta_kind(sd.emitter.kind.index_select(0, em_c))
    area = torch.clamp_min(sd.emitter.area.index_select(0, em_c), 1e-30)
    d_vec = si.p - ref_p
    dist2 = dot(d_vec, d_vec)
    dist = sqrt(torch.clamp_min(dist2, 1e-20))
    d = d_vec / dist[:, None]
    cos_em = dot(si.n, -d)
    pdf = divide(safe_div(dist2, torch.clamp_min(cos_em, 0.0) * area), E)
    return torch.where(has_em & (cos_em > 0.0), pdf, 0.0)


def emitter_eval_hit(sd: SceneData, si: SurfaceInteraction,
                     ray_d: torch.Tensor) -> torch.Tensor:
    """Radiance emitted at a surface hit toward the viewer.  (N, C); zero
    for a delta emitter, which no ray hits."""
    E = sd.emitter.kind.shape[0]
    n = si.t.shape[0]
    if E == 0:
        return torch.zeros((n, sd.bsdf.reflectance.shape[-1]),
                           dtype=torch.float32, device=si.t.device)
    em = si.emitter_id
    em_c = torch.clamp_min(em, 0)
    cos_em = dot(si.n, -ray_d)
    val = emitter_eval_direction(sd, em_c, si.p, si.n, ray_d,
                                 torch.ones_like(cos_em), cos_em)
    has_em = em >= 0
    if _has_delta(sd):
        has_em = has_em & ~is_delta_kind(sd.emitter.kind.index_select(0, em_c))
    return torch.where(has_em[:, None], val, 0.0)
