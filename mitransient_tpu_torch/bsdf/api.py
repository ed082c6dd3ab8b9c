"""BSDF evaluation and sampling over the loaded BSDF table.

Counterpart of ``mitransient_tpu/bsdf/api.py``.  Every BSDF kind the
scene holds is evaluated densely for all lanes and the lane's kind picks
the result; the lobes of kinds the scene lacks (``SceneData.bsdf_kinds``,
carried on each :class:`LaneBSDF`) are not computed, and neither are the
table columns only they read.  A diffuse-only scene runs the diffuse lobe
alone.

Conventions (matching Mitsuba): directions are in the local shading frame,
+z = normal, pointing away from the surface; ``wi`` is toward the viewer.
``eval_pdf`` returns f * |cos_theta_o| of the smooth lobes and excludes
delta lobes; ``sample`` returns weight = f * |cos| / pdf (delta lobes:
weight = F).  A two-sided BSDF mirrors the frame where ``wi.z < 0``
(Mitsuba's ``twosided`` wrapper).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import trace
from ..core.math import (
    cos_sin,
    cross,
    divide,
    dot,
    norm,
    safe_div,
    safe_rcp,
    sqrt,
    stable_normalize,
)
from ..core.records import BSDFSample
from ..ops.gather import gather_rows
from ..core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from ..scene.scene import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_PLASTIC,
    BSDFKinds,
    BSDFParams,
    atlas_lookup,
)
from .fresnel import fresnel_conductor, fresnel_dielectric

# the BSDF table's columns by the kinds that read them (two_sided is read
# when the table has a two-sided row)
_COLUMNS = (
    ("eta_re", (BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR)),
    ("eta_im", (BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR)),
    ("alpha", (BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_PLASTIC)),
    ("eta_ratio", (BSDF_DIELECTRIC, BSDF_ROUGH_PLASTIC)),
    ("alpha_v", (BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_PLASTIC)),
)
# the columns that are DiffParams tables (read through ops.gather)
_PARAM_COLUMNS = ("reflectance", "alpha", "alpha_v")


class LaneBSDF(NamedTuple):
    """Per-lane gathered BSDF parameters; a column no present kind reads
    is None."""

    kind: torch.Tensor  # (N,) int32, -1 for lanes without a hit
    reflectance: torch.Tensor  # (N, C)
    two_sided: torch.Tensor | None = None  # (N,) bool
    eta_re: torch.Tensor | None = None  # (N, C)
    eta_im: torch.Tensor | None = None  # (N, C)
    alpha: torch.Tensor | None = None  # (N,) GGX alpha_u (tangent)
    eta_ratio: torch.Tensor | None = None  # (N,)
    alpha_v: torch.Tensor | None = None  # (N,) GGX alpha_v (bitangent)
    ks: BSDFKinds = BSDFKinds()


def gather_lane_bsdf(bp: BSDFParams, bsdf_id: torch.Tensor,
                     uv: torch.Tensor | None = None,
                     ks: BSDFKinds = BSDFKinds()) -> LaneBSDF:
    """Per-lane BSDF parameter gather for a table holding ``ks``.  Pass the
    hit ``uv`` to resolve textured reflectance; a table without textures
    skips the lookup."""
    i = torch.clamp_min(bsdf_id, 0)

    def col(name):
        a = getattr(bp, name)
        # the parameter tables' gradients add in a fixed order (K8)
        return (gather_rows(a, i) if name in _PARAM_COLUMNS
                else a.index_select(0, i))

    cols = {name: col(name) for name, kinds in _COLUMNS
            if any(ks.has(k) for k in kinds)}
    if ks.any_two_sided:
        cols["two_sided"] = col("two_sided")
    refl = col("reflectance")
    if uv is not None and bp.textures is not None:
        refl = _apply_texture(bp, i, refl, uv)
    return LaneBSDF(kind=torch.where(bsdf_id >= 0, col("kind"), -1),
                    reflectance=refl, ks=ks, **cols)


def map_lanes(lb: LaneBSDF, fn) -> LaneBSDF:
    """``lb`` with ``fn`` applied to each of its per-lane tensors."""
    return lb._replace(**{f: fn(getattr(lb, f)) for f in LaneBSDF._fields
                          if isinstance(getattr(lb, f), torch.Tensor)})


def _apply_texture(bp: BSDFParams, idx: torch.Tensor, refl: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Reflectance of textured lanes: a bilinear 4-tap atlas lookup with
    repeat wrapping (Mitsuba's bitmap defaults: wrap_mode=repeat,
    filter_type=bilinear).  Every lane is looked up, textured or not: the
    span ``mitr:texture`` and the counters ``texture.lookups`` (the lanes)
    and ``texture.textured`` (those with a texture) measure that where the
    lookup runs eagerly; a captured pass counts nothing, so that its graph
    holds no work of the counters."""
    with trace.span("mitr:texture"):
        tid = bp.tex_id.index_select(0, idx)
        textured = tid >= 0
        if trace.recording():
            trace.count("texture.lookups", idx.shape[0])
            trace.count("texture.textured", textured)
        hw = bp.tex_hw.index_select(0, idx)
        val = atlas_lookup(bp.textures, tid, torch.clamp_min(hw[:, 0], 1.0),
                           torch.clamp_min(hw[:, 1], 1.0),
                           bp.tex_uv.index_select(0, idx), uv)
        return torch.where(textured[:, None], val, refl)


def _fdr(eta):
    """Average internal diffuse Fresnel reflectance (the Egan & Hilgeman
    fit for eta > 1 that Mitsuba's plastic uses)."""
    e2 = eta * eta
    return -1.4399 / e2 + 0.7099 / eta + 0.6681 + 0.0636 * eta


def _kind_mask(lb: LaneBSDF, codes) -> torch.Tensor:
    """Lanes whose kind is one of ``codes``, comparing only the kinds the
    table holds."""
    masks = [lb.kind == code for code in codes if lb.ks.has(code)]
    if not masks:
        return torch.zeros_like(lb.kind, dtype=torch.bool)
    for m in masks[1:]:
        masks[0] = masks[0] | m
    return masks[0]


def _pick(lobes, masks):
    """Per lane, the value of the lobe whose mask holds (0 where none
    does): ``lobes`` is a list of value tuples, ``masks`` their (N,)
    masks."""
    out = None
    for mask, vals in zip(masks, lobes):
        out = tuple(torch.where(mask if v.dim() == 1 else mask[:, None], v,
                                0.0 if o is None else o)
                    for v, o in zip(vals, out or (None,) * len(vals)))
    return out


def is_smooth(lb: LaneBSDF) -> torch.Tensor:
    """Lanes whose BSDF has a non-delta component (NEE applies)."""
    return _kind_mask(lb, (BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR,
                           BSDF_ROUGH_PLASTIC))


def is_null(lb: LaneBSDF) -> torch.Tensor:
    return lb.kind == BSDF_NULL


def _maybe_flip(lb: LaneBSDF, wi: torch.Tensor):
    """Two-sided handling: the z sign (N,) that mirrors lanes whose ``wi``
    lies below a two-sided surface, or None where the table has no
    two-sided row."""
    if not lb.ks.any_two_sided:
        return None
    return torch.where(lb.two_sided & (wi[:, 2] < 0.0), -1.0, 1.0)


def _flip_z(v: torch.Tensor, sgn):
    if sgn is None:
        return v
    return torch.stack([v[:, 0], v[:, 1], v[:, 2] * sgn], dim=-1)


# --------------------------------------------------------------------------
# GGX microfacet helpers (anisotropic Trowbridge-Reitz, Smith separable,
# visible-normal sampling); alpha_u / alpha_v are the tangent / bitangent
# roughnesses, equal for an isotropic lobe
# --------------------------------------------------------------------------

GGX_ALPHA_MIN = 1e-4  # roughness floor: keeps the GGX chain finite on lanes
# whose row carries alpha = 0 (non-GGX kinds evaluated by the dense dispatch)


def _ggx_ndf(m: torch.Tensor, au: torch.Tensor,
             av: torch.Tensor) -> torch.Tensor:
    """D(m) = 1 / (pi au av ((x/au)^2 + (y/av)^2 + z^2)^2), m.z > 0."""
    au = torch.clamp_min(au, GGX_ALPHA_MIN)
    av = torch.clamp_min(av, GGX_ALPHA_MIN)
    cz = torch.clamp_min(m[:, 2], 0.0)
    sx = safe_div(m[:, 0], au)
    sy = safe_div(m[:, 1], av)
    denom = sx * sx + sy * sy + cz * cz
    return safe_div(1.0, math.pi * au * av * denom * denom) * (cz > 0.0)


def _ggx_g1(v: torch.Tensor, au: torch.Tensor,
            av: torch.Tensor) -> torch.Tensor:
    """Smith masking with direction-dependent projected roughness:
    G1 = 2 / (1 + sqrt(1 + (au^2 x^2 + av^2 y^2) / z^2))."""
    au = torch.clamp_min(au, GGX_ALPHA_MIN)
    av = torch.clamp_min(av, GGX_ALPHA_MIN)
    cz = v[:, 2]
    a2t2 = safe_div(au * au * (v[:, 0] * v[:, 0])
                    + av * av * (v[:, 1] * v[:, 1]), cz * cz)
    return safe_div(2.0, 1.0 + sqrt(1.0 + a2t2))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(norm(v), 1e-12)[:, None]


def _axis(like: torch.Tensor, k: int) -> torch.Tensor:
    """The unit vector along axis ``k``, (3,), made on ``like``'s device:
    no upload from the host, which a CUDA graph capture refuses."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[k]


def _ggx_sample_vndf(wi: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Heitz 2018 visible-normal sampling; ``wi`` must have wi.z > 0."""
    au = torch.clamp_min(au, GGX_ALPHA_MIN)
    av = torch.clamp_min(av, GGX_ALPHA_MIN)
    vh = _unit(torch.stack([au * wi[:, 0], av * wi[:, 1], wi[:, 2]], dim=-1))
    lensq = vh[:, 0] * vh[:, 0] + vh[:, 1] * vh[:, 1]
    inv_len = safe_rcp(sqrt(torch.clamp_min(lensq, 1e-20)))
    t1 = torch.where(
        (lensq > 1e-12)[:, None],
        torch.stack([-vh[:, 1] * inv_len, vh[:, 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        _axis(vh, 0))
    t2 = cross(vh, t1)
    r = sqrt(torch.clamp_min(u[:, 0], 0.0))
    phi = 2.0 * math.pi * u[:, 1]
    c, s = cos_sin(phi)
    p1 = r * c
    p2 = r * s
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = ((1.0 - s) * sqrt(torch.clamp_min(1.0 - p1 * p1, 1e-12))
          + s * p2)
    p3 = sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 1e-12))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + p3[:, None] * vh
    return _unit(torch.stack([au * nh[:, 0], av * nh[:, 1],
                              torch.clamp_min(nh[:, 2], 1e-6)], dim=-1))


def _reflect(wi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return 2.0 * dot(wi, m)[:, None] * m - wi


def _plastic_diffuse(lb: LaneBSDF, Fi, Fo, co):
    """The rough plastic's diffuse substrate term f * cos (N, C)."""
    inv_eta2 = 1.0 / (lb.eta_ratio * lb.eta_ratio)
    fdr = _fdr(lb.eta_ratio)
    return lb.reflectance * ((1.0 - Fi) * (1.0 - Fo) * inv_eta2
                             / (math.pi * (1.0 - fdr)) * co)[:, None]


# --------------------------------------------------------------------------
# eval_pdf: the smooth lobes (diffuse, rough conductor, rough plastic)
# --------------------------------------------------------------------------

def eval_pdf(lb: LaneBSDF, wi: torch.Tensor, wo: torch.Tensor,
             active: torch.Tensor):
    """Returns (f*cos (N, C), pdf (N,)) of the smooth component."""
    ks = lb.ks
    has_diff = ks.has(BSDF_DIFFUSE)
    has_rough = ks.has(BSDF_ROUGH_CONDUCTOR)
    has_plast = ks.has(BSDF_ROUGH_PLASTIC)

    sgn = _maybe_flip(lb, wi)
    wi_l = _flip_z(wi, sgn)
    wo_l = _flip_z(wo, sgn)
    ci = wi_l[:, 2]
    co = wo_l[:, 2]
    ok = active & (ci > 0.0) & (co > 0.0)

    lobes = []  # (mask, f, pdf) per present smooth kind
    if has_diff or has_plast:
        pdf_diff = square_to_cosine_hemisphere_pdf(wo_l)
    if has_diff:
        f_diff = lb.reflectance * divide(co, math.pi)[:, None]
        lobes.append((lb.kind == BSDF_DIFFUSE, f_diff, pdf_diff))

    if has_rough or has_plast:
        m = stable_normalize(wi_l + wo_l)
        d_ndf = _ggx_ndf(m, lb.alpha, lb.alpha_v)
        g1_i = _ggx_g1(wi_l, lb.alpha, lb.alpha_v)
        g = g1_i * _ggx_g1(wo_l, lb.alpha, lb.alpha_v)
        # VNDF pdf in wo measure: G1 D (wi.m) / wi.z / (4 wi.m)
        pdf_rough = safe_div(g1_i * d_ndf, 4.0 * ci)
    if has_rough:
        F = fresnel_conductor(dot(wi_l, m), lb.eta_re, lb.eta_im)
        f_rough = lb.reflectance * F * safe_div(d_ndf * g, 4.0 * ci)[:, None]
        lobes.append((lb.kind == BSDF_ROUGH_CONDUCTOR, f_rough, pdf_rough))
    if has_plast:
        # GGX dielectric coating over a diffuse substrate (Mitsuba
        # roughplastic with nonlinear=false)
        Fi = fresnel_dielectric(ci, lb.eta_ratio)[0]
        Fo = fresnel_dielectric(co, lb.eta_ratio)[0]
        F_sp = fresnel_dielectric(dot(wi_l, m), lb.eta_ratio)[0]
        f_pl_spec = F_sp * safe_div(d_ndf * g, 4.0 * ci)
        f_plastic = (_plastic_diffuse(lb, Fi, Fo, co)
                     + f_pl_spec[:, None])
        pdf_plastic = Fi * pdf_rough + (1.0 - Fi) * pdf_diff
        lobes.append((lb.kind == BSDF_ROUGH_PLASTIC, f_plastic, pdf_plastic))

    if not lobes:
        return torch.zeros_like(lb.reflectance), torch.zeros_like(ci)
    return _pick([(f_k, pdf_k) for _, f_k, pdf_k in lobes],
                 [ok & mask for mask, _, _ in lobes])


# --------------------------------------------------------------------------
# sample
# --------------------------------------------------------------------------

def sample(lb: LaneBSDF, wi: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
           active: torch.Tensor) -> BSDFSample:
    """Sample an outgoing direction per lane.  Every kind takes the same
    draws: ``u1`` picks the dielectric's reflection or refraction and the
    plastic's lobe, ``u2`` the direction."""
    ks = lb.ks
    has_diff = ks.has(BSDF_DIFFUSE)
    has_mirr = ks.has(BSDF_CONDUCTOR)
    has_rough = ks.has(BSDF_ROUGH_CONDUCTOR)
    has_diel = ks.has(BSDF_DIELECTRIC)
    has_null = ks.has(BSDF_NULL)
    has_plast = ks.has(BSDF_ROUGH_PLASTIC)

    ones = torch.ones_like(wi[:, 0])
    if has_diel or has_null:
        spec_ones = torch.ones_like(lb.reflectance)
    sgn = _maybe_flip(lb, wi)
    wi_l = _flip_z(wi, sgn)
    ci = wi_l[:, 2]

    lobes = []  # (mask, wo, weight, pdf) per present kind

    if has_diff or has_plast:
        wo_diff = square_to_cosine_hemisphere(u2)
        pdf_diff = square_to_cosine_hemisphere_pdf(wo_diff)
    if has_diff:
        lobes.append((lb.kind == BSDF_DIFFUSE, wo_diff, lb.reflectance,
                      pdf_diff))

    if has_mirr:
        # smooth conductor: the mirror direction, weight F
        wo_mirr = torch.stack([-wi_l[:, 0], -wi_l[:, 1], wi_l[:, 2]], dim=-1)
        F_cond = torch.where((lb.eta_im > 0.0) | (lb.eta_re > 0.0),
                             fresnel_conductor(ci, lb.eta_re, lb.eta_im), 1.0)
        lobes.append((lb.kind == BSDF_CONDUCTOR, wo_mirr,
                      lb.reflectance * F_cond, ones))

    if has_rough or has_plast:
        # GGX VNDF microfacet sample, shared by the rough conductor and
        # the plastic; lanes with wi.z <= 0 sample about +z (masked later)
        wi_v = torch.where((wi_l[:, 2] > 1e-6)[:, None], wi_l,
                           _axis(wi_l, 2))
        m = _ggx_sample_vndf(wi_v, lb.alpha, lb.alpha_v, u2)
        wo_rough = _reflect(wi_l, m)
        d_ndf = _ggx_ndf(m, lb.alpha, lb.alpha_v)
        g1_i = _ggx_g1(wi_l, lb.alpha, lb.alpha_v)
        pdf_rough = safe_div(g1_i * d_ndf, 4.0 * ci)

    if has_rough:
        F_r = fresnel_conductor(dot(wi_l, m), lb.eta_re, lb.eta_im)
        # weight = f*cos/pdf = F G2 / G1(wi)
        g2 = g1_i * _ggx_g1(wo_rough, lb.alpha, lb.alpha_v)
        w_rough = lb.reflectance * F_r * safe_div(g2, g1_i)[:, None]
        rough_ok = (wo_rough[:, 2] > 0.0) & (pdf_rough > 0.0)
        w_rough = torch.where(rough_ok[:, None], w_rough, 0.0)
        lobes.append((lb.kind == BSDF_ROUGH_CONDUCTOR, wo_rough, w_rough,
                      pdf_rough))

    is_diel = lb.kind == BSDF_DIELECTRIC
    if has_diel:
        # dielectric: Fresnel-weighted reflection or refraction, in the
        # true frame (it is two-sided by nature)
        Fd, cos_t, eta_it, eta_ti = fresnel_dielectric(wi[:, 2], lb.eta_ratio)
        refl = u1 < Fd
        wo_refl = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], dim=-1)
        wo_refr = torch.stack([-wi[:, 0] * eta_ti, -wi[:, 1] * eta_ti, cos_t],
                              dim=-1)
        wo_diel = torch.where(refl[:, None], wo_refl, wo_refr)
        # transmission scales radiance by 1/eta_it^2 (solid-angle
        # compression)
        w_diel = torch.where(refl[:, None], spec_ones,
                             (eta_ti * eta_ti)[:, None] * spec_ones)
        eta_diel = torch.where(refl, 1.0, eta_it)
        pdf_diel = torch.where(refl, Fd, 1.0 - Fd)
        lobes.append((is_diel, wo_diel, w_diel, pdf_diel))

    if has_null:
        lobes.append((lb.kind == BSDF_NULL, -wi, spec_ones, ones))

    if has_plast:
        # rough plastic: a Fresnel-weighted pick of the coating or the
        # substrate; weight = f*cos/pdf of the whole BSDF
        Fi_pl = fresnel_dielectric(ci, lb.eta_ratio)[0]
        pick_spec = u1 < Fi_pl
        wo_plast = torch.where(pick_spec[:, None], wo_rough, wo_diff)
        co_pl = wo_plast[:, 2]
        m_pl = stable_normalize(wi_l + wo_plast)
        d_pl = _ggx_ndf(m_pl, lb.alpha, lb.alpha_v)
        g_pl = (_ggx_g1(wi_l, lb.alpha, lb.alpha_v)
                * _ggx_g1(wo_plast, lb.alpha, lb.alpha_v))
        F_sp_pl = fresnel_dielectric(dot(wi_l, m_pl), lb.eta_ratio)[0]
        Fo_pl = fresnel_dielectric(co_pl, lb.eta_ratio)[0]
        f_plast = (_plastic_diffuse(lb, Fi_pl, Fo_pl, co_pl)
                   + (F_sp_pl * safe_div(d_pl * g_pl, 4.0 * ci))[:, None])
        pdf_vndf_pl = safe_div(
            _ggx_g1(wi_l, lb.alpha, lb.alpha_v) * d_pl, 4.0 * ci)
        pdf_plast = (Fi_pl * pdf_vndf_pl
                     + (1.0 - Fi_pl)
                     * square_to_cosine_hemisphere_pdf(wo_plast))
        plast_ok = (co_pl > 0.0) & (pdf_plast > 1e-9)
        w_plast = torch.where(
            plast_ok[:, None],
            f_plast / torch.clamp_min(pdf_plast, 1e-9)[:, None], 0.0)
        lobes.append((lb.kind == BSDF_ROUGH_PLASTIC, wo_plast, w_plast,
                      pdf_plast))

    # kinds that sample the (possibly flipped) local upper hemisphere
    up_mask = _kind_mask(lb, (BSDF_DIFFUSE, BSDF_CONDUCTOR,
                              BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_PLASTIC))
    lane_ok = active & (~up_mask | (ci > 0.0))
    wo_l, weight, pdf = _pick([lobe[1:] for lobe in lobes],
                              [lobe[0] for lobe in lobes])
    eta = torch.where(is_diel, eta_diel, 1.0) if has_diel else ones
    delta = _kind_mask(lb, (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_NULL))

    ok = lane_ok & (pdf > 0.0) & (weight != 0.0).any(dim=-1)
    weight = torch.where(ok[:, None], weight, 0.0)
    # un-flip wo of two-sided lanes (the dielectric and null lobes are in
    # the true frame already)
    wo = wo_l if sgn is None else _flip_z(wo_l, torch.where(up_mask, sgn, 1.0))
    return BSDFSample(wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=eta,
                      delta=delta, weight=weight)
