"""Polarized (Mueller-matrix) BSDF factors (counterpart of
``mitransient_tpu/bsdf/polarized.py``).

Every scalar BSDF value f (which already holds the unpolarized Fresnel
average) is lifted to a Mueller matrix ``M = f * P``, where ``P`` is the
normalized polarization factor with ``P[0, 0] = 1``:

* conductor and rough conductor: the complex-IOR specular Mueller matrix
  of the s/p basis over its unpolarized average, rotated into the
  canonical Stokes bases of the world propagation directions;
* diffuse and rough plastic: the ideal depolarizer;
* dielectric: the real-IOR specular Mueller matrix in reflection, the
  depolarizer in transmission (an approximation, as in the JAX package);
* null: the identity.

Directions are those of the light: at a vertex with camera-ray direction
``d`` and light direction ``wo_world``, light comes in along
``-wo_world`` and leaves along ``-d``.  Stokes bases are the canonical
``stokes_basis`` of those world vectors, so consecutive vertices agree
along a shared segment and the throughput composes camera-first, beta' =
beta @ M.  Only the kinds the scene holds (``LaneBSDF.ks``) are computed,
as in ``bsdf/api.py``.  The structured forms (``*_soa``) return the
layout of ``core/mueller.py``: a matrix ``(4, 4, N, C)``, a Stokes column
``(4, N, C)``.
"""
from __future__ import annotations

import torch

from ..core.frame import coordinate_system
from ..core.math import cross, dot, normalize
from ..core.mueller import (
    msoa_to_dense,
    rotate_stokes_basis,
    rotator_angles,
    rotator_angles_unnorm,
    rotator_soa,
    specular_abcs,
    specular_sandwich_soa,
    stokes_basis,
)
from ..scene.scene import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR,
)
from .api import LaneBSDF


def _kinds(lb: LaneBSDF):
    ks = lb.ks
    return (ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR),
            ks.has(BSDF_DIELECTRIC), ks.has(BSDF_NULL))


def _is_conductor(lb: LaneBSDF) -> torch.Tensor:
    return (lb.kind == BSDF_CONDUCTOR) | (lb.kind == BSDF_ROUGH_CONDUCTOR)


def _plane_rotators(p_in, p_out, need_in=True):
    """(ci2, si2, co2, so2): the rotator angle pairs from the canonical
    Stokes bases into the s/p basis of the (p_in, p_out) plane of
    incidence and back.  The s-axis is the raw cross product (any positive
    scale serves :func:`rotator_angles_unnorm`), the canonical basis where
    the plane is degenerate."""
    sp = cross(p_in, p_out)
    degenerate = dot(sp, sp) < 1e-12
    sb_in = coordinate_system(p_in)[0]
    s_axis = torch.where(degenerate[:, None], sb_in, sp)
    ci2 = si2 = None
    if need_in:
        ci2, si2 = rotator_angles_unnorm(p_in, sb_in, s_axis)
    co2, so2 = rotator_angles_unnorm(p_out, s_axis,
                                     coordinate_system(p_out)[0])
    return ci2, si2, co2, so2


def _normalized_abcs(ci, eta_re, eta_im):
    """The s/p entries over the unpolarized average A: (1, B/A, C/A, S/A)."""
    A, B, C, S = specular_abcs(ci, eta_re, eta_im)
    inv_a = 1.0 / torch.clamp_min(A, 1e-12)
    return torch.ones_like(A), B * inv_a, C * inv_a, S * inv_a


def polarization_factor_soa(lb: LaneBSDF, p_in: torch.Tensor,
                            p_out: torch.Tensor, cos_theta_i: torch.Tensor,
                            transmitted: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The normalized polarization factor P, structured ``(4, 4, N, C)``.

    p_in (N, 3): light propagation into the surface; p_out: out of it;
    cos_theta_i (N,): the incidence cosine of the Fresnel term;
    transmitted (N,) bool: dielectric lanes that refract."""
    has_cond, has_diel, has_null = _kinds(lb)
    oo = torch.ones_like(lb.reflectance)
    zz = torch.zeros_like(lb.reflectance)
    depol = torch.stack([oo] + [zz] * 15).view(4, 4, *oo.shape)
    P = depol  # diffuse / rough plastic
    ci = torch.clamp(torch.abs(cos_theta_i), 1e-4, 1.0)
    if has_cond or has_diel:
        ci2, si2, co2, so2 = (a[:, None] for a in _plane_rotators(p_in,
                                                                  p_out))
    if has_cond:
        M = specular_sandwich_soa(
            *_normalized_abcs(ci[:, None] * oo, lb.eta_re, lb.eta_im),
            ci2, si2, co2, so2)
        P = torch.where(_is_conductor(lb)[:, None], M, P)
    if has_diel:
        eta_d = lb.eta_ratio[:, None] * oo
        M = specular_sandwich_soa(
            *_normalized_abcs(ci[:, None] * oo, eta_d,
                              torch.zeros_like(eta_d)),
            ci2, si2, co2, so2)
        if transmitted is not None:
            M = torch.where(transmitted[:, None], depol, M)
        P = torch.where((lb.kind == BSDF_DIELECTRIC)[:, None], M, P)
    if has_null:
        eye = torch.stack([oo if i == j else zz for i in range(4)
                           for j in range(4)]).view(4, 4, *oo.shape)
        P = torch.where((lb.kind == BSDF_NULL)[:, None], eye, P)
    return P


def polarization_factor(lb: LaneBSDF, p_in, p_out, cos_theta_i,
                        transmitted=None) -> torch.Tensor:
    """:func:`polarization_factor_soa` as a dense ``(N, 4, 4, C)``."""
    return msoa_to_dense(polarization_factor_soa(lb, p_in, p_out,
                                                 cos_theta_i, transmitted))


def polarization_factor_col0_soa(lb: LaneBSDF, p_in: torch.Tensor,
                                 p_out: torch.Tensor,
                                 cos_theta_i: torch.Tensor) -> torch.Tensor:
    """Column 0 of the polarization factor, ``(4, N, C)``: all an
    unpolarized source needs (NEE), [A, co2 B, -so2 B, 0] normalized by A
    for the conductors (R_in drops out against e0), e0 for every other
    kind."""
    has_cond, _has_diel, _has_null = _kinds(lb)
    oo = torch.ones_like(lb.reflectance)
    zz = torch.zeros_like(lb.reflectance)
    P0 = torch.stack([oo, zz, zz, zz])
    if has_cond:
        ci = torch.clamp(torch.abs(cos_theta_i), 1e-4, 1.0)
        _ci2, _si2, co2, so2 = _plane_rotators(p_in, p_out, need_in=False)
        A, B, _C, _S = specular_abcs(ci[:, None] * oo, lb.eta_re, lb.eta_im)
        Bn = B / torch.clamp_min(A, 1e-12)
        col = torch.stack([torch.ones_like(Bn), co2[:, None] * Bn,
                           -so2[:, None] * Bn, zz])
        P0 = torch.where(_is_conductor(lb)[:, None], col, P0)
    return P0


def polarization_factor_col0(lb: LaneBSDF, p_in, p_out,
                             cos_theta_i) -> torch.Tensor:
    """:func:`polarization_factor_col0_soa` as ``(N, 4, C)``."""
    return polarization_factor_col0_soa(lb, p_in, p_out,
                                        cos_theta_i).movedim(0, -2)


def specular_params_soa(lb: LaneBSDF, p_in: torch.Tensor,
                        p_out: torch.Tensor, cos_theta_i: torch.Tensor,
                        transmitted: torch.Tensor | None = None):
    """The per-lane parameters of the pending-rotator bounce update
    (``core/mueller.py``: ``msoa_apply_*``): (is_spec (N,) bool; A, B, C,
    S (N, C), the normalized s/p Fresnel entries; ci2, si2, co2, so2 (N,),
    the rotator angle pairs).  Lanes that are not specular (diffuse, rough
    plastic, null, refracting dielectric) get identity parameters; the
    caller treats the depolarizer and the identity by ``lb.kind``."""
    n = p_in.shape[0]
    has_cond, has_diel, _has_null = _kinds(lb)
    oo = torch.ones_like(lb.reflectance)
    zz = torch.zeros_like(lb.reflectance)
    is_spec = torch.zeros((n,), dtype=torch.bool, device=p_in.device)
    if not (has_cond or has_diel):
        on = torch.ones((n,), dtype=torch.float32, device=p_in.device)
        zn = torch.zeros_like(on)
        return is_spec, oo, zz, oo, zz, on, zn, on, zn
    ci = torch.clamp(torch.abs(cos_theta_i), 1e-4, 1.0)
    ci2, si2, co2, so2 = _plane_rotators(p_in, p_out)
    A, B, Cc, S = oo, zz, oo, zz
    lobes = []
    if has_cond:
        lobes.append((_is_conductor(lb), lb.eta_re, lb.eta_im))
    if has_diel:  # a real IOR; refracting lanes depolarize
        m = lb.kind == BSDF_DIELECTRIC
        if transmitted is not None:
            m = m & ~transmitted
        eta_d = lb.eta_ratio[:, None] * oo
        lobes.append((m, eta_d, torch.zeros_like(eta_d)))
    for m, eta_re, eta_im in lobes:
        Ak, Bk, Ck, Sk = specular_abcs(ci[:, None] * oo, eta_re, eta_im)
        inv_a = 1.0 / torch.clamp_min(Ak, 1e-12)
        mm = m[:, None]
        A = torch.where(mm, torch.ones_like(Ak), A)
        B = torch.where(mm, Bk * inv_a, B)
        Cc = torch.where(mm, Ck * inv_a, Cc)
        S = torch.where(mm, Sk * inv_a, S)
        is_spec = is_spec | m
    return is_spec, A, B, Cc, S, ci2, si2, co2, so2


def _sensor_bases(ray_d: torch.Tensor, vertical: torch.Tensor):
    """The light's propagation at the sensor (-d), its canonical Stokes
    basis and the camera's horizontal axis cross(d, vertical)."""
    w = -ray_d
    return w, stokes_basis(w), normalize(cross(ray_d,
                                               vertical.expand_as(ray_d)))


def sensor_alignment_angles(ray_d: torch.Tensor, vertical: torch.Tensor):
    """(cos 2t, sin 2t) of the sensor-alignment rotator (the reference's
    beta init, utils.py:9-21): the pending rotator of a fresh path, whose
    stored beta is the identity."""
    return rotator_angles(*_sensor_bases(ray_d, vertical))


def sensor_alignment_soa(ray_d: torch.Tensor, vertical: torch.Tensor,
                         C: int) -> torch.Tensor:
    """The sensor-alignment rotator, structured ``(4, 4, N, C)``."""
    c2, s2 = sensor_alignment_angles(ray_d, vertical)
    n = ray_d.shape[0]
    return rotator_soa(c2, s2)[..., None].expand(4, 4, n, C).contiguous()


def sensor_alignment_mueller(ray_d: torch.Tensor,
                             vertical: torch.Tensor) -> torch.Tensor:
    """The sensor-alignment rotator ``(N, 4, 4)``: from the canonical
    Stokes basis of the light reaching the sensor to the camera's
    horizontal axis."""
    return rotate_stokes_basis(*_sensor_bases(ray_d, vertical))
