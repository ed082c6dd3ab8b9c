"""Mueller / Stokes polarization algebra (counterpart of
``mitransient_tpu/core/mueller.py``).

Conventions follow Mitsuba 3: a Stokes vector is expressed against a basis
vector perpendicular to its propagation direction ``w``; Mueller matrices
act on Stokes vectors from the left.

Two layouts:

* dense: a polarized spectrum ``(..., 4, 4, C)`` (``core/spectrum.py``),
  a rotator ``(..., 4, 4)``;
* structured ("SoA", the ``msoa_*`` and ``stokes_*`` functions): a Mueller
  matrix is one tensor ``(4, 4, ...)`` whose entry ``[i, j]`` holds
  element (i, j) of every lane, and a Stokes vector one tensor ``(4,
  ...)``.  The JAX package holds the same entries as a tuple of 16 arrays
  (a TPU layout rule); here each operation runs on a whole row or column
  of entries at once, with the same operations in the same order per
  element, so the results round as the JAX package's do.

Square roots, cosines and divisions by a Python number go through
``core/math.py``, so that the card and the CPU round alike.
"""
from __future__ import annotations

import torch

from .frame import coordinate_system
from .math import cos_sin, cross, dot, normalize, sqrt


def _mat4(rows) -> torch.Tensor:
    """Stack 4 x 4 same-shape tensors into ``(..., 4, 4)``."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _soa4(rows) -> torch.Tensor:
    """Stack 4 x 4 same-shape tensors into the structured ``(4, 4, ...)``."""
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def stokes_basis(w: torch.Tensor) -> torch.Tensor:
    """Canonical basis vector perpendicular to propagation direction ``w``."""
    s, _t = coordinate_system(normalize(w))
    return s


def _rotator(theta: torch.Tensor) -> torch.Tensor:
    """Mueller rotator matrix R(theta) of shape (..., 4, 4)."""
    c, s = cos_sin(2.0 * theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat4([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def unit_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between unit vectors (through float64, alike on every
    device)."""
    d = torch.clamp(dot(a, b), -1.0, 1.0)
    return torch.acos(d.double()).to(d.dtype)


def rotator_angles(w, basis_current, basis_target):
    """(cos 2t, sin 2t) of the rotator re-expressing Stokes vectors from
    ``basis_current`` to ``basis_target`` (both perpendicular to ``w``):
    with c = a.b and the signed s = w.(a x b), cos 2t = 2c^2 - 1 and
    sin 2t = 2cs, with no trigonometric function."""
    a = normalize(basis_current)
    b = normalize(basis_target)
    c = torch.clamp(dot(a, b), -1.0, 1.0)
    s = dot(w, cross(a, b))
    return 2.0 * c * c - 1.0, 2.0 * c * s


def rotator_angles_unnorm(w, f1, f2):
    """:func:`rotator_angles` for basis vectors ``f1``, ``f2`` of any
    positive scale (``w`` unit): with d = f1.f2 and x = w.(f1 x f2),
    cos 2t = (d^2 - x^2) / (d^2 + x^2) and sin 2t = 2dx / (d^2 + x^2)."""
    d = dot(f1, f2)
    x = dot(w, cross(f1, f2))
    d2 = d * d
    x2 = x * x
    inv = 1.0 / torch.clamp_min(d2 + x2, 1e-30)
    return (d2 - x2) * inv, 2.0 * d * x * inv


def rotate_stokes_basis(w: torch.Tensor, basis_current: torch.Tensor,
                        basis_target: torch.Tensor) -> torch.Tensor:
    """Mueller rotator ``(..., 4, 4)`` re-expressing Stokes vectors from
    ``basis_current`` to ``basis_target`` (both perpendicular to ``w``)."""
    c2, s2 = rotator_angles(w, basis_current, basis_target)
    z, o = torch.zeros_like(c2), torch.ones_like(c2)
    return _mat4([[o, z, z, z], [z, c2, s2, z], [z, -s2, c2, z],
                  [z, z, z, o]])


def rotate_mueller_basis(M, in_w, in_basis_current, in_basis_target, out_w,
                         out_basis_current, out_basis_target):
    """Express the Mueller matrix ``M`` (..., 4, 4), defined against the
    'current' input and output bases, in the 'target' bases:
    ``R_out @ M @ R_in^-1``, R rotating current -> target."""
    r_in = rotate_stokes_basis(in_w, in_basis_current, in_basis_target)
    r_out = rotate_stokes_basis(out_w, out_basis_current, out_basis_target)
    return r_out @ M @ r_in.transpose(-1, -2)  # a rotator's inverse


def mueller_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-channel Mueller product ``a @ b`` of spectra ``(..., 4, 4, C)``:
    each element the sum over k = 0..3 of a[i, k] b[k, j], in that order."""
    rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            s = a[..., i, 0, :] * b[..., 0, j, :]
            for k in range(1, 4):
                s = s + a[..., i, k, :] * b[..., k, j, :]
            cols.append(s)
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)


def rotate_mueller_product(r_out: torch.Tensor, M: torch.Tensor,
                           r_in: torch.Tensor) -> torch.Tensor:
    """``r_out (..., 4, 4) @ M (..., 4, 4, C) @ r_in (..., 4, 4)``."""
    t = mueller_product(M, r_in[..., None])
    return mueller_product(r_out[..., None], t)


def linear_polarizer(transmission: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(transmission)
    h = 0.5 * transmission
    return _mat4([[h, h, z, z], [h, h, z, z], [z, z, z, z], [z, z, z, z]])


def specular_abcs(cos_theta_i: torch.Tensor, eta_re: torch.Tensor,
                  eta_im: torch.Tensor):
    """The four independent entries (A, B, C, S) of the s/p-basis specular
    Mueller matrix [[A,B,0,0],[B,A,0,0],[0,0,C,S],[0,0,-S,C]] of a surface
    of complex index of refraction eta_re + i eta_im."""
    ci = torch.clamp(torch.abs(cos_theta_i), 1e-6, 1.0)
    si2 = 1.0 - ci * ci
    eta2_re = eta_re * eta_re - eta_im * eta_im
    eta2_im = 2.0 * eta_re * eta_im
    # t = eta^2 - sin^2(theta), complex square root
    t_re = eta2_re - si2
    t_im = eta2_im
    mag = sqrt(t_re * t_re + t_im * t_im)
    ct_re = sqrt(torch.clamp_min((mag + t_re) * 0.5, 0.0))
    ct_im = (torch.sign(t_im + 1e-30)
             * sqrt(torch.clamp_min((mag - t_re) * 0.5, 0.0)))

    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    # r_s = (ci - ct) / (ci + ct); r_p = (eta^2 ci - ct) / (eta^2 ci + ct)
    rs_re, rs_im = cdiv(ci - ct_re, -ct_im, ci + ct_re, ct_im)
    a_re, a_im = eta2_re * ci, eta2_im * ci
    rp_re, rp_im = cdiv(a_re - ct_re, a_im - ct_im, a_re + ct_re,
                        a_im + ct_im)
    Rs = rs_re * rs_re + rs_im * rs_im
    Rp = rp_re * rp_re + rp_im * rp_im
    # the relative phase
    cr = rs_re * rp_re + rs_im * rp_im
    cri = rs_im * rp_re - rs_re * rp_im
    amp = sqrt(torch.clamp_min(Rs * Rp, 0.0))
    denom = sqrt(cr * cr + cri * cri) + 1e-30
    cos_d = cr / denom
    sin_d = cri / denom
    return 0.5 * (Rs + Rp), 0.5 * (Rs - Rp), amp * cos_d, amp * sin_d


def specular_reflection_mueller(cos_theta_i, eta_re, eta_im) -> torch.Tensor:
    """The s/p-basis Mueller matrix ``(..., 4, 4)`` of specular reflection
    (the polarized Fresnel term of the conductors)."""
    A, B, C, S = specular_abcs(cos_theta_i, eta_re, eta_im)
    z = torch.zeros_like(A)
    return _mat4([[A, B, z, z], [B, A, z, z], [z, z, C, S], [z, z, -S, C]])


def depolarizer(value: torch.Tensor) -> torch.Tensor:
    """Ideal depolarizer ``(..., 4, 4)`` scaled by ``value``: only element
    [0, 0] is non-zero (how an unpolarized BSDF value is lifted)."""
    z = torch.zeros_like(value)
    return _mat4([[value, z, z, z], [z, z, z, z], [z, z, z, z],
                  [z, z, z, z]])


def specular_sandwich(A, B, C, S, ci2, si2, co2, so2) -> torch.Tensor:
    """Closed form of ``R_out @ F @ R_in`` for the specular Mueller F
    between rotators (cos 2t, sin 2t) = (ci2, si2) and (co2, so2); every
    argument broadcastable to (..., C) -> (..., 4, 4, C)."""
    return msoa_to_dense(specular_sandwich_soa(A, B, C, S, ci2, si2, co2,
                                               so2))


def specular_sandwich_col0(A, B, co2, so2) -> torch.Tensor:
    """Column 0 of ``R_out @ F @ R_in``, [A, co2 B, -so2 B, 0] -> (..., 4,
    C): all an unpolarized source needs."""
    return torch.stack([A, co2 * B, -so2 * B, torch.zeros_like(A)], dim=-2)


def mueller_matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-channel ``m @ v`` for m (..., 4, 4, C) and v (..., 4, C)."""
    outs = []
    for i in range(4):
        s = m[..., i, 0, :] * v[..., 0, :]
        for k in range(1, 4):
            s = s + m[..., i, k, :] * v[..., k, :]
        outs.append(s)
    return torch.stack(outs, dim=-2)


# ---------------------------------------------------------------------------
# Structured layout: a Mueller matrix (4, 4, ...) and a Stokes vector
# (4, ...), entry [i, j] of the matrix for every lane at once
# ---------------------------------------------------------------------------

def msoa_from_dense(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4, C) -> (4, 4, ..., C)."""
    return M.movedim((-3, -2), (0, 1))


def msoa_to_dense(m: torch.Tensor) -> torch.Tensor:
    """(4, 4, ..., C) -> (..., 4, 4, C)."""
    return m.movedim((0, 1), (-3, -2))


def msoa_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: each element the sum over k = 0..3 of a[i, k] b[k, j]."""
    s = a[:, 0, None] * b[None, 0]
    for k in range(1, 4):
        s = s + a[:, k, None] * b[None, k]
    return s


def msoa_matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for a Stokes vector ``v`` (4, ...)."""
    s = m[:, 0] * v[0]
    for k in range(1, 4):
        s = s + m[:, k] * v[k]
    return s


def msoa_scale(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return m * s


def msoa_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, a, b)


def specular_sandwich_soa(A, B, C, S, ci2, si2, co2, so2) -> torch.Tensor:
    """Structured :func:`specular_sandwich` (R_out @ F @ R_in)."""
    A, B, C, S, ci2, si2, co2, so2 = torch.broadcast_tensors(
        A, B, C, S, ci2, si2, co2, so2)
    z = torch.zeros_like(A)
    return _soa4([
        [A, B * ci2, B * si2, z],
        [co2 * B, co2 * A * ci2 - so2 * C * si2,
         co2 * A * si2 + so2 * C * ci2, so2 * S],
        [-so2 * B, -so2 * A * ci2 - co2 * C * si2,
         -so2 * A * si2 + co2 * C * ci2, co2 * S],
        [z, S * si2, -S * ci2, C],
    ])


def rotator_soa(c2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Structured Mueller rotator from (cos 2t, sin 2t)."""
    z, o = torch.zeros_like(c2), torch.ones_like(c2)
    return _soa4([[o, z, z, z], [z, c2, s2, z], [z, -s2, c2, z],
                  [z, z, z, o]])


def msoa_identity(like: torch.Tensor) -> torch.Tensor:
    """The identity Mueller matrix with entries shaped like ``like``."""
    eye = torch.eye(4, dtype=like.dtype, device=like.device)
    return eye.view(4, 4, *(1,) * like.ndim).expand(4, 4, *like.shape).clone()


# ---------------------------------------------------------------------------
# Structured right-applies (the pending-rotator carry).
#
# The bounce update beta' = beta @ (R_out F R_in) needs neither the
# sandwich nor a full product: R_in of bounce k and R_out of bounce k + 1
# rotate about the same path segment, so they compose by angle addition.
# The carry (stored beta, pending rotator angles), with the true beta =
# stored @ R(pend), turns each specular bounce into a Givens mix of columns
# 1 and 2 and a Fresnel column mix, and each depolarizing bounce into a
# column-0 mask; column-0 reads (emitter hits, Russian roulette on entry
# [0, 0]) see the stored beta, since rotators fix e0.
# ---------------------------------------------------------------------------

def rot2_compose(ca, sa, cb, sb):
    """R(a) @ R(b) = R(a + b) for rotators given as (cos 2t, sin 2t)."""
    return ca * cb - sa * sb, ca * sb + sa * cb


def msoa_apply_rotator_cols(m: torch.Tensor, c2, s2) -> torch.Tensor:
    """``m @ R(c2, s2)``: a Givens mix of columns 1 and 2."""
    b1, b2 = m[:, 1], m[:, 2]
    return torch.stack([m[:, 0], b1 * c2 - b2 * s2, b1 * s2 + b2 * c2,
                        m[:, 3]], dim=1)


def msoa_apply_fresnel_cols(m: torch.Tensor, A, B, C, S) -> torch.Tensor:
    """``m @ F`` for the s/p specular Mueller
    F = [[A,B,0,0],[B,A,0,0],[0,0,C,S],[0,0,-S,C]]."""
    b0, b1, b2, b3 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    return torch.stack([b0 * A + b1 * B, b0 * B + b1 * A,
                        b2 * C - b3 * S, b2 * S + b3 * C], dim=1)


def msoa_depolarize_cols(m: torch.Tensor, value) -> torch.Tensor:
    """``m @ (value * depolarizer)``: only column 0 survives, scaled."""
    c0 = m[:, 0] * value
    z = torch.zeros_like(c0)
    return torch.stack([c0, z, z, z], dim=1)


def stokes_rotate(v: torch.Tensor, c2, s2) -> torch.Tensor:
    """``R(c2, s2) @ v`` for a Stokes vector ``v`` (4, ...)."""
    return torch.stack([v[0], c2 * v[1] + s2 * v[2], -s2 * v[1] + c2 * v[2],
                        v[3]], dim=0)


def msoa_apply_sandwich(m: torch.Tensor, A, B, C, S, ci2, si2, co2,
                        so2) -> torch.Tensor:
    """``m @ (R_out F R_in)`` by three structured right-applies, for a carry
    without a pending rotator."""
    return msoa_apply_rotator_cols(
        msoa_apply_fresnel_cols(
            msoa_apply_rotator_cols(m, co2, so2), A, B, C, S),
        ci2, si2)


def stokes_apply_sandwich(v: torch.Tensor, A, B, C, S, ci2, si2, co2,
                          so2) -> torch.Tensor:
    """``(R_out F R_in) @ v`` by three structured left-applies."""
    v = stokes_rotate(v, ci2, si2)
    v = torch.stack([A * v[0] + B * v[1], B * v[0] + A * v[1],
                     C * v[2] + S * v[3], -S * v[2] + C * v[3]], dim=0)
    return stokes_rotate(v, co2, so2)
