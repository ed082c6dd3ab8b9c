"""Fresnel terms of the unpolarized path (counterpart of
``mitransient_tpu/bsdf/fresnel.py``): the conductor's with a complex IOR,
and the dielectric's with a signed cosine."""
from __future__ import annotations

import torch

from ..core.math import stable_sqrt


def fresnel_conductor(cos_theta_i: torch.Tensor, eta_re: torch.Tensor,
                      eta_im: torch.Tensor) -> torch.Tensor:
    """Unpolarized reflectance of a conductor with IOR ``eta_re + i
    eta_im`` ((N, C) each) at ``cos_theta_i`` ((N,), clamped to [0, 1]).
    -> (N, C)."""
    ci = torch.clamp(cos_theta_i, 0.0, 1.0)
    if eta_re.dim() > ci.dim():
        ci = ci[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta_re * eta_re - eta_im * eta_im
    etak2 = 2.0 * eta_re * eta_im

    t0 = eta2 - si2
    # stable_sqrt: a non-conductor row (eta = k = 0), evaluated by the dense
    # kind dispatch, takes both square roots at exactly 0
    a2b2 = stable_sqrt(t0 * t0 + etak2 * etak2)
    t1 = a2b2 + ci2
    a = stable_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)


def fresnel_dielectric(cos_theta_i: torch.Tensor, eta: torch.Tensor):
    """Dielectric Fresnel of a signed cosine (Mitsuba's ``fresnel()``):
    ``cos_theta_i`` (N,), ``eta`` (N,) the interior / exterior IOR ratio.
    -> (F, cos_theta_t, eta_it, eta_ti): the reflectance, the signed cosine
    of the transmitted direction, and the relative IOR along the
    transmission and its inverse."""
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it

    ci = torch.abs(cos_theta_i)
    st2 = torch.clamp_min(1.0 - ci * ci, 0.0) * (eta_ti * eta_ti)
    tir = st2 >= 1.0
    ct = stable_sqrt(1.0 - st2)

    rs = (ci - eta_it * ct) / torch.clamp_min(ci + eta_it * ct, 1e-20)
    rp = (eta_it * ci - ct) / torch.clamp_min(eta_it * ci + ct, 1e-20)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(outside, -ct, ct)
    return F, cos_theta_t, eta_it, eta_ti
