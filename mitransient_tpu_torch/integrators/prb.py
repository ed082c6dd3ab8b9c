"""Path Replay Backpropagation for the transient path tracer (counterpart
of ``mitransient_tpu/integrators/prb.py``).

Two primal-shaped sweeps, memory independent of the path depth: sweep 1
(``path.sample_primal`` with ``enable_film=False``) gives each lane's
total radiance L; sweep 2 (:func:`sample_adjoint`) replays the same path
from the same threefry streams and, at every vertex, forms the locally
differentiable contribution

    Lo(theta) = Le(theta) + Lr_dir(theta)
                + L_rest * replace_grad(1, f(theta) / f_detached)

(the reference's re-attachment trick, transientpath.py:261-293).  In
backward mode it reads the adjoint radiance at the vertex's time bin
(:func:`read_adjoint`) and adds d<adjoint, Lo>/d(theta) to the table
gradients: ``torch.autograd.grad`` of the bounce's scalar with respect to
fresh leaf copies of the tables, so that each bounce's graph is freed
before the next.  In forward mode ``torch.func.jvp`` of the same
contribution gives each bounce's derivative splat.  The ray queries stay
outside the differentiated function, so no kernel runs under autograd.

As in the JAX package and the reference: the adjoint is read once per
vertex at ``bin(distance)`` for the whole Lo; sampling is detached (delta
lobes get no gradient through the indirect term); ``L_rest`` is peeled
per vertex.

The table gradients are the backward of ``ops.gather.gather_rows`` (the
BSDF, emitter and texture gathers): every lane's cotangent summed onto its
table row in a fixed order, by kernel K8 on the card, so that they are the
same on every run and the card's equal the CPU's wherever the sweeps do.
The JAX package transposes a one-hot matmul instead (its ``prb.py:20-22``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bsdf import api as bsdf_api
from ..core.math import dot, mis_weight, replace_grad
from ..core.records import Ray
from ..core.rng import draw_bounce_block
from ..film.transient_film import time_bin
from ..ops.bvh import BVH_MODE
from ..scene.scene import (
    SceneData,
    emitter_eval_direction,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig
from .path import DIMS_PER_BOUNCE, next_vertex


class DiffParams(NamedTuple):
    """The differentiable parameter tables (the JAX package's DiffParams):
    the BSDF reflectance and emitter radiance, GGX roughness, texture
    texels, the per-shape rigid deltas, the delta emitters' positions and
    the media's albedo and extinction.  A field is None where the scene
    has no such table (the textures) or the caller strips it (the geometry
    deltas of the PRB sweeps, :func:`scene.primal_sd`)."""

    bsdf_reflectance: torch.Tensor  # (B, C)
    emitter_radiance: torch.Tensor  # (E, C)
    bsdf_alpha: torch.Tensor | None = None  # (B,) GGX alpha_u
    bsdf_alpha_v: torch.Tensor | None = None  # (B,) GGX alpha_v
    bsdf_textures: torch.Tensor | None = None  # (NT, TH, TW, C) atlas
    shape_translate: torch.Tensor | None = None  # (S, 3)
    shape_rotate: torch.Tensor | None = None  # (S, 3) axis-angle
    emitter_position: torch.Tensor | None = None  # (E, 3)
    medium_albedo: torch.Tensor | None = None  # (M, C)
    medium_sigma_t: torch.Tensor | None = None  # (M,)


def extract_params(sd: SceneData) -> DiffParams:
    geom, med = sd.geom, sd.medium
    return DiffParams(
        bsdf_reflectance=sd.bsdf.reflectance,
        emitter_radiance=sd.emitter.radiance,
        bsdf_alpha=sd.bsdf.alpha,
        bsdf_alpha_v=sd.bsdf.alpha_v,
        bsdf_textures=sd.bsdf.textures,
        shape_translate=geom.translate if geom is not None else None,
        shape_rotate=geom.rotate if geom is not None else None,
        emitter_position=sd.emitter.position,
        medium_albedo=med.albedo if med is not None else None,
        medium_sigma_t=med.sigma_t if med is not None else None,
    )


def insert_params(sd: SceneData, p: DiffParams) -> SceneData:
    """``sd`` with the tables of ``p`` in place of its own (None fields
    keep the scene's)."""
    def pick(new, old):
        return new if new is not None else old

    geom, med = sd.geom, sd.medium
    if geom is not None and p.shape_translate is not None:
        geom = geom._replace(translate=p.shape_translate,
                             rotate=p.shape_rotate)
    if med is not None:
        med = med._replace(albedo=pick(p.medium_albedo, med.albedo),
                           sigma_t=pick(p.medium_sigma_t, med.sigma_t))
    return sd._replace(
        bsdf=sd.bsdf._replace(
            reflectance=p.bsdf_reflectance,
            alpha=pick(p.bsdf_alpha, sd.bsdf.alpha),
            alpha_v=pick(p.bsdf_alpha_v, sd.bsdf.alpha_v),
            textures=pick(p.bsdf_textures, sd.bsdf.textures)),
        emitter=sd.emitter._replace(
            radiance=p.emitter_radiance,
            position=pick(p.emitter_position, sd.emitter.position)),
        geom=geom,
        medium=med,
    )


def as_leaves(theta: DiffParams) -> DiffParams:
    """The tables as fresh leaves that require grad."""
    return DiffParams(*(None if t is None else t.detach().requires_grad_(True)
                        for t in theta))


def table_grads(obj: torch.Tensor, leaves: DiffParams) -> DiffParams:
    """d obj / d leaves, zeros for tables ``obj`` does not reach."""
    present = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(obj, present, allow_unused=True))
    out = []
    for t in leaves:
        if t is None:
            out.append(None)
            continue
        g = next(grads)
        out.append(torch.zeros_like(t) if g is None else g)
    return DiffParams(*out)


def add_params(a: DiffParams | None, b: DiffParams) -> DiffParams:
    if a is None:
        return b
    return DiffParams(*(None if x is None else x + y for x, y in zip(a, b)))


_TABLE_FIELD = {  # traverse table -> DiffParams field
    "bsdf.reflectance": "bsdf_reflectance",
    "emitter.radiance": "emitter_radiance",
    "bsdf.alpha_u": "bsdf_alpha",
    "bsdf.alpha_v": "bsdf_alpha_v",
    "bsdf.textures": "bsdf_textures",
    "shape.translate": "shape_translate",
    "shape.rotate": "shape_rotate",
    "emitter.position": "emitter_position",
    "medium.albedo": "medium_albedo",
    "medium.sigma_t": "medium_sigma_t",
}


def grads_to_named(scene, grads: DiffParams) -> dict:
    """The table gradients by traverse path (``mi.traverse`` semantics),
    with the tables themselves under ``'__tables__'``."""
    out = {"__tables__": grads}
    for path, (table, idx) in scene._param_paths.items():
        if table == "bsdf.alpha":
            # the isotropic path drives both GGX leaves (ParamMap.apply):
            # the chain rule sums their partials, which often have opposite
            # signs off the peak
            if grads.bsdf_alpha is not None:
                g = grads.bsdf_alpha[idx]
                if grads.bsdf_alpha_v is not None:
                    g = g + grads.bsdf_alpha_v[idx]
                out[path] = g
            continue
        field = _TABLE_FIELD.get(table)
        if field is not None and getattr(grads, field) is not None:
            out[path] = getattr(grads, field)[idx]
    return out


def adjoint_images(grad_in, film_cfg: FilmConfig, channels: int, device):
    """``grad_in`` (steady (H, W, C) or None, transient (H, W, T, C) or
    None), arrays or tensors, as float32 (HW, C) and (HW, T, C) tensors on
    ``device``, zeros for None."""
    hw = film_cfg.width * film_cfg.height
    out = []
    for g, shape in zip(grad_in, ((hw, channels),
                                  (hw, film_cfg.temporal_bins, channels))):
        out.append(torch.zeros(shape, dtype=torch.float32, device=device)
                   if g is None else torch.as_tensor(
                       g, dtype=torch.float32, device=device).reshape(shape))
    return out


def read_adjoint(grad_tr_flat: torch.Tensor, grad_st_flat: torch.Tensor,
                 film_cfg: FilmConfig, pix: torch.Tensor,
                 distance: torch.Tensor) -> torch.Tensor:
    """The adjoint radiance at (pixel, bin(distance))
    (``gather_derivatives_at_distance``); the steady adjoint adds to every
    bin of the pixel (``deltaL = dtransient + dsteady``, common.py:363-366).

    grad_tr_flat: (HW * T, C); grad_st_flat: (HW, C)."""
    T = film_cfg.temporal_bins
    b, ok = time_bin(film_cfg, distance)
    idx = pix * T + torch.clamp_max(b, T - 1).to(torch.int64)
    val = grad_tr_flat.index_select(0, idx)
    return (torch.where(ok[:, None], val, 0.0)
            + grad_st_flat.index_select(0, pix))


def sample_adjoint(
    sd: SceneData,
    sampler_key,
    ray: Ray,
    pix: torch.Tensor,
    ray_weight: torch.Tensor,
    L_total: torch.Tensor,  # (N, C) the primal sweep's L
    grad_tr_flat: torch.Tensor | None,
    grad_st_flat: torch.Tensor | None,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    initial_distance: torch.Tensor | None = None,
    mode: str = "backward",
    tangents: DiffParams | None = None,
    bvh_mode: str = BVH_MODE,
):
    """The replay sweep.

    mode='backward': returns the DiffParams gradients of <adjoint,
    render(theta)> (tables the scene lacks stay None).
    mode='forward': returns, per bounce, the derivative splat values (N, C)
    along ``tangents`` and their OPL (N,): two lists of ``max_depth``
    tensors, for the caller to splat (transientpath.py:312-316)."""
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    theta0 = extract_params(sd)
    grads = None
    fwd_vals, fwd_dists = [], []
    if mode == "forward":
        fields = [f for f in DiffParams._fields
                  if getattr(theta0, f) is not None]
        primals = tuple(getattr(theta0, f) for f in fields)
        tans = tuple(
            getattr(tangents, f) if getattr(tangents, f, None) is not None
            else torch.zeros_like(getattr(theta0, f)) for f in fields)

    distance = (initial_distance if initial_distance is not None
                else torch.zeros((n,), dtype=f32, device=dev))
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    if icfg.camera_unwarp:
        si0 = ray_intersect(sd, ray, ones, bvh_mode)
        distance = distance - torch.where(si0.valid, si0.t, 0.0)
    splat_w = ray_weight * sample_scale

    o, d = ray.o, ray.d
    beta = torch.ones((n, C), dtype=f32, device=dev)
    L_rest = L_total
    eta = torch.ones((n,), dtype=f32, device=dev)
    active = ones
    prev = (ray.o, torch.ones((n,), dtype=f32, device=dev), ones)
    for it in range(icfg.max_depth):
        ub = draw_bounce_block(sampler_key, it, n, DIMS_PER_BOUNCE, dev)
        si = ray_intersect(sd, Ray.make(o, d), active, bvh_mode)
        hit = active & si.valid
        distance = distance + torch.where(hit, si.t, 0.0) * eta
        lb_det = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                           sd.bsdf_kinds)

        # detached MIS weights and NEE sample (as the primal sweep)
        pdf_em_hit = torch.where(prev[2], 0.0,
                                 pdf_emitter_direction(sd, prev[0], si))
        mis = mis_weight(prev[1], pdf_em_hit)
        active_next = active & si.valid
        if it + 1 >= icfg.max_depth:
            active_next = torch.zeros_like(active)
        active_em0 = active_next & bsdf_api.is_smooth(lb_det)
        ds, em_weight_det = sample_emitter_direction(
            sd, si.p, ub[:, 0:2], True, active_em0, bvh_mode)
        active_em = active_em0 & (ds.pdf > 0.0)
        wo_em = si.frame.to_local(ds.d)
        _f, pdf_bsdf_em = bsdf_api.eval_pdf(lb_det, si.wi, wo_em, active_em)
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
        # detached BSDF sample (the same dimensions as the primal)
        bs = bsdf_api.sample(lb_det, si.wi, ub[:, 2], ub[:, 3:5],
                             active_next)
        f_det_sampled = bs.weight * bs.pdf[:, None]  # f * cos, detached
        nee_vis = (em_weight_det.sum(dim=-1) != 0.0) & active_em
        em_idx = torch.clamp_min(ds.emitter_id, 0)
        cos_em = dot(ds.n, -ds.d)
        inv_f_det = torch.where(
            f_det_sampled != 0.0,
            1.0 / torch.where(f_det_sampled != 0.0, f_det_sampled, 1.0), 0.0)
        le_mask = (hit & (not icfg.discard_direct_light))[:, None]
        beta_det, L_rest_det, d_cur = beta, L_rest, d

        def contributions(theta: DiffParams):
            sdt = insert_params(sd, theta)
            lb = bsdf_api.gather_lane_bsdf(sdt.bsdf, si.bsdf_id, si.uv,
                                           sd.bsdf_kinds)
            # Le: the attached emitter radiance at the hit
            Le = torch.where(le_mask, beta_det * mis[:, None]
                             * emitter_eval_hit(sdt, si, d_cur), 0.0)
            # Lr_dir: attached BSDF value and emitter radiance, detached
            # pdf and visibility (transientpath.py:196-213)
            f_em, _ = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
            em_val = emitter_eval_direction(sdt, em_idx, ds.p, ds.n, ds.d,
                                            ds.dist, cos_em)
            em_weight = torch.where(
                nee_vis[:, None],
                em_val / torch.clamp_min(ds.pdf, 1e-30)[:, None], 0.0)
            Lr_dir = torch.where(active_em[:, None], beta_det
                                 * mis_em[:, None] * f_em * em_weight, 0.0)
            # Lr_ind: the re-attached sampled BSDF value scales the rest of
            # the path without this vertex's own Le + Lr_dir (:230 -> :290)
            f_cur, _ = bsdf_api.eval_pdf(lb, si.wi, bs.wo, active_next)
            ratio = replace_grad(torch.ones_like(f_cur), f_cur * inv_f_det)
            Lr_ind = (L_rest_det - Le - Lr_dir).detach() * ratio
            return Le + Lr_dir + Lr_ind, (Le, Lr_dir)

        if mode == "backward":
            dL_read = read_adjoint(grad_tr_flat, grad_st_flat, film_cfg, pix,
                                   distance)
            weight_lane = torch.where(active, splat_w, 0.0)
            leaves = as_leaves(theta0)
            with torch.enable_grad():
                Lo, (Le, Lr_dir) = contributions(leaves)
                obj = (dL_read * Lo * weight_lane[:, None]).sum()
                grads = add_params(grads, table_grads(obj, leaves))
            del obj, Lo
        else:
            def lo_only(*tables):
                return contributions(
                    theta0._replace(**dict(zip(fields, tables))))

            _Lo, dLo, (Le, Lr_dir) = torch.func.jvp(lo_only, primals, tans,
                                                   has_aux=True)
            fwd_vals.append(torch.where(active[:, None],
                                        dLo * splat_w[:, None], 0.0))
            fwd_dists.append(distance)
        Le, Lr_dir = Le.detach(), Lr_dir.detach()

        # ---- state update: the primal sweep's own
        o, d, beta, eta, active, prev, _ = next_vertex(
            si, bs, hit, active_next, beta, eta, prev, it, icfg, ub[:, 5])
        L_rest = L_rest - Le - Lr_dir

    if mode == "backward":
        return grads
    return fwd_vals, fwd_dists
