"""Path Replay Backpropagation for the volumetric transient integrator
(counterpart of ``mitransient_tpu/integrators/prb_vol.py``).

Two primal-shaped sweeps, memory independent of the path depth: sweep 1
(``volpath.sample_volpath_primal`` with ``enable_film=False``) gives each
lane's total radiance L; sweep 2 (:func:`sample_volpath_adjoint`) replays
the same path from the same threefry streams (the bounce blocks and, for
grid media, the tracking streams) and, at every event, forms the locally
differentiable contribution

    Lo(theta) = Le(theta) + Lr_dir(theta)
                + L_rest * replace_grad(1, factor(theta) / factor_detached)

where ``factor`` is the BSDF value at a surface scatter and the medium's
albedo at a real medium scatter (the analog throughput factor).  In
homogeneous media the free flight's survival ratio and the NEE
transmittance are attached through sigma_t; grid media keep them
detached, as the JAX package does.  The adjoint is read per term at the
term's own bin: the vertex's bin for Le and the indirect term, the NEE
endpoint's (distance + ds.dist * eta) for Lr_dir.

Each bounce's gradient is ``torch.autograd.grad`` of its scalar with
respect to fresh leaf copies of the tables, so its graph is freed before
the next.  The ray queries stay outside the differentiated function: the
attached transmittance is recomputed from the walk's segments
(``volpath.segments_transmittance``), so no kernel runs under autograd.
"""
from __future__ import annotations

import torch

from ..bsdf import api as bsdf_api
from ..core.math import dot, replace_grad
from ..core.records import Ray
from ..core.rng import draw_bounce_block
from ..ops.bvh import BVH_MODE
from ..ops.gather import gather_rows
from ..scene.scene import SceneData, emitter_eval_direction, emitter_eval_hit
from ..scene.schema import FilmConfig, IntegratorConfig
from .prb import (
    DiffParams,
    add_params,
    as_leaves,
    extract_params,
    insert_params,
    read_adjoint,
    table_grads,
)
from .volpath import (
    VOL_DIMS_PER_BOUNCE,
    VolState,
    first_surface_distance,
    has_grids,
    next_state,
    segments_transmittance,
    survival_ratio,
    trace_vertex,
)


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    nz = x != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, x, 1.0), 0.0)


def sample_volpath_adjoint(
    sd: SceneData,
    sampler_key,
    ray: Ray,
    pix: torch.Tensor,
    ray_weight: torch.Tensor,
    L_total: torch.Tensor,  # (N, C) the primal sweep's L
    grad_tr_flat: torch.Tensor,  # (HW * T, C)
    grad_st_flat: torch.Tensor,  # (HW, C)
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    bvh_mode: str = BVH_MODE,
) -> DiffParams:
    """The replay sweep -> the DiffParams gradients of <adjoint,
    render(theta)>.  Its control flow and random numbers are the primal
    sweep's, so no path state is kept between the sweeps."""
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    theta0 = extract_params(sd)
    grids = has_grids(sd)
    splat_w = ray_weight * sample_scale
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    distance0 = (-first_surface_distance(sd, ray, bvh_mode=bvh_mode)
                 if icfg.camera_unwarp
                 else torch.zeros((n,), dtype=f32, device=dev))
    st = VolState(
        o=ray.o, d=ray.d, beta=torch.ones((n, C), dtype=f32, device=dev),
        L=L_total, eta=torch.ones((n,), dtype=f32, device=dev),
        distance=distance0, active=ones, depth=None,
        medium=torch.full((n,), -1, dtype=torch.int32, device=dev),
        prev_p=ray.o, prev_pdf=torch.ones((n,), dtype=f32, device=dev),
        prev_delta=ones, film=None, n_rays=None)
    grads = None
    for it in range(icfg.max_depth):
        ub = draw_bounce_block(sampler_key, it, n, VOL_DIMS_PER_BOUNCE)
        v = trace_vertex(sd, sampler_key, it, ub, st, icfg, bvh_mode)
        si, ds, ms = v.si, v.ds, v.medium_scatter
        m_idx = torch.clamp_min(st.medium, 0)
        nee_vis = (v.em_weight.sum(dim=-1) != 0.0) & v.active_em
        em_idx = torch.clamp_min(ds.emitter_id, 0)
        cos_em = dot(ds.n, -ds.d)
        inv_f_det = _safe_inv(v.bs.weight * v.bs.pdf[:, None])
        alb_det = torch.where(v.in_medium[:, None], v.med_albedo, 1.0)
        inv_alb = _safe_inv(alb_det)
        srf_next = v.active_next & ~ms
        beta_pre, L_rest, d_cur = st.beta, st.L, st.d

        def contributions(theta: DiffParams):
            sdt = insert_params(sd, theta)
            lb = bsdf_api.gather_lane_bsdf(sdt.bsdf, si.bsdf_id, si.uv,
                                           sd.bsdf_kinds)
            albedo = torch.where(
                v.in_medium[:, None],
                gather_rows(theta.medium_albedo, m_idx), 1.0)
            beta_evt = torch.where(ms[:, None], beta_pre * albedo, beta_pre)
            if grids:  # the tracking chain stays detached
                trans = v.trans
            else:
                sigma_t = torch.where(
                    v.in_medium, gather_rows(theta.medium_sigma_t, m_idx),
                    0.0)
                ff_ratio = survival_ratio(sigma_t, v.t_event, ms,
                                          v.in_medium, v.hit)
                beta_evt = beta_evt * ff_ratio[:, None]
                trans = segments_transmittance(theta.medium_sigma_t,
                                               v.trans_segs)
            Le = torch.where(v.le_mask[:, None], beta_evt * v.mis[:, None]
                             * emitter_eval_hit(sdt, si, d_cur), 0.0)
            # Lr_dir: attached BSDF and emitter radiance, detached phase,
            # pdf and visibility
            f_srf, _ = bsdf_api.eval_pdf(lb, si.wi, v.wo_em, v.active_em)
            f_em = torch.where(ms[:, None], v.f_phase, f_srf)
            em_val = emitter_eval_direction(sdt, em_idx, ds.p, ds.n, ds.d,
                                            ds.dist, cos_em)
            em_weight = torch.where(
                nee_vis[:, None],
                em_val / torch.clamp_min(ds.pdf, 1e-30)[:, None], 0.0)
            Lr_dir = torch.where(v.active_em[:, None],
                                 beta_evt * v.mis_em[:, None] * f_em
                                 * em_weight * trans[:, None], 0.0)
            # the rest of the path, re-attached to this event's sampled
            # factor: the BSDF value at a surface, the albedo in a medium,
            # and the flight's survival ratio
            f_cur, _ = bsdf_api.eval_pdf(lb, si.wi, v.bs.wo, srf_next)
            ratio = torch.where(
                ms[:, None],
                replace_grad(torch.ones_like(albedo), albedo * inv_alb),
                replace_grad(torch.ones_like(f_cur), f_cur * inv_f_det))
            if not grids:
                ratio = ratio * ff_ratio[:, None]
            Lr_ind = (L_rest - Le - Lr_dir).detach() * ratio
            return Le, Lr_dir, Lr_ind

        dL_vertex = read_adjoint(grad_tr_flat, grad_st_flat, film_cfg, pix,
                                 v.distance)
        dL_nee = read_adjoint(grad_tr_flat, grad_st_flat, film_cfg, pix,
                              v.distance + ds.dist * st.eta)
        weight_lane = torch.where(st.active, splat_w, 0.0)[:, None]
        leaves = as_leaves(theta0)
        with torch.enable_grad():
            Le, Lr_dir, Lr_ind = contributions(leaves)
            obj = ((dL_vertex * (Le + Lr_ind) + dL_nee * Lr_dir)
                   * weight_lane).sum()
            grads = add_params(grads, table_grads(obj, leaves))
        Le, Lr_dir = Le.detach(), Lr_dir.detach()
        del obj, Lr_ind

        # ---- the primal sweep's state update
        beta = torch.where(ms[:, None], beta_pre * alb_det, beta_pre)
        o, d, beta, eta, active, prev_p, prev_pdf, prev_delta = next_state(
            v, st, beta, it, icfg, ub[:, 7])
        st = st._replace(o=o, d=d, beta=beta, L=L_rest - Le - Lr_dir,
                         eta=eta, distance=v.distance, active=active,
                         medium=v.new_med, prev_p=prev_p, prev_pdf=prev_pdf,
                         prev_delta=prev_delta)
    return grads
