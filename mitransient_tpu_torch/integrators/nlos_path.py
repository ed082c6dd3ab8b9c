"""Transient NLOS path tracer (counterpart of
``mitransient_tpu/integrators/nlos_path.py``).

The reference's NLOS integrator (``transient_nlos_path``, [Royo2022]):
relay-wall capture with laser sampling (a two-segment NEE through the
illuminated wall point) and area-proportional hidden-geometry direction
sampling, as a dense masked wavefront of ``max_depth`` bounces.

* :func:`prepare_nlos` computes the capture's constants once a render: the
  sensor's scan targets on the relay wall, the laser target, the hidden
  geometry's triangle CDF and the wall vertex of the laser NEE (its normal,
  BSDF row, the wall->laser segment, its occlusion and the emitter term).
* :func:`sample_nlos_primal` traces one wavefront.  A bounce launches one
  closest-hit query (K1, or the BVH kernel in scenes with an accel), one
  shadow-ray query (K2 or the BVH kernel: vertex->wall with laser sampling,
  vertex->emitter without) and one film splat (K3).  A scene whose only
  emitter is delta (every laser-focused capture) skips the emitter-hit
  term, so K3 splats one event set a bounce.
* The confocal scan (:func:`render_nlos_confocal_scan`) gives every lane
  the laser constants of its own scan point; the exhaustive capture
  (:func:`render_nlos_exhaustive`) feeds every laser point from one camera
  wavefront, splatting into a film of laser x scan-pixel slots.

Variants (single and confocal captures; the exhaustive capture renders
them point by point): under a polarized variant the throughput is a full
Mueller matrix in the structured layout of ``core/mueller.py``, which
starts as the sensor-alignment rotator and takes each bounce's
polarization factor by three structured right-applies
(``msoa_apply_sandwich``), as the JAX package's NLOS loop does (it keeps
no pending rotator); the laser NEE needs only column 0 of its two-vertex
chain, so the wall's factor column goes through the vertex's factor
(``stokes_apply_sandwich``) and one matrix-vector product with beta.
Films have 4 C channels, Stokes-major.  Under a spectral variant each
lane carries ``N_WL`` hero wavelengths (``core/spectra.py``), the BSDF
rows and the emitter terms are uplifted to them, and every splat and the
steady value convert to sRGB.

RNG: each bounce draws its 10 sampler dimensions as one threefry block
(``draw_bounce_block(key, it, n, 10)``): NEE 0-1 (unused by a delta laser),
HG/BSDF choice 2, hidden point 4-5, BSDF lobe 6 and direction 7-8, Russian
roulette 9.  Each pass draws on its stream key, row ``pass`` of
``pass_keys(seed, ...)``.

The JAX package counts rays in float32; this module counts them in int64.
Its hidden-point pick is ``DiscreteDistribution.sample_reuse`` (a
``torch.searchsorted``) on the area CDF where the JAX package compares each
lane with every CDF entry; both return the count of entries below ``u``,
since the CDF never decreases.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import passgraph, trace
from ..bsdf import api as bsdf_api
from ..bsdf.polarized import (
    polarization_factor_col0_soa,
    sensor_alignment_soa,
    specular_params_soa,
)
from ..core.distribution import DiscreteDistribution
from ..core.frame import Frame
from ..core.math import dot, mis_weight, normalize, sqrt
from ..core.mueller import (
    msoa_apply_sandwich,
    msoa_matvec,
    stokes_apply_sandwich,
)
from ..core.records import Ray
from ..core.rng import Sampler, draw_bounce_block, pass_keys
from ..core.spectra import N_WL, SpectralCtx
from ..film.transient_film import (
    TransientFilmState,
    develop,
    film_init,
    splat_steady,
    splat_transient_flat,
    splat_transient_pair,
    surface_sample_validation,
)
from ..ops.bvh import BVH_MODE
from ..ops.intersect import closest_hit
from ..scene.scene import (
    BSDF_NULL,
    EM_POINT,
    EM_PROJECTOR,
    SceneData,
    emitter_eval_direction,
    emitter_eval_hit,
    pdf_emitter_direction,
    primal_sd,
    ray_intersect,
    ray_test,
)
from ..scene.schema import FilmConfig, IntegratorConfig, Scene, SensorConfig
from ..scene.shapes import Rectangle
from . import DEFAULT_MAX_LANES, _split_spp
from .path import _half_vector_cos, pack_stokes

NLOS_DIMS_PER_BOUNCE = 10
LANE_LASER_PAIRS = 1 << 24  # the exhaustive capture's (laser, lane) budget
_DELTA = (EM_PROJECTOR, EM_POINT)


def can_skip_le(sd: SceneData) -> bool:
    """True when every emitter is delta (projector or point), so that the
    emitter-hit term is identically zero and its film event can go."""
    kinds = sd.emitter_kinds
    return bool(kinds) and all(k in _DELTA for k in kinds)


class NLOSContext(NamedTuple):
    """The capture's constants (the reference's ``prepare``,
    transientnlospath.py:251-383), tensors on the scene's device."""

    sensor_origin: torch.Tensor  # (3,)
    sensor_targets: torch.Tensor  # (HW, 3) pixel-centre points on the wall
    laser_target: torch.Tensor  # (3,) illuminated wall point
    emitter_idx: torch.Tensor  # () int32, the single emitter
    hg_tri_idx: torch.Tensor  # (K,) int32 hidden-geometry triangles
    hg_tri_cdf: torch.Tensor  # (K,) f32 area CDF over them
    hg_total_area: torch.Tensor  # ()
    # the wall vertex of the laser NEE, the same for every lane
    wall_ng: torch.Tensor  # (3,) geometric normal at laser_target
    wall_n_sh: torch.Tensor  # (3,) shading normal
    wall_uv: torch.Tensor  # (2,)
    wall_bsdf_id: torch.Tensor  # () int32
    wall_em: torch.Tensor  # (C,) emitter term of the wall->laser NEE
    wall_dist2: torch.Tensor  # () wall->laser distance
    wall_d2: torch.Tensor  # (3,) unit direction wall->laser
    wall_clear: torch.Tensor  # () bool: wall->laser segment unoccluded


class ExhaustiveLaser(NamedTuple):
    """The wall-vertex constants of NLOSContext, one row per laser point
    (exhaustive capture) or per scan point (confocal scan); each point is a
    refocused delta laser, so ``wall_em`` is its on-axis radiance."""

    laser_target: torch.Tensor  # (L, 3)
    wall_ng: torch.Tensor  # (L, 3)
    wall_n_sh: torch.Tensor  # (L, 3)
    wall_uv: torch.Tensor  # (L, 2)
    wall_bsdf_id: torch.Tensor  # (L,) int32
    wall_em: torch.Tensor  # (L, C)
    wall_dist2: torch.Tensor  # (L,)
    wall_d2: torch.Tensor  # (L, 3)
    wall_clear: torch.Tensor  # (L,) bool


def _pixel_uv(w: int, h: int) -> np.ndarray:
    """(h*w, 2) pixel-centre uv of a w x h grid, row-major."""
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([(px.ravel() + 0.5) / w, (py.ravel() + 0.5) / h], -1)


def _scan_hit(sd: SceneData, o: np.ndarray, d: np.ndarray, bvh_mode):
    """Closest hits of host rays (o, d float32-castable (n, 3)) on the
    scene's device -> host (t, prim)."""
    dev = sd.tri.v0.device
    n = d.shape[0]
    t, prim = closest_hit(
        sd.tri.v0, sd.tri.e1, sd.tri.e2,
        torch.from_numpy(np.ascontiguousarray(o, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(d, np.float32)).to(dev),
        torch.full((n,), float("inf"), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev),
        accel=sd.accel, bvh_mode=bvh_mode, table=sd.tri.table)
    return t.cpu().numpy(), prim.cpu().numpy()


def prepare_nlos(scene: Scene, sensor_cfg: SensorConfig,
                 bvh_mode: str = BVH_MODE) -> NLOSContext:
    """The capture's constants (transientnlospath.py:251-383), for an
    ``nlos_capture_meter`` or a perspective sensor."""
    sd = primal_sd(scene.data)
    dev = scene.device
    icfg = scene.integrator
    E = int(sd.emitter.kind.shape[0])
    if E != 1:
        raise ValueError(
            f"NLOS scenes must have exactly 1 emitter, got {E} "
            "(transientnlospath.py:256-260)")

    sx, sy = sensor_cfg.film.width, sensor_cfg.film.height
    if sensor_cfg.kind == "perspective":
        # scan targets: the pixel-centre camera rays' hits
        # (transientnlospath.py:294-312)
        from ..sensors.perspective import build_camera

        cam = build_camera(sensor_cfg)
        uv = _pixel_uv(sx, sy)
        d_cam = np.stack([
            (1.0 - 2.0 * uv[:, 0]) * float(cam.tan_half[0]),
            (1.0 - 2.0 * uv[:, 1]) * float(cam.tan_half[1]),
            np.ones(uv.shape[0]),
        ], axis=-1)
        d_world = d_cam @ cam.R.numpy().T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        origin = cam.origin.numpy()
        t_np, prim_np = _scan_hit(
            sd, np.broadcast_to(origin, d_world.shape), d_world, bvh_mode)
        if not np.any(prim_np >= 0):
            raise ValueError("The sensor did not intersect any geometry "
                             "(transientnlospath.py:314-317)")
        t_np = np.where(np.isfinite(t_np), t_np, 0.0)
        targets = (origin + d_world * t_np[:, None]).astype(np.float32)
        sensor_origin = origin.astype(np.float32)
        # the relay wall is the shape the central scan ray hits
        center_prim = int(prim_np[(sy // 2) * sx + sx // 2])
        wall_shape_index = (int(sd.tri.shape_id[center_prim])
                            if center_prim >= 0 else -1)
    else:
        wall_shape = scene.shapes[sensor_cfg.shape_index]
        if not isinstance(wall_shape, Rectangle):
            raise TypeError(
                "nlos_capture_meter must be attached to a rectangle")
        targets = wall_shape.position_from_uv(_pixel_uv(sx, sy)).astype(
            np.float32)
        sensor_origin = np.asarray(sensor_cfg.sensor_origin, np.float32)
        wall_shape_index = sensor_cfg.shape_index
    if sensor_cfg.is_confocal:
        # the 1x1 film's sensor ray aims at the focused laser point
        if not scene.laser_focused:
            raise ValueError(
                "confocal capture requires focusing the laser first "
                "(mitransient_tpu.nlos.focus_emitter_at_relay_wall_*)")
        targets = np.asarray(scene.laser_target, np.float32).reshape(1, 3)

    # laser target: the focus, else the projector axis's hit
    if scene.laser_focused:
        laser_target = np.asarray(scene.laser_target, np.float32)
    else:
        o = sd.emitter.position[0].cpu().numpy().reshape(1, 3)
        d = sd.emitter.direction[0].cpu().numpy().reshape(1, 3)
        t, prim = _scan_hit(sd, o, d, bvh_mode)
        if int(prim[0]) < 0:
            raise ValueError("The emitter is not pointing at the scene! "
                             "(transientnlospath.py:334)")
        laser_target = np.asarray(o[0] + d[0] * float(t[0]), np.float32)

    # hidden-geometry triangle tables
    with trace.span("mitr:sync"):  # the scene's device tables, read back
        areas = sd.tri.area.cpu().numpy()
        shape_ids = sd.tri.shape_id.cpu().numpy()
    mask = np.ones_like(areas, bool)
    if not icfg.nlos_hidden_geometry_sampling_includes_relay_wall:
        mask &= shape_ids != wall_shape_index
    hg_idx = np.nonzero(mask)[0].astype(np.int32)
    hg_areas = areas[hg_idx]
    total = float(hg_areas.sum())
    if icfg.nlos_hidden_geometry_sampling and (len(hg_idx) == 0 or total <= 0):
        raise ValueError("Hidden geometry sampling is activated, but there "
                         "is no hidden geometry (transientnlospath.py:284-289)")
    if len(hg_idx) == 0:
        hg_idx = np.zeros(1, np.int32)
        hg_areas = np.ones(1, np.float32)
        total = 1.0
    cdf = np.cumsum(hg_areas / total).astype(np.float32)

    # the wall vertex of the laser NEE and the wall -> laser segment
    with trace.span("mitr:sync"):
        epos = sd.emitter.position[0].cpu().numpy().astype(np.float32)
    to_wall = laser_target - epos
    dist_ew = float(np.linalg.norm(to_wall))
    d_ew = to_wall / max(dist_ew, 1e-12)

    def dev_t(a, dtype=torch.float32):
        with trace.span("mitr:sync"):  # a copy from pageable host memory
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    one = torch.ones((1,), dtype=torch.bool, device=dev)
    si_w = ray_intersect(sd, Ray.make(dev_t(epos).reshape(1, 3),
                                      dev_t(d_ew).reshape(1, 3)), one,
                         bvh_mode)
    with trace.span("mitr:sync"):
        wall_hit = bool(si_w.valid[0])
    if not wall_hit:
        raise ValueError("The emitter is not pointing at the scene! "
                         "(transientnlospath.py:334)")
    d2 = -d_ew
    d2_t = dev_t(d2).reshape(1, 3)
    occ2 = ray_test(sd, dev_t(laser_target).reshape(1, 3) + d2_t * 1e-4, d2_t,
                    torch.full((1,), dist_ew - 2e-4, device=dev), one,
                    bvh_mode)
    edir = sd.emitter.direction[0]
    with trace.span("mitr:sync"):
        cos_em = float(np.dot(-d2, edir.cpu().numpy()))
    em_val = emitter_eval_direction(
        sd, torch.zeros((1,), dtype=torch.int32, device=dev),
        dev_t(epos).reshape(1, 3), -edir.reshape(1, 3), d2_t,
        torch.full((1,), dist_ew, device=dev),
        torch.full((1,), cos_em, device=dev))
    return NLOSContext(
        sensor_origin=dev_t(sensor_origin),
        sensor_targets=dev_t(targets),
        laser_target=dev_t(laser_target),
        emitter_idx=torch.zeros((), dtype=torch.int32, device=dev),
        hg_tri_idx=dev_t(hg_idx, torch.int32),
        hg_tri_cdf=dev_t(cdf),
        hg_total_area=dev_t(total),
        wall_ng=si_w.n[0],
        wall_n_sh=si_w.frame.n[0],
        wall_uv=si_w.uv[0],
        wall_bsdf_id=si_w.bsdf_id[0],
        wall_em=em_val[0],
        wall_dist2=dev_t(dist_ew),
        wall_d2=dev_t(d2),
        wall_clear=~occ2[0],
    )


def sample_nlos_rays(ctx: NLOSContext, spp: int, hw: int):
    """Sensor rays (nloscapturemeter.py:136-180): from ``sensor_origin``
    toward the pixel-centre wall points, spp-major lanes, the same for
    every sample of a pixel.  -> (Ray, ray_weight (N,))."""
    targets = ctx.sensor_targets.repeat(spp, 1)  # (N, 3)
    o = ctx.sensor_origin.expand(targets.shape).contiguous()
    return (Ray.make(o, normalize(targets - o)),
            torch.ones((spp * hw,), dtype=torch.float32, device=o.device))


def _sample_hidden_point(sd: SceneData, ctx: NLOSContext, u0, u1):
    """Area-proportional point on the hidden geometry
    (transientnlospath.py:385-430) -> (p, its normal, pdf = 1/area)."""
    hg = DiscreteDistribution.from_cdf(ctx.hg_tri_cdf, ctx.hg_total_area)
    slot, u0b, _pmf = hg.sample_reuse(u0)
    tri = ctx.hg_tri_idx.index_select(0, slot)
    su = sqrt(torch.clamp_min(u0b, 0.0))
    b1 = 1.0 - su
    b2 = u1 * su
    t = sd.tri
    p = (t.v0.index_select(0, tri) + t.e1.index_select(0, tri) * b1[:, None]
         + t.e2.index_select(0, tri) * b2[:, None])
    pdf_area = 1.0 / torch.clamp_min(hg.total, 1e-30)
    return p, t.ng.index_select(0, tri), pdf_area


def _depth_gate(icfg: IntegratorConfig, depth: int, active):
    """``filter_depth`` / ``discard_direct_paths`` (:489-492) for an NEE
    contribution at path depth ``depth``."""
    if icfg.filter_depth != -1 and depth != icfg.filter_depth:
        return torch.zeros_like(active)
    if icfg.discard_direct_paths and depth <= 2:
        return torch.zeros_like(active)
    return active


def _laser_nee(sd, ctx, icfg, si, lb, beta, distance, eta, it, active_e,
               account_last: bool, lanes=None, bvh_mode=BVH_MODE,
               d_in=None, sctx: SpectralCtx | None = None):
    """Two-segment laser NEE (transientnlospath.py:511-635): path vertex ->
    illuminated wall point, traced; wall point -> delta laser, the
    constants of ``ctx`` (or of ``lanes``, one row per lane, in the
    confocal scan).  -> (Lr (N, C), splat distance (N,)).

    ``d_in`` (the direction the path arrived along) makes the NEE
    polarized: ``beta`` is the structured Mueller throughput and Lr the
    Stokes vector (N, 4 C).  ``sctx`` uplifts the wall's BSDF row and the
    laser term to the lanes' wavelengths."""
    n = si.t.shape[0]
    src = lanes if lanes is not None else ctx
    d1v = src.laser_target - si.p
    dist1 = sqrt(torch.clamp_min(dot(d1v, d1v), 1e-20))
    d1 = d1v / dist1[:, None]
    occ1 = ray_test(sd, si.p + d1 * 1e-4, d1, dist1 - 2e-4, active_e,
                    bvh_mode)
    active_e = active_e & ~occ1 & src.wall_clear
    wo1 = si.frame.to_local(d1)
    f1, _ = bsdf_api.eval_pdf(lb, si.wi, wo1, active_e)
    if d_in is not None:  # the vertex -> wall bounce's factor parameters
        prm1 = specular_params_soa(lb, -d1, -d_in,
                                   _half_vector_cos(si.wi, wo1))
    active_e = active_e & (f1.amax(dim=-1) > 1e-7)
    cos_wl = dot(src.wall_ng, -d1)
    active_e = active_e & (cos_wl > 0.0)
    # area -> solid angle pdf of the wall point (:546-551)
    pdf_ls = dist1 * dist1 / torch.clamp_min(cos_wl, 1e-9)
    f1 = torch.where(active_e[:, None],
                     f1 / torch.clamp_min(pdf_ls, 1e-9)[:, None], 0.0)
    dist_after1 = distance + torch.where(active_e, dist1, 0.0) * eta

    # wall point -> laser: one row for the wavefront or one a lane
    lb2 = bsdf_api.gather_lane_bsdf(sd.bsdf, src.wall_bsdf_id.reshape(-1),
                                    src.wall_uv.reshape(-1, 2), sd.bsdf_kinds)
    em_val = src.wall_em
    wall_d2 = src.wall_d2.reshape(-1, 3)
    if d_in is not None or sctx is not None:  # a row per lane
        lb2 = bsdf_api.map_lanes(lb2,
                                 lambda a: a.expand(n, *a.shape[1:]))
        em_val = em_val.expand(n, em_val.shape[-1])
        wall_d2 = wall_d2.expand(n, 3)
    if sctx is not None:
        lb2 = sctx.uplift_lb(lb2)
        em_val = sctx.emission(em_val)
    wframe = Frame.from_normal(src.wall_n_sh.reshape(-1, 3))
    wi2 = wframe.to_local(-d1)
    wo2 = wframe.to_local(wall_d2)
    active_e = _depth_gate(icfg, it + 2, active_e)  # two more vertices
    f2, _ = bsdf_api.eval_pdf(lb2, wi2, wo2, active_e)
    if d_in is None:
        Lr = torch.where(active_e[:, None], beta * f1 * f2 * em_val, 0.0)
    else:
        # the source is unpolarized: column 0 of the chain, the wall's
        # factor column through the vertex's factor, then beta
        v = polarization_factor_col0_soa(lb2, -wall_d2, -d1,
                                         _half_vector_cos(wi2, wo2)) * f2
        is_spec, A, B, Cc, S, ci2, si2, co2, so2 = prm1
        v_spec = stokes_apply_sandwich(v, A, B, Cc, S, ci2[:, None],
                                       si2[:, None], co2[:, None],
                                       so2[:, None])
        other = torch.cat([v[:1], v[1:] * (lb.kind == BSDF_NULL)[:, None]
                           .to(v.dtype)])
        col = msoa_matvec(beta, torch.where(is_spec[:, None], v_spec, other)
                          * f1)
        Lr = torch.where(active_e[:, None], pack_stokes(col * em_val), 0.0)
    if account_last:
        return Lr, dist_after1 + src.wall_dist2 * eta
    return Lr, dist_after1


def _plain_nee(sd, ctx, icfg, si, lb, beta, distance, eta, it, active_e,
               account_last: bool, bvh_mode=BVH_MODE, d_in=None,
               sctx: SpectralCtx | None = None):
    """NEE toward the single emitter's position
    (transientnlospath.py:432-509); ``d_in`` and ``sctx`` as in
    :func:`_laser_nee`."""
    n = si.t.shape[0]
    em = sd.emitter
    epos, edir = em.position[0], em.direction[0]
    d2v = epos - si.p
    dist2 = sqrt(torch.clamp_min(dot(d2v, d2v), 1e-20))
    d2 = d2v / dist2[:, None]
    occ = ray_test(sd, si.p + d2 * 1e-4, d2, dist2 - 2e-4, active_e, bvh_mode)
    active_e = active_e & ~occ
    em_val = emitter_eval_direction(
        sd, ctx.emitter_idx.expand(n), epos.expand(n, 3), -edir.expand(n, 3),
        d2, dist2, dot(-d2, edir))
    if sctx is not None:
        em_val = sctx.emission(em_val)
    wo2 = si.frame.to_local(d2)
    f2, _ = bsdf_api.eval_pdf(lb, si.wi, wo2, active_e)
    active_e = _depth_gate(icfg, it, active_e)
    if d_in is None:
        Lr = torch.where(active_e[:, None], beta * f2 * em_val, 0.0)
    else:
        P0 = polarization_factor_col0_soa(lb, -d2, -d_in,
                                          _half_vector_cos(si.wi, wo2))
        col = msoa_matvec(beta, P0 * f2)
        Lr = torch.where(active_e[:, None], pack_stokes(col * em_val), 0.0)
    if account_last:
        return Lr, distance + dist2 * eta
    return Lr, distance


def _polarized_step(si, lb, wo, d_world, d_in, delta, f, beta):
    """The Mueller throughput after a sampled direction: beta @ (R_out F
    R_in) by structured right-applies on specular lanes, column 0 times the
    weight ``f`` on depolarizing lanes, every column times ``f`` on null
    lanes (the JAX package's NLOS update, which keeps no pending
    rotator)."""
    cos_i = torch.where(delta, torch.abs(si.wi[:, 2]),
                        _half_vector_cos(si.wi, wo))
    is_spec, A, B, Cc, S, ci2, si2, co2, so2 = specular_params_soa(
        lb, -d_world, -d_in, cos_i)
    spec = msoa_apply_sandwich(beta, A * f, B * f, Cc * f, S * f,
                               ci2[:, None], si2[:, None], co2[:, None],
                               so2[:, None])
    other = beta * f
    other = torch.cat([other[:, :1], other[:, 1:]
                       * (lb.kind == BSDF_NULL)[:, None].to(f.dtype)], dim=1)
    return torch.where(is_spec[:, None], spec, other)


def _continue(sd, ctx, icfg, si, lb, ub, it, active_next, beta, eta,
              d_in=None):
    """Hidden-geometry or BSDF direction sampling (dims 2-8) and Russian
    roulette (dim 9) -> (o, d, beta, eta, active_next, pdf, delta).
    ``d_in`` (the incoming direction) takes a polarized ``beta`` through
    :func:`_polarized_step`."""
    hg_on = icfg.nlos_hidden_geometry_sampling
    hg_rr = icfg.nlos_hidden_geometry_sampling_do_rroulette
    pdf_method = 0.5 if hg_on and hg_rr else 1.0
    if hg_on:
        do_hg = (ub[:, 2] < 0.5 if hg_rr else
                 torch.ones_like(active_next))
        # dim 3 is unused, like the reference's discarded next_1d (:814)
        p_hg, n_hg, pdf_a = _sample_hidden_point(sd, ctx, ub[:, 4], ub[:, 5])
        dvh = p_hg - si.p
        dist_h = sqrt(torch.clamp_min(dot(dvh, dvh), 1e-20))
        dh = dvh / dist_h[:, None]
        cos_g = dot(n_hg, -dh)
        hg_ok = (active_next & do_hg & (dot(si.n, dh) > 1e-7)
                 & (cos_g > 1e-7))
        wo_hg = si.frame.to_local(dh)
        f_hg, _ = bsdf_api.eval_pdf(lb, si.wi, wo_hg, hg_ok)
        pdf_hg = (pdf_a * dist_h * dist_h
                  / torch.clamp_min(torch.abs(cos_g), 1e-9))
        hg_ok = hg_ok & (pdf_hg > 1e-9)
        rcp_hg = torch.where(hg_ok, 1.0 / torch.clamp_min(pdf_hg, 1e-9), 0.0)
        w_hg = f_hg * rcp_hg[:, None]
    if hg_on and not hg_rr:  # every lane takes the hidden-geometry sample
        wo, weight, pdf_dir = wo_hg, w_hg, pdf_hg
        delta = torch.zeros_like(active_next)
        eta_s = None
    else:
        bs = bsdf_api.sample(lb, si.wi, ub[:, 6], ub[:, 7:9],
                             active_next & ~do_hg if hg_on else active_next)
        wo, weight, pdf_dir, delta, eta_s = (bs.wo, bs.weight, bs.pdf,
                                             bs.delta, bs.eta)
        if hg_on:
            wo = torch.where(do_hg[:, None], wo_hg, wo)
            weight = torch.where(do_hg[:, None], w_hg, weight)
            pdf_dir = torch.where(do_hg, pdf_hg, pdf_dir)
            delta = delta & ~do_hg
            eta_s = torch.where(do_hg, 1.0, eta_s)
    d_world = si.frame.to_world(wo)
    o_new = si.spawn_ray(d_world).o

    if d_in is None:
        beta = torch.where(active_next[:, None], beta * weight / pdf_method,
                           beta)
    else:
        beta = torch.where(active_next[:, None], _polarized_step(
            si, lb, wo, d_world, d_in, delta, weight / pdf_method, beta),
            beta)
    if eta_s is not None:
        eta = torch.where(active_next, eta * eta_s, eta)
    # Russian roulette is a detached decision: no derivative through its
    # probability or scale; a Mueller throughput's entry [0, 0] drives it
    beta_max = (beta if d_in is None else beta[0, 0]).amax(dim=-1).detach()
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp_max(beta_max * eta * eta, 0.95)
    active_next = active_next & (rr_prob > 0.0)
    if it >= icfg.rr_depth:
        rr_scale = torch.where(active_next,
                               1.0 / torch.clamp_min(rr_prob, 1e-6),
                               1.0).detach()
        beta = beta * rr_scale[:, None]
        active_next = active_next & (ub[:, 9] < rr_prob)
    return o_new, d_world, beta, eta, active_next, pdf_dir, delta


def sample_nlos_primal(
    sd: SceneData,
    ctx: NLOSContext,
    sampler: Sampler,
    ray: Ray,
    ray_weight: torch.Tensor,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    spp: int,
    skip_le: bool = False,
    lanes: ExhaustiveLaser | None = None,
    bvh_mode: str = BVH_MODE,
    polarized: bool = False,
    spectral: bool = False,
):
    """The NLOS wavefront (transientnlospath.py:672-927, primal).

    ``skip_le`` drops the emitter-hit term and its film event, valid when
    every emitter is delta (:func:`can_skip_le`).  ``lanes`` gives each
    lane its own laser constants (the confocal scan).  Returns (film, L (N,
    C), valid (N,), n_rays () int64: a closest-hit and a shadow ray per
    active lane and bounce).  The film's transient is updated in place.

    ``polarized`` carries the Mueller throughput from the sensor-alignment
    rotator about the world's up axis (the JAX package's NLOS sensors have
    no camera) and returns L (N, 4 C), Stokes-major; ``spectral`` draws
    the lanes' hero wavelengths from the sampler key and returns L in
    linear sRGB (12 channels with ``polarized``)."""
    n = ray.o.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    key = sampler.key
    account = icfg.account_first_and_last_bounces
    splat_w = (ray_weight * sample_scale)[:, None]
    sctx = None
    if spectral:
        sctx = SpectralCtx.make(key, n)
        C = N_WL

    o, d = ray.o, ray.d
    if polarized:
        beta = sensor_alignment_soa(
            d, torch.tensor([0.0, 1.0, 0.0], device=dev), C)
    else:
        beta = torch.ones((n, C), dtype=f32, device=dev)
    L = torch.zeros((n, 4 * C if polarized else C), dtype=f32, device=dev)
    eta = torch.ones((n,), dtype=f32, device=dev)
    distance = torch.zeros((n,), dtype=f32, device=dev)  # ray.time (:718)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)
    prev_p = o
    prev_pdf = torch.ones((n,), dtype=f32, device=dev)
    prev_delta = active
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    def to_film(v):
        return v if sctx is None else sctx.to_film_any(v, polarized)

    for it in range(icfg.max_depth):
        with trace.span("mitr:bounce"):
            ub = draw_bounce_block(key, it, n, NLOS_DIMS_PER_BOUNCE)
            si = ray_intersect(sd, Ray.make(o, d), active, bvh_mode)
            hit = active & si.valid
            if account or it > 0:  # the sensor->wall segment (:751-752)
                distance = distance + torch.where(hit, si.t, 0.0) * eta
            lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                           sd.bsdf_kinds)
            if sctx is not None:
                lb = sctx.uplift_lb(lb)

            if not skip_le:
                pdf_em_hit = torch.where(prev_delta, 0.0,
                                         pdf_emitter_direction(sd, prev_p, si))
                mis = mis_weight(prev_pdf, pdf_em_hit)
                Le_raw = emitter_eval_hit(sd, si, d)
                if sctx is not None:
                    Le_raw = sctx.emission(Le_raw)
                if polarized:  # unpolarized emission: column 0 of beta
                    Le = pack_stokes(beta[:, 0] * (mis[:, None] * Le_raw))
                else:
                    Le = beta * mis[:, None] * Le_raw
                Le = torch.where(hit[:, None], Le, 0.0)

            active_next = active & si.valid
            if it + 1 >= icfg.max_depth:
                active_next = torch.zeros_like(active)
            active_em = active_next & bsdf_api.is_smooth(lb)
            d_in = d if polarized else None
            if icfg.nlos_laser_sampling:
                with trace.span("mitr:laser_nee"):
                    Lr, nee_dist = _laser_nee(
                        sd, ctx, icfg, si, lb, beta, distance, eta, it,
                        active_em, account, lanes, bvh_mode, d_in, sctx)
            else:
                Lr, nee_dist = _plain_nee(
                    sd, ctx, icfg, si, lb, beta, distance, eta, it,
                    active_em, account, bvh_mode, d_in, sctx)
            if skip_le:
                film = splat_transient_pair(
                    film, film_cfg, spp, nee_dist, to_film(Lr) * splat_w, None,
                    None, active, icfg.temporal_filter, icfg.gaussian_stddev)
                L = L + Lr
            else:
                film = splat_transient_pair(
                    film, film_cfg, spp, distance, to_film(Le) * splat_w,
                    nee_dist, to_film(Lr) * splat_w, active,
                    icfg.temporal_filter, icfg.gaussian_stddev)
                L = L + Le + Lr

            o, d, beta, eta, active_next, pdf_dir, delta = _continue(
                sd, ctx, icfg, si, lb, ub, it, active_next, beta, eta, d_in)
            if not skip_le:
                prev_p = torch.where(hit[:, None], si.p, prev_p)
                prev_pdf = torch.where(active_next, pdf_dir, prev_pdf)
                prev_delta = torch.where(active_next, delta, prev_delta)
            depth = depth + hit.to(torch.int32)
            n_active = active.sum()
            n_rays = n_rays + n_active * 2
            trace.count("lanes.launched", n)
            trace.count("lanes.active", n_active)
            active = active_next
    return film, to_film(L), depth > 0, n_rays


# --------------------------------------------------------------------------
# The exhaustive capture's lasers
# --------------------------------------------------------------------------

def exhaustive_laser_targets(scene: Scene, cfg: SensorConfig,
                             icfg: IntegratorConfig, bvh_mode=BVH_MODE):
    """The exhaustive capture's illumination grid: ((L, 3) world points,
    (L,) validity).  With ``force_equal_illumination_scanning`` (default,
    transientnlospath.py:126-131) the pixel-centre grid on the relay wall
    at laser_scan_width x laser_scan_height; otherwise (:352-381) a ray
    scan from the emitter through a widened ``illumination_scan_fov``
    frustum, whose misses are invalid."""
    fcfg = cfg.film
    lw, lh = fcfg.laser_scan_width, fcfg.laser_scan_height
    if icfg.force_equal_illumination_scanning:
        t = scene.shapes[cfg.shape_index].position_from_uv(
            _pixel_uv(lw, lh)).astype(np.float32)
        return t, np.ones(t.shape[0], bool)
    sd = primal_sd(scene.data)
    em = sd.emitter
    epos = em.position[0].cpu().numpy().astype(np.float64)
    zc, xc, yc = (a[0].cpu().numpy().astype(np.float64)
                  for a in (em.direction, em.frame_s, em.frame_t))
    thf = np.tan(np.deg2rad(icfg.illumination_scan_fov) / 2.0)
    u, v = np.meshgrid(np.arange(lw) / lw, np.arange(lh) / lh)
    x = (2.0 * u.ravel() - 1.0) * thf
    y = (2.0 * v.ravel() - 1.0) * thf
    d = x[:, None] * xc + y[:, None] * yc + zc
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, prim = _scan_hit(sd, np.broadcast_to(epos, d.shape), d, bvh_mode)
    if not np.any(prim >= 0):
        raise ValueError(
            "The emitter did not intersect any geometry in the scene. "
            "Please, make sure it is properly aimed towards the desired "
            "relay surface. (transientnlospath.py:374-377)")
    if not np.all(prim >= 0):
        import logging

        logging.getLogger("mitransient_tpu_torch").warning(
            "Part of the laser scan did not intersect the scene. Results "
            "for those illumination points should be ignored. "
            "(transientnlospath.py:378-379)")
    t = np.where(prim >= 0, t, 0.0)
    return (epos + d * t[:, None]).astype(np.float32), prim >= 0


def prepare_exhaustive_lasers(scene: Scene, targets: np.ndarray,
                              bvh_mode=BVH_MODE) -> ExhaustiveLaser:
    """The wall-vertex constants of every point of ``targets`` (L, 3), each
    a refocused delta laser: one closest-hit and one occlusion query for
    all of them."""
    sd = primal_sd(scene.data)
    dev = scene.device
    L = targets.shape[0]
    epos = sd.emitter.position[0].cpu().numpy().astype(np.float32)
    to_wall = targets - epos
    dist_ew = np.linalg.norm(to_wall, axis=-1)
    d_ew = to_wall / np.maximum(dist_ew, 1e-12)[:, None]
    if sd.emitter_kinds[0] not in _DELTA:
        raise NotImplementedError(
            "fused exhaustive capture requires a delta (projector/point) "
            "laser emitter")
    o_b = torch.from_numpy(np.broadcast_to(epos, (L, 3)).copy()).to(dev)
    d_b = torch.from_numpy(d_ew.astype(np.float32)).to(dev)
    ones = torch.ones((L,), dtype=torch.bool, device=dev)
    si_w = ray_intersect(sd, Ray.make(o_b, d_b), ones, bvh_mode)
    tgt = torch.from_numpy(np.ascontiguousarray(targets, np.float32)).to(dev)
    d2 = -d_b
    dist2 = torch.from_numpy(dist_ew.astype(np.float32)).to(dev)
    occ2 = ray_test(sd, tgt + d2 * 1e-4, d2,
                    torch.clamp_min(dist2 - 2e-4, 0.0), ones, bvh_mode)
    em = (sd.emitter.radiance[0][None, :]
          / torch.clamp_min(dist2 * dist2, 1e-20)[:, None])
    return ExhaustiveLaser(
        laser_target=tgt, wall_ng=si_w.n, wall_n_sh=si_w.frame.n,
        wall_uv=si_w.uv, wall_bsdf_id=si_w.bsdf_id, wall_em=em,
        wall_dist2=dist2, wall_d2=d2, wall_clear=(~occ2) & si_w.valid)


def _laser_nee_all(sd, lasers: ExhaustiveLaser, icfg, si, lb, beta, distance,
                   eta, it, active_e, account_last: bool, bvh_mode=BVH_MODE):
    """The two-segment laser NEE from one path vertex to every laser point
    of the chunk (transientnlospath.py:597-628: the same path sample feeds
    every laser slab).  -> (Lr (Lc, N, C), splat distance (Lc, N), active
    (Lc, N)); the Lc * N vertex->wall rays go to one K2 launch."""
    n = si.t.shape[0]
    Lc = lasers.laser_target.shape[0]
    C = beta.shape[-1]
    d1v = lasers.laser_target[:, None, :] - si.p[None]  # (Lc, N, 3)
    dist1 = sqrt(torch.clamp_min(dot(d1v, d1v), 1e-20))
    d1 = d1v / dist1[..., None]
    act = active_e[None].expand(Lc, n)
    occ1 = ray_test(sd, (si.p[None] + d1 * 1e-4).reshape(Lc * n, 3),
                    d1.reshape(Lc * n, 3), (dist1 - 2e-4).reshape(Lc * n),
                    act.reshape(Lc * n), bvh_mode).reshape(Lc, n)
    act = act & ~occ1 & lasers.wall_clear[:, None]

    vframe = Frame(si.frame.s[None], si.frame.t[None], si.frame.n[None])
    lb_b = bsdf_api.map_lanes(
        lb, lambda a: a.repeat((Lc,) + (1,) * (a.dim() - 1)))
    f1, _ = bsdf_api.eval_pdf(lb_b, si.wi.repeat(Lc, 1),
                              vframe.to_local(d1).reshape(Lc * n, 3),
                              act.reshape(Lc * n))
    f1 = f1.reshape(Lc, n, C)
    act = act & (f1.amax(dim=-1) > 1e-7)
    cos_wl = dot(lasers.wall_ng[:, None, :], -d1)
    act = act & (cos_wl > 0.0)
    pdf_ls = dist1 * dist1 / torch.clamp_min(cos_wl, 1e-9)
    f1 = torch.where(act[..., None],
                     f1 / torch.clamp_min(pdf_ls, 1e-9)[..., None], 0.0)
    dist_after1 = distance[None] + torch.where(act, dist1, 0.0) * eta[None]

    wframe = Frame.from_normal(lasers.wall_n_sh)  # (Lc, 3)
    wi2 = Frame(wframe.s[:, None], wframe.t[:, None],
                wframe.n[:, None]).to_local(-d1)  # (Lc, N, 3)
    wo2 = wframe.to_local(lasers.wall_d2)  # (Lc, 3)
    act = _depth_gate(icfg, it + 2, act)
    lb2 = bsdf_api.gather_lane_bsdf(sd.bsdf, lasers.wall_bsdf_id,
                                    lasers.wall_uv, sd.bsdf_kinds)
    lb2_b = bsdf_api.map_lanes(lb2, lambda a: a.repeat_interleave(n, dim=0))
    f2, _ = bsdf_api.eval_pdf(lb2_b, wi2.reshape(Lc * n, 3),
                              wo2.repeat_interleave(n, dim=0),
                              act.reshape(Lc * n))
    Lr = torch.where(act[..., None],
                     beta[None] * f1 * f2.reshape(Lc, n, C)
                     * lasers.wall_em[:, None, :], 0.0)
    if account_last:
        dist_after1 = dist_after1 + lasers.wall_dist2[:, None] * eta[None]
    return Lr, dist_after1, act


def sample_nlos_exhaustive_primal(
    sd: SceneData,
    ctx: NLOSContext,
    lasers: ExhaustiveLaser,
    sampler: Sampler,
    ray: Ray,
    ray_weight: torch.Tensor,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    spp: int,
    hw: int,
    bvh_mode: str = BVH_MODE,
):
    """One camera wavefront feeding every laser slab of the chunk: the
    reference's per-bounce inner laser loop (transientnlospath.py:597-628)
    over a laser axis.  Path sampling does not depend on the laser, so each
    slab equals the single capture focused on its point.  ``film``'s
    transient has ``Lc * hw`` slots (slot = laser * hw + pixel); the
    emitter-hit term is skipped (a delta laser, :775).

    Returns (film, L summed over the chunk's lasers (N, C), valid,
    n_rays () int64: a closest-hit and Lc shadow rays per active lane)."""
    n = ray.o.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    key = sampler.key
    Lc = lasers.laser_target.shape[0]
    account = icfg.account_first_and_last_bounces
    splat_w = (ray_weight * sample_scale)[None, :, None]

    def arrange(a):
        """(Lc, N = spp * hw, ...) -> flat spp-major over the Lc * hw slots:
        lane s * (Lc * hw) + l * hw + p."""
        rest = a.shape[2:]
        return a.reshape((Lc, spp, hw) + rest).transpose(0, 1).reshape(
            (spp * Lc * hw,) + rest)

    o, d = ray.o, ray.d
    beta = torch.ones((n, C), dtype=f32, device=dev)
    L = torch.zeros((n, C), dtype=f32, device=dev)
    eta = torch.ones((n,), dtype=f32, device=dev)
    distance = torch.zeros((n,), dtype=f32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(icfg.max_depth):
        ub = draw_bounce_block(key, it, n, NLOS_DIMS_PER_BOUNCE)
        si = ray_intersect(sd, Ray.make(o, d), active, bvh_mode)
        hit = active & si.valid
        if account or it > 0:
            distance = distance + torch.where(hit, si.t, 0.0) * eta
        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                       sd.bsdf_kinds)
        active_next = active & si.valid
        if it + 1 >= icfg.max_depth:
            active_next = torch.zeros_like(active)
        active_em = active_next & bsdf_api.is_smooth(lb)

        Lr_all, nee_dist, act_all = _laser_nee_all(
            sd, lasers, icfg, si, lb, beta, distance, eta, it, active_em,
            account, bvh_mode)
        film = splat_transient_flat(film, film_cfg, spp, arrange(nee_dist),
                                    arrange(Lr_all * splat_w),
                                    arrange(act_all))
        L = L + Lr_all.sum(dim=0)

        o, d, beta, eta, active_next, _pdf, _delta = _continue(
            sd, ctx, icfg, si, lb, ub, it, active_next, beta, eta)
        depth = depth + hit.to(torch.int32)
        n_rays = n_rays + active.sum() * (1 + Lc)
        active = active_next
    return film, L, depth > 0, n_rays


# --------------------------------------------------------------------------
# Renders
# --------------------------------------------------------------------------

def film_channels(variant) -> int:
    """The film's channels: the variant's colors, times 4 Stokes
    components under a polarized variant."""
    return variant.color_channels * (4 if variant.polarized else 1)


def _nlos_pass(sd, ctx, film, key, inv_total, *, film_cfg, icfg, spp, hw,
               skip_le, lanes=None, bvh_mode=BVH_MODE, variant):
    """One pass of ``spp`` samples a scan pixel on the stream key ``key``
    -> (film, n_rays).  With ``lanes`` (one row per scan point, the
    confocal scan) every lane's sensor ray aims at its own point and its
    NEE at its own laser."""
    n = spp * hw
    dev = ctx.sensor_origin.device
    sampler = Sampler.on(key, n)
    if lanes is None:
        ray, ray_weight = sample_nlos_rays(ctx, spp, hw)
    else:  # lanes are spp-major: lane s * hw + p takes row p
        lanes = ExhaustiveLaser(*(a.repeat((spp,) + (1,) * (a.dim() - 1))
                                  for a in lanes))
        o = ctx.sensor_origin.expand(n, 3).contiguous()
        ray = Ray.make(o, normalize(lanes.laser_target - o))
        ray_weight = torch.ones((n,), dtype=torch.float32, device=dev)
    film, L, _valid, n_rays = sample_nlos_primal(
        sd, ctx, sampler, ray, ray_weight, film, film_cfg, icfg, inv_total,
        spp, skip_le=skip_le, lanes=lanes, bvh_mode=bvh_mode,
        polarized=variant.polarized, spectral=variant.spectral)
    return splat_steady(film, spp, L, ray_weight), n_rays


def render_nlos(scene: Scene, spp=None, seed=0, sensor=0,
                max_lanes=DEFAULT_MAX_LANES, progress_callback=None,
                return_stats: bool = False, bvh_mode: str = BVH_MODE):
    """NLOS render (single or confocal capture; an exhaustive capture goes
    to :func:`render_nlos_exhaustive`): the spp budget split into passes of
    at most ``max_lanes`` lanes.  Returns (steady (H, W, C), transient (H,
    W, T, C)) on the scene's device, and with ``return_stats`` ``rays``
    (int64), ``spp`` and ``loop_iters`` (bounces run, one K1-K3 launch
    each)."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if film_cfg.is_cropped:
        raise NotImplementedError(
            "NLOS capture films do not support crop windows")
    if icfg.camera_unwarp:
        raise ValueError("Do not use camera_unwarp with transient_nlos_path; "
                         "use account_first_and_last_bounces "
                         "(transientnlospath.py:725-727)")
    spp = spp if spp is not None else cfg.spp
    if icfg.capture_type == "exhaustive":
        return render_nlos_exhaustive(
            scene, spp=spp, seed=seed, sensor=sensor, max_lanes=max_lanes,
            progress_callback=progress_callback, return_stats=return_stats,
            bvh_mode=bvh_mode)
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    ctx = prepare_nlos(scene, cfg, bvh_mode)
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)
    skip_le = can_skip_le(scene.data)
    body = functools.partial(
        _nlos_pass, film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw,
        skip_le=skip_le, bvh_mode=bvh_mode, variant=scene.variant)
    film, total_rays = passgraph.run_passes(
        body, primal_sd(scene.data), ctx,
        film_init(film_cfg, film_channels(scene.variant), scan_pixels=hw,
                  device=scene.device),
        seed=seed, first=0, n_passes=n_passes, scale=1.0 / total_spp,
        progress_callback=progress_callback)
    steady, transient = develop(film, film_cfg, shape_hw=(h, w))
    extra = surface_sample_validation(film, film_cfg)
    if return_stats:
        return steady, transient, {"rays": total_rays, "spp": total_spp,
                                   "loop_iters": n_passes * icfg.max_depth,
                                   **extra}
    return steady, transient


def render_nlos_confocal_scan(scene: Scene, spp=None, seed=0, sensor=0,
                              max_lanes=DEFAULT_MAX_LANES,
                              progress_callback=None,
                              return_stats: bool = False,
                              bvh_mode: str = BVH_MODE):
    """Every point of a confocal scan in one wavefront a pass, each lane
    with the focused-laser constants of its scan point (the reference's
    loop of focus + render, 1-simple-nlos-scenes.ipynb confocal cell, with
    the same estimator a point).  Returns (steady (ph, pw, C), transient
    (ph, pw, T, C)) over the scan grid (``original_film_width/height``)."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if not cfg.is_confocal:
        raise ValueError("render_nlos_confocal_scan needs an "
                         "nlos_capture_meter with original_film_width/"
                         "height (confocal mode)")
    if not icfg.nlos_laser_sampling:
        raise ValueError("the batched confocal scan requires "
                         "nlos_laser_sampling=True")
    pw, ph = cfg.scan_size
    hw = pw * ph
    spp = spp if spp is not None else cfg.spp
    targets = scene.shapes[cfg.shape_index].position_from_uv(
        _pixel_uv(pw, ph)).astype(np.float32)
    lanes = prepare_exhaustive_lasers(scene, targets, bvh_mode)
    if not scene.laser_focused:
        from ..nlos import focus_emitter_at_relay_wall_3dpoint

        focus_emitter_at_relay_wall_3dpoint(targets[hw // 2], scene)
    ctx = prepare_nlos(scene, cfg, bvh_mode)
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)
    body = functools.partial(
        _nlos_pass, film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw,
        skip_le=True, lanes=lanes, bvh_mode=bvh_mode, variant=scene.variant)
    film, total_rays = passgraph.run_passes(
        body, primal_sd(scene.data), ctx,
        film_init(film_cfg, film_channels(scene.variant), scan_pixels=hw,
                  device=scene.device),
        seed=seed, first=0, n_passes=n_passes, scale=1.0 / total_spp,
        progress_callback=progress_callback)
    steady, transient = develop(film, film_cfg, shape_hw=(ph, pw))
    if return_stats:
        return steady, transient, {"rays": total_rays, "spp": total_spp,
                                   "loop_iters": n_passes * icfg.max_depth}
    return steady, transient


def _check_exhaustive(film_cfg: FilmConfig) -> None:
    if not film_cfg.exhaustive_scan:
        raise ValueError("exhaustive capture requires a film with "
                         "exhaustive_scan=True (transient_hdr_film.py:80-88)")
    if film_cfg.laser_scan_width <= 0 or film_cfg.laser_scan_height <= 0:
        raise ValueError("laser_scan_width/height must be set for "
                         "exhaustive captures")


def render_nlos_exhaustive(scene: Scene, spp, seed=0, sensor=0,
                           max_lanes=DEFAULT_MAX_LANES,
                           progress_callback=None,
                           return_stats: bool = False,
                           laser_chunk: int | None = None,
                           bvh_mode: str = BVH_MODE):
    """Exhaustive capture: every scan pixel x every laser point
    (transientnlospath.py:597-628, the 6-D film of
    transient_image_block.py:63-68).  Returns (steady (h, w, C), transient
    (h, w, lh, lw, T, C)) on the scene's device.

    One camera wavefront a pass feeds a chunk of ``laser_chunk`` laser
    points (by default as many as keep Lc x lanes within 2^24); the film
    is ``(chunks, C, T + 1, Lc * hw)``, so each chunk's slots are one
    contiguous film for K3.  Without laser sampling, with an emitter that
    is not delta, or under a polarized or spectral variant, each laser
    point is rendered as a focused single capture instead
    (:func:`_render_nlos_exhaustive_perpoint`), as in the JAX package."""
    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    icfg = scene.integrator
    _check_exhaustive(film_cfg)
    sd = primal_sd(scene.data)
    if (scene.variant.polarized or scene.variant.spectral
            or not can_skip_le(sd) or not icfg.nlos_laser_sampling):
        return _render_nlos_exhaustive_perpoint(
            scene, spp, seed=seed, sensor=sensor, max_lanes=max_lanes,
            progress_callback=progress_callback, return_stats=return_stats,
            bvh_mode=bvh_mode)
    dev = scene.device
    targets, tvalid = exhaustive_laser_targets(scene, cfg, icfg, bvh_mode)
    lasers = prepare_exhaustive_lasers(scene, targets, bvh_mode)
    lasers = lasers._replace(
        wall_clear=lasers.wall_clear & torch.from_numpy(tvalid).to(dev))
    L = targets.shape[0]
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    C = scene.variant.color_channels
    T = film_cfg.temporal_bins
    if not scene.laser_focused:
        # prepare needs a valid focus; the single-laser fields go unused
        from ..nlos import focus_emitter_at_relay_wall_3dpoint

        focus_emitter_at_relay_wall_3dpoint(targets[int(np.argmax(tvalid))],
                                            scene)
    ctx = prepare_nlos(scene, cfg, bvh_mode)
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)
    if laser_chunk is None:
        laser_chunk = max(1, min(L, LANE_LASER_PAIRS // (spp_chunk * hw)))
    Lc = laser_chunk
    n_chunks = (L + Lc - 1) // Lc
    pad = n_chunks * Lc - L
    if pad:  # padded rows repeat the last and contribute nothing
        lasers = ExhaustiveLaser(*(torch.cat([a, a[-1:].repeat(
            (pad,) + (1,) * (a.dim() - 1))]) for a in lasers))
        lasers.wall_clear[L:] = False

    f32 = torch.float32
    transient = torch.zeros((n_chunks, C, T + 1, Lc * hw), dtype=f32,
                            device=dev)
    film = TransientFilmState(
        steady=torch.zeros((hw, C), dtype=f32, device=dev),
        steady_weight=torch.zeros((hw,), dtype=f32, device=dev),
        transient=transient[0],
        n_negative=torch.zeros((), dtype=f32, device=dev),
        n_invalid=torch.zeros((), dtype=f32, device=dev))
    total_rays = 0
    keys = pass_keys(seed, range(n_passes), dev)
    for c in range(n_chunks):
        lasers_c = ExhaustiveLaser(*(a[c * Lc:(c + 1) * Lc] for a in lasers))
        film = film._replace(transient=transient[c])
        for p in range(n_passes):
            sampler = Sampler.on(keys[p], spp_chunk * hw)
            ray, ray_weight = sample_nlos_rays(ctx, spp_chunk, hw)
            film, L_sum, _valid, n_rays = sample_nlos_exhaustive_primal(
                sd, ctx, lasers_c, sampler, ray, ray_weight, film, film_cfg,
                icfg, 1.0 / total_spp, spp_chunk, hw, bvh_mode)
            # the steady image is the mean over all lasers: each chunk adds
            # its partial sum with weight 1 / n_chunks
            film = splat_steady(film, spp_chunk, L_sum * (n_chunks / L),
                                ray_weight / n_chunks)
            total_rays = total_rays + n_rays
            if progress_callback is not None:
                progress_callback((c * n_passes + p + 1)
                                  / (n_chunks * n_passes))

    wgt = torch.where(film.steady_weight == 0.0, 1.0, film.steady_weight)
    steady = (film.steady / wgt[:, None]).reshape(h, w, C)
    out = (transient[:, :, :T].reshape(n_chunks, C, T, Lc, hw)
           .permute(4, 0, 3, 2, 1).reshape(hw, n_chunks * Lc, T, C)[:, :L]
           .reshape(h, w, lh, lw, T, C))
    if return_stats:
        return steady, out, {"rays": total_rays, "spp": spp * L,
                             "loop_iters": n_chunks * n_passes
                             * icfg.max_depth}
    return steady, out


def _render_nlos_exhaustive_perpoint(scene: Scene, spp, seed=0, sensor=0,
                                     max_lanes=DEFAULT_MAX_LANES,
                                     progress_callback=None,
                                     return_stats: bool = False,
                                     bvh_mode: str = BVH_MODE):
    """Exhaustive capture by laser point: each point of the wall grid
    rendered as a focused single capture with the same seed (the
    estimator of the reference's inner laser loop as an outer loop; laser
    (lx, ly) lands in slab [:, :, ly, lx])."""
    from ..nlos import focus_emitter_at_relay_wall_3dpoint

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    _check_exhaustive(film_cfg)
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    laser_targets = scene.shapes[cfg.shape_index].position_from_uv(
        _pixel_uv(lw, lh)).astype(np.float32)
    h, w = film_cfg.height, film_cfg.width
    C = film_channels(scene.variant)
    T = film_cfg.temporal_bins
    out = torch.zeros((h, w, lh, lw, T, C), device=scene.device)
    steady_acc = torch.zeros((h, w, C), device=scene.device)
    total_rays = 0
    n_pts = lh * lw
    saved_icfg = scene.integrator
    scene.integrator = saved_icfg._replace(capture_type="single")
    try:
        for i in range(n_pts):
            focus_emitter_at_relay_wall_3dpoint(laser_targets[i], scene)
            s, t, stats = render_nlos(scene, spp=spp, seed=seed,
                                      sensor=sensor, max_lanes=max_lanes,
                                      return_stats=True, bvh_mode=bvh_mode)
            ly, lx = divmod(i, lw)
            out[:, :, ly, lx] = t
            steady_acc += s / n_pts  # the mean over laser points (:628)
            total_rays = total_rays + stats["rays"]
            if progress_callback is not None:
                progress_callback((i + 1) / n_pts)
    finally:
        scene.integrator = saved_icfg
    if return_stats:
        return steady_acc, out, {"rays": total_rays, "spp": spp * n_pts}
    return steady_acc, out
