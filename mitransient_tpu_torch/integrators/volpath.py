"""Transient volumetric path tracer, one wavefront a pass (counterpart of
``mitransient_tpu/integrators/volpath.py``, ``transient_prbvolpath``).

Path tracing through participating media that fill the interiors of
shapes with null BSDFs: free-flight sampling in the current medium (the
closed-form exponential sample for homogeneous media, delta tracking
against the majorant for grid media), Henyey-Greenstein phase
scattering, NEE from medium and surface vertices with the transmittance
of the shadow ray, and the optical path length of both event kinds in
the transient film.  Each lane carries its current medium as a row of
the medium table (-1 = vacuum), switched where it crosses a null
boundary, by the sign of dot(d, n).

Each bounce launches the closest-hit query (K1, or the BVH kernel in
scenes with an accel) 1 + ``TRANSMITTANCE_STEPS`` times: once for the
path ray and once for each step of the shadow ray's walk through null
boundaries (:func:`transmittance`, which uses closest hits, not the
any-hit query), and one two-event film splat (K3).  ``camera_unwarp``
adds up to 8 closest-hit launches a pass (:func:`first_surface_distance`).

RNG: each bounce draws its 8 sampler dimensions as one threefry block
(``draw_bounce_block(key, it, n, 8)``), in the JAX column order: free
flight 0, NEE 1-2, BSDF lobe 3, direction 4-5 (the HG sample shares
them), Russian roulette 7.  Grid media draw their tracking numbers from
their own streams, ``fold_in(key, 0x6D50 + tag)``: ``(n, 32, 2)`` for a
free flight (tag = bounce), ``(n, 16)`` for each shadow-ray segment (tag
= 1000 + 4 * bounce + step), in fixed trips of masked steps as in the
JAX package, so that every stream stays aligned.

Variants, as the JAX package renders them: under a polarized variant the
throughput is a full Mueller matrix in the structured layout of
``core/mueller.py`` (no pending rotator), which starts as the
sensor-alignment rotator about the camera's up axis; a surface bounce
multiplies it by the polarization factor times the BSDF weight, an HG
scatter is an ideal depolarizer (column 0 times the albedo), and NEE
takes column 0 of the surface's factor or of the throughput times the
phase value.  Under a spectral variant each lane carries ``N_WL`` hero
wavelengths: the medium's albedo, the BSDF rows and the emitter terms are
uplifted to them (``sigma_t`` stays achromatic) and the splats convert to
sRGB.

Sampling is detached: the free-flight distance carries no derivative.
For homogeneous media an attached survival ratio, exactly 1 in value,
gives sigma_t its derivative (the JAX package's ``volpath.py:387-408``);
the NEE transmittance is attached through sigma_t.  The JAX loop counts
rays in float32; this one counts them in int64, by the same rule (1 +
``TRANSMITTANCE_STEPS`` per active lane a bounce).  Where the JAX
package gathers table rows by one-hot matmuls (``columns_lookup``),
this uses ``index_select``, and ``ops.gather.gather_rows`` for the
albedo and extinction tables, whose gradients it adds in a fixed order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bsdf import api as bsdf_api
from ..bsdf.polarized import (
    polarization_factor_col0_soa,
    polarization_factor_soa,
    sensor_alignment_soa,
)
from ..core.frame import Frame
from ..core.math import dot, exp, log, mis_weight
from ..core.mueller import msoa_depolarize_cols, msoa_matvec, msoa_product
from ..core.records import Ray
from ..core.rng import Sampler, draw_bounce_block, uniform
from ..core.spectra import N_WL, SpectralCtx
from ..core.warp import hg_pdf, square_to_hg
from ..film.transient_film import splat_pair_any
from ..ops.bvh import BVH_MODE
from ..ops.gather import gather_rows
from ..scene.scene import (
    BSDF_NULL,
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig
from .path import _half_vector_cos, pack_stokes

VOL_DIMS_PER_BOUNCE = 8
TRANSMITTANCE_STEPS = 4  # null-boundary crossings along a shadow ray
DELTA_STEPS = 32  # majorant-sampled candidates of a grid free flight
RATIO_STEPS = 16  # ratio-tracking taps of a grid shadow-ray segment
GRID_STREAM_TAG = 0x6D50  # the tracking loops' threefry sub-streams
TRACKING_DRAW_LANES = 1 << 18  # lanes per slice of a tracking draw


def first_surface_distance(sd: SceneData, ray: Ray, max_hops: int = 8,
                           bvh_mode: str = BVH_MODE) -> torch.Tensor:
    """Distance along each camera ray to the first non-null surface,
    through at most ``max_hops`` null (medium-boundary) surfaces: the
    ``camera_unwarp`` time origin.  Stops early once no lane crosses a
    null surface."""
    n = ray.o.shape[0]
    o = ray.o
    dist = torch.zeros((n,), dtype=torch.float32, device=o.device)
    act = torch.ones((n,), dtype=torch.bool, device=o.device)
    for _ in range(max_hops):
        si = ray_intersect(sd, Ray.make(o, ray.d), act, bvh_mode)
        ok = act & si.valid
        dist = dist + torch.where(ok, si.t, 0.0)
        kind = sd.bsdf.kind.index_select(0, torch.clamp_min(si.bsdf_id, 0))
        act = ok & (kind == BSDF_NULL)
        if not bool(act.any()):
            break
        o = torch.where(act[:, None], si.p + ray.d * 2e-4, o)
    return dist


def has_grids(sd: SceneData) -> bool:
    """Does any medium carry a density grid (known from the table's
    shape)?"""
    return tuple(sd.medium.grid.shape[1:]) != (1, 1, 1)


def density(sd: SceneData, med_id: torch.Tensor,
            p: torch.Tensor) -> torch.Tensor:
    """Trilinear density of each lane's medium at world point ``p`` (N, 3)
    -> (N,); the grid coordinates clamp to [0, 1]^3."""
    med = sd.medium
    m = torch.clamp_min(med_id, 0)
    a = med.grid_w2l.index_select(0, m)  # (N, 3, 4)
    local = [a[:, i, 0] * p[:, 0] + a[:, i, 1] * p[:, 1]
             + a[:, i, 2] * p[:, 2] + a[:, i, 3] for i in range(3)]
    gz, gy, gx = med.grid.shape[1:]

    def corner(coord, size):
        f = torch.clamp(coord, 0.0, 1.0) * (size - 1)
        i0 = torch.clamp(torch.floor(f).to(torch.int32), 0, max(size - 2, 0))
        return i0, torch.clamp_max(i0 + 1, size - 1), f - i0.to(f.dtype)

    x0, x1, tx = corner(local[0], gx)
    y0, y1, ty = corner(local[1], gy)
    z0, z1, tz = corner(local[2], gz)
    flat = med.grid.reshape(-1)
    base = m.to(torch.int64) * (gz * gy * gx)

    def tap(z, y, x):
        return flat.index_select(
            0, base + (z.to(torch.int64) * gy + y) * gx + x)

    c00 = tap(z0, y0, x0) * (1 - tx) + tap(z0, y0, x1) * tx
    c01 = tap(z0, y1, x0) * (1 - tx) + tap(z0, y1, x1) * tx
    c10 = tap(z1, y0, x0) * (1 - tx) + tap(z1, y0, x1) * tx
    c11 = tap(z1, y1, x0) * (1 - tx) + tap(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def tracking_draw(key, tag: int, n: int, tail: tuple) -> torch.Tensor:
    """``jax.random.uniform(fold_in(key, 0x6D50 + tag), (n, *tail))`` on
    ``key``'s device, drawn in slices of ``TRACKING_DRAW_LANES`` lanes (the
    same bits) so that the threefry's int64 temporaries stay small."""
    dim = GRID_STREAM_TAG + tag
    shape = (n,) + tuple(tail)
    if n <= TRACKING_DRAW_LANES:
        return uniform(key, dim, shape)
    return torch.cat([
        uniform(key, dim, shape, rows=(r, min(r + TRACKING_DRAW_LANES, n)))
        for r in range(0, n, TRACKING_DRAW_LANES)])


def _free_path(u: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """-log(1 - u) / rate, each operation rounded on its own."""
    return -log(torch.clamp_min(1.0 - u, 1e-30)) / torch.clamp_min(rate,
                                                                   1e-30)


def delta_track_flight(sd: SceneData, key, tag: int, med_id, in_medium, o,
                       d, t_surf, active) -> torch.Tensor:
    """Grid-medium free flight by delta (Woodcock) tracking against each
    medium's majorant, ``DELTA_STEPS`` masked steps -> t_fly (N,), inf
    where the lane leaves the medium (or stays unresolved: probability
    (1 - min density)^32, biased toward transparency), as the JAX
    package's ``_delta_track_flight``.  The steps stop early once every
    lane is resolved (the draw is made whole, so streams stay aligned)."""
    n = med_id.shape[0]
    m = torch.clamp_min(med_id, 0)
    maj = torch.where(in_medium, sd.medium.majorant.index_select(0, m), 0.0)
    scale = gather_rows(sd.medium.sigma_t, m)
    walk = active & in_medium & (maj > 0.0)
    inf = torch.full((n,), float("inf"), dtype=torch.float32,
                     device=o.device)
    if not bool(walk.any()):
        return inf
    u = tracking_draw(key, tag, n, (DELTA_STEPS, 2))
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    done = ~walk
    for i in range(DELTA_STEPS):
        if bool(done.all()):
            break
        tt = t + _free_path(u[:, i, 0], maj)
        escaped = tt >= t_surf
        dens = density(sd, med_id, o + d * tt[:, None])
        real = u[:, i, 1] * maj < scale * dens
        t = torch.where(done, t, tt)
        done = done | escaped | real
    return torch.where(walk & done, t, inf)


def segment_transmittance(sd: SceneData, key, tag: int, med_id, o, d, seg,
                          active) -> torch.Tensor:
    """Transmittance of one shadow-ray segment (N,): exp(-sigma_t * seg)
    in homogeneous scenes, one-sample ratio tracking against the majorant
    (``RATIO_STEPS`` masked taps, stream ``tag``) in grid scenes."""
    m = torch.clamp_min(med_id, 0)
    in_medium = med_id >= 0
    if not has_grids(sd):
        sigma_t = torch.where(in_medium, gather_rows(sd.medium.sigma_t, m),
                              0.0)
        return exp(-sigma_t * torch.where(active, seg, 0.0))
    n = med_id.shape[0]
    maj = torch.where(in_medium, sd.medium.majorant.index_select(0, m), 0.0)
    walk = active & in_medium & (maj > 0.0)
    ones = torch.ones((n,), dtype=torch.float32, device=o.device)
    if not bool(walk.any()):
        return ones
    scale = gather_rows(sd.medium.sigma_t, m)
    u = tracking_draw(key, tag, n, (RATIO_STEPS,))
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    T = ones
    maj_safe = torch.clamp_min(maj, 1e-30)
    for i in range(RATIO_STEPS):
        tt = t + _free_path(u[:, i], maj)
        inside = tt < seg
        dens = density(sd, med_id, o + d * tt[:, None])
        ratio = torch.clamp(1.0 - scale * dens / maj_safe, 0.0, 1.0)
        T = T * torch.where(inside & (maj > 0.0), ratio, 1.0)
        t = torch.where(inside, tt, t)
    return torch.where(walk, T, 1.0)


def medium_lookup(sd: SceneData, med_id: torch.Tensor):
    """Each lane's medium -> (sigma_t (0 in vacuum), albedo (N, C), g,
    in_medium)."""
    med = sd.medium
    i = torch.clamp_min(med_id, 0)
    in_medium = med_id >= 0
    sigma_t = torch.where(in_medium, gather_rows(med.sigma_t, i), 0.0)
    return (sigma_t, gather_rows(med.albedo, i), med.g.index_select(0, i),
            in_medium)


def transition(sd: SceneData, si, d: torch.Tensor) -> torch.Tensor:
    """The medium beyond a null boundary: the shape's interior medium when
    entering (dot(d, n) < 0), vacuum (-1) when leaving."""
    tri_med = sd.tri.medium_id.index_select(0, torch.clamp_min(si.prim, 0))
    return torch.where(dot(d, si.n) < 0.0, tri_med, -1)


def transmittance(sd: SceneData, o, d_unit, dist, start_med, active,
                  key=None, tag: int = 0, bvh_mode: str = BVH_MODE):
    """Transmittance along shadow rays through up to
    ``TRANSMITTANCE_STEPS`` null boundaries, switching media at each ->
    (T (N,), occluded (N,)).  Every step launches one closest-hit query;
    a lane still walking after the last step counts as occluded.  Grid
    segments need ``key`` (ratio tracking)."""
    return shadow_walk(sd, o, d_unit, dist, start_med, active, key, tag,
                       bvh_mode)[:2]


def shadow_walk(sd: SceneData, o, d_unit, dist, start_med, active, key,
                tag: int, bvh_mode: str):
    """:func:`transmittance`, and the walk's segments: a (medium, length,
    walking) triple a step, from which :func:`segments_transmittance`
    recomputes T without ray queries."""
    n = dist.shape[0]
    segs = []
    T = torch.ones((n,), dtype=torch.float32, device=o.device)
    med = start_med
    t_done = torch.zeros((n,), dtype=torch.float32, device=o.device)
    occluded = torch.zeros((n,), dtype=torch.bool, device=o.device)
    walking = active
    for step in range(TRANSMITTANCE_STEPS):
        o_cur = o + d_unit * t_done[:, None]
        remaining = dist - t_done
        si = ray_intersect(sd, Ray.make(o_cur + d_unit * 1e-4, d_unit,
                                        maxt=remaining - 2e-4),
                           walking, bvh_mode)
        seg = torch.where(si.valid, si.t, torch.clamp_min(remaining, 0.0))
        T_seg = segment_transmittance(
            sd, key, 1000 + tag * TRANSMITTANCE_STEPS + step, med, o_cur,
            d_unit, seg, walking)
        T = T * torch.where(walking, T_seg, 1.0)
        segs.append((med, seg, walking))
        kind = sd.bsdf.kind.index_select(0, torch.clamp_min(si.bsdf_id, 0))
        cross = walking & si.valid & (kind == BSDF_NULL)
        occluded = occluded | (walking & si.valid & ~cross)
        med = torch.where(cross, transition(sd, si, d_unit), med)
        t_done = t_done + torch.where(si.valid, si.t + 1e-4, remaining)
        walking = cross
    return T, occluded | walking, segs


def segments_transmittance(sigma_t_table: torch.Tensor, segs) -> torch.Tensor:
    """A homogeneous scene's shadow-ray transmittance from the segments of
    its walk (:func:`shadow_walk`) and the extinction table: the walk's T
    bit for bit, attached to the table."""
    T = None
    for med, seg, walking in segs:
        sigma_t = torch.where(
            med >= 0, gather_rows(sigma_t_table, torch.clamp_min(med, 0)),
            0.0)
        T_seg = torch.where(walking, exp(-sigma_t * torch.where(walking, seg,
                                                                 0.0)), 1.0)
        T = T_seg if T is None else T * T_seg
    return T


def free_flight(sd: SceneData, key, it: int, u_ff, med_id, sigma_t,
                in_medium, o, d, t_surf, active) -> torch.Tensor:
    """The bounce's sampled free-flight distance in the current medium
    (detached; inf in vacuum): closed form for homogeneous media, delta
    tracking for grids."""
    if has_grids(sd):
        t = delta_track_flight(sd, key, it, med_id, in_medium, o, d, t_surf,
                               active)
    else:
        t = torch.where(in_medium & (sigma_t > 0.0), _free_path(u_ff, sigma_t),
                        float("inf"))
    return t.detach()


def survival_ratio(sigma_t, t_event, medium_scatter, in_medium, hit):
    """The attached free-flight weight of homogeneous media: sigma_t
    e^(-sigma_t t) over its detached value at a medium scatter, e^(-sigma_t
    t) over its detached value where the flight reaches a surface through
    the medium, 1 elsewhere.  Its value is exactly 1; only its derivative
    (in sigma_t) is not zero."""
    lam = sigma_t.detach()
    t_det = t_event.detach()
    decay = exp(-(sigma_t - lam) * torch.where(torch.isfinite(t_det), t_det,
                                               0.0))
    r_scatter = sigma_t / torch.clamp_min(lam, 1e-30) * decay
    return torch.where(medium_scatter, r_scatter,
                       torch.where(in_medium & hit, decay, 1.0))


class VolState(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    beta: torch.Tensor  # (N, C); polarized: the structured (4, 4, N, C)
    L: torch.Tensor  # (N, C); polarized: (N, 4 C), Stokes-major
    eta: torch.Tensor  # (N,)
    distance: torch.Tensor  # (N,) accumulated OPL
    active: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) int32 - scattering events
    medium: torch.Tensor  # (N,) int32 current medium, -1 = vacuum
    prev_p: torch.Tensor  # (N, 3) the last scattering vertex
    prev_pdf: torch.Tensor  # (N,)
    prev_delta: torch.Tensor  # (N,) bool
    film: tuple
    n_rays: torch.Tensor  # () int64


class Vertex(NamedTuple):
    """What a bounce of the primal and of PRB's replay sweep both compute
    from the incoming state before the contributions: the hit, the free
    flight, the event and its medium, the NEE sample with its
    transmittance, the detached MIS weights and the direction samples."""

    si: object  # SurfaceInteraction
    hit: torch.Tensor
    in_medium: torch.Tensor
    sigma_t: torch.Tensor  # (N,) the current medium's, 0 in vacuum
    med_albedo: torch.Tensor  # (N, C) the current medium's table row
    medium_scatter: torch.Tensor
    scatter_event: torch.Tensor
    t_event: torch.Tensor
    p_event: torch.Tensor
    distance: torch.Tensor
    lb: object  # LaneBSDF
    mis: torch.Tensor
    le_mask: torch.Tensor
    active_next: torch.Tensor
    active_em: torch.Tensor
    ds: object  # DirectionSample
    em_weight: torch.Tensor
    trans: torch.Tensor
    trans_segs: list  # the shadow walk's (medium, length, walking) a step
    f_phase: torch.Tensor  # (N, C)
    f_srf: torch.Tensor  # (N, C) the BSDF toward the NEE sample
    wo_em: torch.Tensor
    mis_em: torch.Tensor
    d_hg: torch.Tensor
    pdf_hg: torch.Tensor
    bs: object  # BSDFSample
    new_med: torch.Tensor


def trace_vertex(sd: SceneData, key, it: int, ub, st, icfg: IntegratorConfig,
                 bvh_mode: str, sctx: SpectralCtx | None = None) -> Vertex:
    """One bounce's path query, free flight, NEE sample (with the shadow
    ray's transmittance walk) and direction samples, from the state ``st``
    (any record with ``o``, ``d``, ``eta``, ``distance``, ``active``,
    ``medium``, ``prev_p``, ``prev_pdf``, ``prev_delta``).  The random
    decisions are the JAX package's, from the bounce block ``ub``.
    ``sctx`` uplifts the medium's albedo, the BSDF rows and the NEE
    emitter term to the lanes' wavelengths."""
    n = ub.shape[0]
    active = st.active
    si = ray_intersect(sd, Ray.make(st.o, st.d), active, bvh_mode)
    hit = active & si.valid

    # ---- free flight in the current medium (dim 0)
    sigma_t, med_albedo, med_g, in_medium = medium_lookup(sd, st.medium)
    if sctx is not None:
        med_albedo = sctx.uplift(med_albedo)
    t_fly = free_flight(sd, key, it, ub[:, 0], st.medium, sigma_t, in_medium,
                        st.o, st.d, torch.where(hit, si.t, float("inf")),
                        active)
    medium_scatter = hit & in_medium & (t_fly < si.t)
    t_event = torch.where(medium_scatter, t_fly, torch.where(hit, si.t, 0.0))
    p_event = st.o + st.d * t_event[:, None]
    distance = st.distance + torch.where(active, t_event, 0.0) * st.eta

    lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv, sd.bsdf_kinds)
    if sctx is not None:
        lb = sctx.uplift_lb(lb)
    null_srf = bsdf_api.is_null(lb) & ~medium_scatter

    # ---- the emitter hit's MIS weight (surfaces only)
    pdf_em_hit = torch.where(st.prev_delta, 0.0,
                             pdf_emitter_direction(sd, st.prev_p, si))
    mis = mis_weight(st.prev_pdf, pdf_em_hit)
    le_mask = hit & ~medium_scatter & (not icfg.discard_direct_light)

    # ---- NEE (dims 1-2) from medium points (phase) or surfaces
    active_next = active & si.valid
    if it + 1 >= icfg.max_depth:
        active_next = torch.zeros_like(active)
    scatter_event = medium_scatter | (hit & ~null_srf)
    active_em = active_next & scatter_event & (medium_scatter
                                               | bsdf_api.is_smooth(lb))
    ds, em_weight = sample_emitter_direction(sd, p_event, ub[:, 1:3], False,
                                             active_em, bvh_mode)
    if sctx is not None:
        em_weight = sctx.emission(em_weight)
    active_em = active_em & (ds.pdf > 0.0)
    trans, occ, segs = shadow_walk(sd, p_event, ds.d, ds.dist, st.medium,
                                   active_em, key, it, bvh_mode)
    active_em = active_em & ~occ
    pdf_phase = hg_pdf(dot(st.d, ds.d), med_g)
    wo_em = si.frame.to_local(ds.d)
    f_srf, pdf_srf = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
    mis_em = torch.where(ds.delta, 1.0, mis_weight(
        ds.pdf, torch.where(medium_scatter, pdf_phase, pdf_srf)))

    # ---- direction samples (dims 3-5): HG about d, or the BSDF
    d_hg_local, pdf_hg = square_to_hg(ub[:, 4:6], med_g)
    d_hg = Frame.from_normal(st.d).to_world(d_hg_local)
    bs = bsdf_api.sample(lb, si.wi, ub[:, 3], ub[:, 4:6],
                         active_next & ~medium_scatter)
    new_med = torch.where(hit & ~medium_scatter & bsdf_api.is_null(lb),
                          transition(sd, si, st.d), st.medium)
    C = med_albedo.shape[-1]
    return Vertex(
        si=si, hit=hit, in_medium=in_medium, sigma_t=sigma_t,
        med_albedo=med_albedo,
        medium_scatter=medium_scatter, scatter_event=scatter_event,
        t_event=t_event, p_event=p_event, distance=distance, lb=lb, mis=mis,
        le_mask=le_mask, active_next=active_next, active_em=active_em, ds=ds,
        em_weight=em_weight, trans=trans, trans_segs=segs,
        f_phase=pdf_phase[:, None].expand(n, C), f_srf=f_srf, wo_em=wo_em,
        mis_em=mis_em,
        d_hg=d_hg, pdf_hg=pdf_hg, bs=bs, new_med=new_med)


def next_state(v: Vertex, st, beta, it: int, icfg: IntegratorConfig, u_rr,
               polarized: bool = False):
    """The state update after a vertex, shared by the primal and PRB's
    replay sweep: the spawned ray, the throughput (``beta`` already holds
    the vertex's albedo), eta and Russian roulette on ``u_rr`` (a
    detached decision) -> (o, d, beta, eta, active_next, prev_p, prev_pdf,
    prev_delta).  A ``polarized`` throughput takes the surface's
    polarization factor times the BSDF weight; medium lanes keep it (HG
    sampling has unit weight), and entry [0, 0] drives Russian
    roulette."""
    ms = v.medium_scatter
    d_srf = v.si.frame.to_world(v.bs.wo)
    new_d = torch.where(ms[:, None], v.d_hg, d_srf)
    new_o = torch.where(ms[:, None], v.p_event, v.si.spawn_ray(d_srf).o)
    w_step = torch.where(ms[:, None], 1.0, v.bs.weight)
    pdf_step = torch.where(ms, v.pdf_hg, v.bs.pdf)
    delta_step = ~ms & v.bs.delta
    eta_step = torch.where(ms, 1.0, v.bs.eta)
    active_next = v.active_next
    if polarized:
        si, bs = v.si, v.bs
        cos_i = torch.where(bs.delta, torch.abs(si.wi[:, 2]),
                            _half_vector_cos(si.wi, bs.wo))
        P = polarization_factor_soa(v.lb, -d_srf, -st.d, cos_i,
                                    transmitted=bs.wo[:, 2] * si.wi[:, 2]
                                    < 0.0)
        step = torch.where(ms[:, None], beta,
                           msoa_product(beta, P * bs.weight))
        beta = torch.where(active_next[:, None], step, beta)
        beta_max = beta[0, 0].amax(dim=-1).detach()
    else:
        beta = torch.where(active_next[:, None], beta * w_step, beta)
        beta_max = beta.amax(dim=-1).detach()
    eta = torch.where(active_next, st.eta * eta_step, st.eta)
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp_max(beta_max * eta * eta, 0.95)
    active_next = active_next & (rr_prob > 0.0)
    if it >= icfg.rr_depth:
        rr_scale = torch.where(active_next & (rr_prob > 0.0),
                               1.0 / torch.clamp_min(rr_prob, 1e-6), 1.0)
        beta = beta * rr_scale.detach()[:, None]
        active_next = active_next & (u_rr < rr_prob)
    se = v.scatter_event
    return (new_o, new_d, beta, eta, active_next,
            torch.where(se[:, None], v.p_event, st.prev_p),
            torch.where(active_next & se, pdf_step, st.prev_pdf),
            torch.where(active_next & se, delta_step, st.prev_delta))


def sample_volpath_primal(
    sd: SceneData,
    sampler: Sampler,
    ray: Ray,
    pix: torch.Tensor,
    ray_weight: torch.Tensor,
    film,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    spp: int,
    bvh_mode: str = BVH_MODE,
    enable_film: bool = True,
    polarized: bool = False,
    cam_vertical: torch.Tensor | None = None,
    spectral: bool = False,
):
    """Trace one volumetric wavefront of ``n = pix.shape[0]`` spp-major
    lanes -> (film, L (N, C), valid (N,), n_rays () int64), as
    ``path.sample_primal``.  ``enable_film=False`` skips the splats (PRB's
    primal sweep; ``film`` may then be None).  ``polarized`` carries the
    Mueller throughput from the sensor-alignment rotator about
    ``cam_vertical`` and returns L (N, 4 C), Stokes-major; ``spectral``
    draws the lanes' hero wavelengths from the sampler key and returns L
    in linear sRGB."""
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    key = sampler.key
    splat_w = ray_weight * sample_scale
    grids = has_grids(sd)
    sctx = None
    if spectral:
        sctx = SpectralCtx.make(key, n)
        C = N_WL
    if polarized:
        vert = (cam_vertical if cam_vertical is not None
                else torch.tensor([0.0, 1.0, 0.0], device=dev))
        beta0 = sensor_alignment_soa(ray.d, vert, C)
    else:
        beta0 = torch.ones((n, C), dtype=f32, device=dev)

    def to_film(v):
        return v if sctx is None else sctx.to_film_any(v, polarized)

    distance0 = (-first_surface_distance(sd, ray, bvh_mode=bvh_mode)
                 if icfg.camera_unwarp
                 else torch.zeros((n,), dtype=f32, device=dev))
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    st = VolState(
        o=ray.o, d=ray.d,
        beta=beta0,
        L=torch.zeros((n, 4 * C if polarized else C), dtype=f32, device=dev),
        eta=torch.ones((n,), dtype=f32, device=dev),
        distance=distance0, active=ones,
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
        medium=torch.full((n,), -1, dtype=torch.int32, device=dev),
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), dtype=f32, device=dev),
        prev_delta=ones, film=film,
        n_rays=torch.zeros((), dtype=torch.int64, device=dev))
    for it in range(icfg.max_depth):
        ub = draw_bounce_block(key, it, n, VOL_DIMS_PER_BOUNCE)
        v = trace_vertex(sd, key, it, ub, st, icfg, bvh_mode, sctx)
        beta = st.beta
        if not grids:
            beta = beta * survival_ratio(v.sigma_t, v.t_event,
                                         v.medium_scatter, v.in_medium,
                                         v.hit)[:, None]
        ms = v.medium_scatter[:, None]
        # Le uses the throughput before the medium's albedo, NEE after it
        Le_raw = emitter_eval_hit(sd, v.si, st.d)
        if sctx is not None:
            Le_raw = sctx.emission(Le_raw)
        if polarized:  # unpolarized emission: column 0 of beta
            Le = pack_stokes(beta[:, 0] * (v.mis[:, None] * Le_raw))
            # an HG scatter depolarizes: column 0 times the albedo
            beta = torch.where(ms, msoa_depolarize_cols(beta, v.med_albedo),
                               beta)
            P0 = polarization_factor_col0_soa(
                v.lb, -v.ds.d, -st.d, _half_vector_cos(v.si.wi, v.wo_em))
            A = torch.where(ms, beta[:, 0] * v.f_phase,
                            msoa_matvec(beta, P0 * v.f_srf))
            Lr_dir = pack_stokes(A * (v.mis_em[:, None] * v.em_weight
                                      * v.trans[:, None]))
        else:
            Le = beta * v.mis[:, None] * Le_raw
            beta = torch.where(ms, beta * v.med_albedo, beta)
            f_em = torch.where(ms, v.f_phase, v.f_srf)
            Lr_dir = (beta * v.mis_em[:, None] * f_em * v.em_weight
                      * v.trans[:, None])
        Le = torch.where(v.le_mask[:, None], Le, 0.0)
        Lr_dir = torch.where(v.active_em[:, None], Lr_dir, 0.0)
        film = st.film
        if enable_film:
            film = splat_pair_any(
                film, film_cfg, spp, v.distance, to_film(Le) * splat_w[:, None],
                v.distance + v.ds.dist * st.eta,
                to_film(Lr_dir) * splat_w[:, None],
                st.active, icfg.temporal_filter, icfg.gaussian_stddev)
        o, d, beta, eta, active, prev_p, prev_pdf, prev_delta = next_state(
            v, st, beta, it, icfg, ub[:, 7], polarized)
        st = VolState(
            o=o, d=d, beta=beta, L=st.L + Le + Lr_dir, eta=eta,
            distance=v.distance, active=active,
            depth=st.depth + v.scatter_event.to(torch.int32),
            medium=v.new_med, prev_p=prev_p, prev_pdf=prev_pdf,
            prev_delta=prev_delta, film=film,
            n_rays=st.n_rays + st.active.sum() * (1 + TRANSMITTANCE_STEPS))
    return st.film, to_film(st.L), st.depth > 0, st.n_rays
