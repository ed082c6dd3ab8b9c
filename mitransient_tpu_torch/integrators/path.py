"""Transient path tracer, one wavefront a pass (counterpart of
``mitransient_tpu/integrators/path.py``).

Path tracing with next-event estimation, power-heuristic MIS, optical path
length tracking and a transient splat per bounce, over a dense masked
wavefront of ``max_depth`` bounces; the multi-pass render (``render.py``)
runs it once a pass.  Each bounce launches one closest-hit query (K1, or
the BVH kernel in scenes with an accel), one NEE shadow-ray query (K2, or
the BVH kernel) and one two-event film splat (K3); ``camera_unwarp`` adds
one closest-hit query a pass.

RNG: each bounce draws its 6 sampler dimensions as one threefry block
(``draw_bounce_block(key, it, n, 6)``), in the JAX column order: NEE 0-1,
BSDF lobe 2 and direction 3-4, Russian roulette 5.

Variants: under a polarized variant the throughput is a Mueller matrix
carried in the structured layout of ``core/mueller.py`` with a pending
rotator (:func:`polarized_update`), contributions are Stokes vectors and
the film has 4 C channels, Stokes-major; under a spectral variant every
lane carries ``N_WL`` hero wavelengths (``core/spectra.py``), the BSDF
table and the emission are uplifted to them each bounce, and the splats
convert to sRGB.

The JAX loop counts rays in float32; this one counts them in int64, as the
regen loop does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..bsdf import api as bsdf_api
from ..bsdf.polarized import (
    polarization_factor_col0_soa,
    sensor_alignment_angles,
    specular_params_soa,
)
from ..core.math import dot, mis_weight, norm
from ..core.mueller import (
    msoa_apply_fresnel_cols,
    msoa_apply_rotator_cols,
    msoa_identity,
    msoa_matvec,
    rot2_compose,
    stokes_rotate,
)
from ..core.spectra import N_WL, SpectralCtx
from ..core.records import Ray
from ..core.rng import Sampler, draw_bounce_block
from ..film.transient_film import splat_pair_any
from ..ops.bvh import BVH_MODE
from ..scene.scene import (
    BSDF_NULL,
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig

DIMS_PER_BOUNCE = 6


class PathState(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    beta: torch.Tensor  # (N, C); polarized: the stored (4, 4, N, C)
    L: torch.Tensor  # (N, C); polarized: (N, 4 C), Stokes-major
    eta: torch.Tensor  # (N,)
    distance: torch.Tensor  # (N,) accumulated OPL
    active: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) int32 - valid-bounce count
    prev_p: torch.Tensor  # (N, 3)
    prev_pdf: torch.Tensor  # (N,)
    prev_delta: torch.Tensor  # (N,) bool
    film: tuple  # the film state (transient or phasor)
    n_rays: torch.Tensor  # () int64 - closest-hit + shadow rays traced
    # polarized: the pending rotator (cos 2a, sin 2a), each (N,), with the
    # true Mueller throughput = beta @ R(pend); () unpolarized
    pend: tuple = ()


def sample_primal(
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
    initial_distance: torch.Tensor | None = None,
    enable_film: bool = True,
    polarized: bool = False,
    cam_vertical: torch.Tensor | None = None,
    spectral: bool = False,
):
    """Trace one wavefront of ``n = pix.shape[0]`` spp-major lanes.

    Returns (film, L (N, C), valid (N,), n_rays () int64).
    ``sample_scale`` is the 1/total_spp factor of every transient splat;
    the steady image gets the raw per-lane L from the caller.  The
    transient film is updated in place (through K3's autograd Function,
    so that a differentiated render reaches the film).  ``bvh_mode`` is
    the traversal mode of every ray query in scenes with an accel.
    ``initial_distance`` (N,) seeds each lane's optical path length;
    ``enable_film=False`` skips the splats (the PRB renders' primal sweep,
    which needs only L; ``film`` may then be None).  Russian roulette is a
    detached decision: its probability and scale carry no derivative.
    (The JAX function's ``base_dim`` is unused there too.)

    ``polarized`` carries the Mueller throughput, which starts as the
    identity with the sensor-alignment rotator about ``cam_vertical`` (the
    camera's up axis, ``cam.R[:, 1]``) pending, and returns L (N, 4 C)
    Stokes-major.  ``spectral`` draws the lanes' hero wavelengths from the
    sampler key and returns L in linear sRGB (12 channels with
    ``polarized``).
    """
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    key = sampler.key
    sctx = None
    if spectral:
        sctx = SpectralCtx.make(key, n)
        C = N_WL

    distance0 = (initial_distance if initial_distance is not None
                 else torch.zeros((n,), dtype=f32, device=dev))
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    if icfg.camera_unwarp:
        si0 = ray_intersect(sd, ray, ones, bvh_mode)
        distance0 = distance0 - torch.where(si0.valid, si0.t, 0.0)

    splat_w = ray_weight * sample_scale
    if polarized:
        vert = (cam_vertical if cam_vertical is not None
                else torch.tensor([0.0, 1.0, 0.0], device=dev))
        beta0 = msoa_identity(torch.zeros((n, C), dtype=f32, device=dev))
        pend0 = sensor_alignment_angles(ray.d, vert)
    else:
        beta0 = torch.ones((n, C), dtype=f32, device=dev)
        pend0 = ()
    st = PathState(
        o=ray.o,
        d=ray.d,
        beta=beta0,
        L=torch.zeros((n, 4 * C if polarized else C), dtype=f32,
                      device=dev),
        eta=torch.ones((n,), dtype=f32, device=dev),
        distance=distance0,
        active=ones,
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), dtype=f32, device=dev),
        prev_delta=ones,
        film=film,
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
        pend=pend0,
    )
    for it in range(icfg.max_depth):
        with trace.span("mitr:bounce"):
            st = _bounce(sd, key, it, n, st, film_cfg, icfg, spp, splat_w,
                         bvh_mode, enable_film, polarized, sctx)
    L = sctx.to_film_any(st.L, polarized) if spectral else st.L
    return st.film, L, st.depth > 0, st.n_rays


def pack_stokes(x: torch.Tensor) -> torch.Tensor:
    """A Stokes vector of spectra (4, N, C) -> the film's (N, 4 C) channel
    layout, Stokes-major ([I, Q, U, V] of each channel block)."""
    return x.permute(1, 0, 2).contiguous().view(x.shape[1], -1)


def _half_vector_cos(wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """|wi . m| for the normalized half vector m of wi and wo: the Fresnel
    term's incidence cosine."""
    m = wi + wo
    m = m / torch.clamp_min(norm(m), 1e-12)[:, None]
    return torch.abs(dot(wi, m))


def polarized_nee(lb, si, wo_em, ds_d, d_in, pend, beta, f_em):
    """The Stokes vector (4, N, C) of an unpolarized source's light through
    the NEE vertex and the true throughput beta @ R(pend): column 0 of the
    vertex's polarization factor, the pending rotator applied to it, then
    one matrix-vector product with the stored beta."""
    P0 = polarization_factor_col0_soa(lb, -ds_d, -d_in,
                                      _half_vector_cos(si.wi, wo_em))
    P0 = stokes_rotate(P0, pend[0][:, None], pend[1][:, None])
    return msoa_matvec(beta, P0 * f_em)


def polarized_update(si, bs, lb, d_in, d_world, beta, pend, cont):
    """The pending-rotator bounce update (the JAX package's structured
    update): beta' @ R(pend') = beta @ R(pend) @ R_out @ F @ R_in.

    Specular lanes compose R(pend) with R_out by angle addition, apply the
    Fresnel column mix and defer R_in into the new pending slot;
    depolarizing lanes keep column 0 (times the BSDF weight) and reset the
    pending rotator; null lanes keep every column and the pending rotator.
    Lanes outside ``cont`` keep their carry.  -> (beta, pend)."""
    cos_i = torch.where(bs.delta, torch.abs(si.wi[:, 2]),
                        _half_vector_cos(si.wi, bs.wo))
    transmitted = bs.wo[:, 2] * si.wi[:, 2] < 0.0
    is_spec, A, B, Cc, S, ci2, si2, co2, so2 = specular_params_soa(
        lb, -d_world, -d_in, cos_i, transmitted=transmitted)
    pc2, ps2 = pend
    cc, cs = rot2_compose(pc2, ps2, co2, so2)
    f = bs.weight
    spec_beta = msoa_apply_fresnel_cols(
        msoa_apply_rotator_cols(beta, cc[:, None], cs[:, None]),
        A * f, B * f, Cc * f, S * f)
    is_null = lb.kind == BSDF_NULL
    other = beta * f
    other = torch.cat([other[:, :1], other[:, 1:]
                       * is_null[:, None].to(f.dtype)], dim=1)
    new = torch.where(is_spec[:, None], spec_beta, other)
    beta = torch.where(cont[:, None], new, beta)
    keep = is_null & cont
    specp = is_spec & cont
    pend = (torch.where(specp, ci2, torch.where(
                keep, pc2, torch.where(cont, 1.0, pc2))),
            torch.where(specp, si2, torch.where(
                keep, ps2, torch.where(cont, 0.0, ps2))))
    return beta, pend


def rr_step(beta, eta, cont, rr_active, u_rr, polarized: bool):
    """Russian roulette after the throughput update: the throughput's
    largest channel (of Mueller entry [0, 0] when polarized) drives the
    probability; surviving lanes past ``rr_active`` are rescaled by 1 /
    probability.  ``rr_active`` is a bool or an (N,) mask.  The decision
    is detached (detached PRB): differentiating 1 / rr_prob would also
    give infinite derivatives on lanes of tiny throughput.
    -> (beta, cont)."""
    beta_max = (beta[0, 0] if polarized else beta).amax(dim=-1).detach()
    cont = cont & (beta_max != 0.0)
    rr_prob = torch.clamp_max(beta_max * eta * eta, 0.95)
    cont = cont & (rr_prob > 0.0)
    if rr_active is False:
        return beta, cont
    rr_scale = torch.where(rr_prob > 0.0,
                           1.0 / torch.clamp_min(rr_prob, 1e-30),
                           0.0).detach()
    everywhere = rr_active is True
    scaled = cont if everywhere else rr_active & cont
    beta = torch.where(scaled[:, None], beta * rr_scale[:, None], beta)
    survive = u_rr < rr_prob
    return beta, cont & (survive if everywhere else ~rr_active | survive)


def _bounce(sd, key, it, n, st: PathState, film_cfg, icfg, spp, splat_w,
            bvh_mode, enable_film, polarized: bool,
            sctx: SpectralCtx | None) -> PathState:
    ub = draw_bounce_block(key, it, n, DIMS_PER_BOUNCE)

    def rnd1(k):
        return ub[:, k]

    def rnd2(k):
        return ub[:, k:k + 2]

    active = st.active
    si = ray_intersect(sd, Ray.make(st.o, st.d), active, bvh_mode)
    hit = active & si.valid
    distance = st.distance + torch.where(hit, si.t, 0.0) * st.eta
    lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                   sd.bsdf_kinds)
    if sctx is not None:
        lb = sctx.uplift_lb(lb)

    # ---- direct emission (BSDF-sampled MIS)
    pdf_em_hit = pdf_emitter_direction(sd, st.prev_p, si)
    pdf_em_hit = torch.where(st.prev_delta, 0.0, pdf_em_hit)
    mis = mis_weight(st.prev_pdf, pdf_em_hit)
    Le_raw = emitter_eval_hit(sd, si, st.d)
    if sctx is not None:
        Le_raw = sctx.emission(Le_raw)
    le_mask = hit & (not icfg.discard_direct_light)
    if polarized:
        # unpolarized emission: Stokes = E * mis * column 0 of the true
        # throughput, which is the stored beta's (rotators fix e0)
        Le = pack_stokes(st.beta[:, 0] * (mis[:, None] * Le_raw))
    else:
        Le = st.beta * mis[:, None] * Le_raw
    Le = torch.where(le_mask[:, None], Le, 0.0)

    # ---- continuation gating and emitter sampling (NEE)
    active_next = active & si.valid
    if it + 1 >= icfg.max_depth:
        active_next = torch.zeros_like(active)
    active_em = active_next & bsdf_api.is_smooth(lb)
    ds, em_weight = sample_emitter_direction(sd, si.p, rnd2(0), True,
                                             active_em, bvh_mode)
    if sctx is not None:  # the uplift is positively homogeneous
        em_weight = sctx.emission(em_weight)
    active_em = active_em & (ds.pdf > 0.0)
    wo_em = si.frame.to_local(ds.d)
    f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
    mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
    if polarized:
        col = polarized_nee(lb, si, wo_em, ds.d, st.d, st.pend, st.beta,
                            f_em)
        Lr_dir = pack_stokes(col * (mis_em[:, None] * em_weight))
    else:
        Lr_dir = st.beta * mis_em[:, None] * f_em * em_weight
    Lr_dir = torch.where(active_em[:, None], Lr_dir, 0.0)
    # one film update for both splat events of the bounce: the emitter hit
    # at `distance`, NEE at `distance + ds.dist * eta`
    film = st.film
    if enable_film:
        Le_f, Lr_f = Le, Lr_dir
        if sctx is not None:
            Le_f = sctx.to_film_any(Le, polarized)
            Lr_f = sctx.to_film_any(Lr_dir, polarized)
        film = splat_pair_any(
            film, film_cfg, spp,
            distance, Le_f * splat_w[:, None],
            distance + ds.dist * st.eta, Lr_f * splat_w[:, None],
            active, icfg.temporal_filter, icfg.gaussian_stddev)

    # ---- BSDF sampling
    bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), active_next)
    o, d_world, beta, eta, active_next, prev, pend = next_vertex(
        si, bs, hit, active_next, st.beta, st.eta,
        (st.prev_p, st.prev_pdf, st.prev_delta), it, icfg, rnd1(5),
        mueller=(lb, st.d, st.pend) if polarized else None)

    n_active = active.sum()
    trace.count("lanes.launched", n)
    trace.count("lanes.active", n_active)
    return PathState(
        o=o,
        d=d_world,
        beta=beta,
        L=st.L + Le + Lr_dir,
        eta=eta,
        distance=distance,
        active=active_next,
        depth=st.depth + hit.to(torch.int32),
        prev_p=prev[0],
        prev_pdf=prev[1],
        prev_delta=prev[2],
        film=film,
        n_rays=st.n_rays + n_active + active_em.sum(),
        pend=pend,
    )


def next_vertex(si, bs, hit, active_next, beta, eta, prev, it: int,
                icfg: IntegratorConfig, u_rr: torch.Tensor, mueller=None):
    """The state update after BSDF sampling, shared by the primal bounce
    and PRB's replay sweep (``prb.sample_adjoint``), which must take the
    same random decisions: the spawned ray, the throughput and eta, Russian
    roulette on ``u_rr`` (:func:`rr_step`), and the vertex the next
    bounce's MIS looks back at.

    prev: (prev_p, prev_pdf, prev_delta).  ``mueller`` = (lane BSDF, the
    incoming ray direction, pending rotator) takes a polarized ``beta``
    through :func:`polarized_update`.
    -> (o, d, beta, eta, active_next, prev, pending rotator or ())."""
    d = si.frame.to_world(bs.wo)
    o = si.spawn_ray(d).o
    pend = ()
    if mueller is None:
        beta = torch.where(active_next[:, None], beta * bs.weight, beta)
    else:
        lb, d_in, pend = mueller
        beta, pend = polarized_update(si, bs, lb, d_in, d, beta, pend,
                                      active_next)
    eta = torch.where(active_next, eta * bs.eta, eta)
    beta, active_next = rr_step(beta, eta, active_next,
                                it >= icfg.rr_depth, u_rr,
                                mueller is not None)
    prev_p, prev_pdf, prev_delta = prev
    prev = (torch.where(hit[:, None], si.p, prev_p),
            torch.where(active_next, bs.pdf, prev_pdf),
            torch.where(active_next, bs.delta, prev_delta))
    return o, d, beta, eta, active_next, prev, pend
