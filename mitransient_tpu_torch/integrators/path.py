"""Transient path tracer, one wavefront a pass (counterpart of
``mitransient_tpu/integrators/path.py``, unpolarized and non-spectral).

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

The JAX loop counts rays in float32; this one counts them in int64, as the
regen loop does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bsdf import api as bsdf_api
from ..core.math import mis_weight
from ..core.records import Ray
from ..core.rng import Sampler, draw_bounce_block
from ..film.transient_film import splat_pair_any
from ..ops.bvh import BVH_MODE
from ..scene.scene import (
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
    beta: torch.Tensor  # (N, C)
    L: torch.Tensor  # (N, C)
    eta: torch.Tensor  # (N,)
    distance: torch.Tensor  # (N,) accumulated OPL
    active: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) int32 - valid-bounce count
    prev_p: torch.Tensor  # (N, 3)
    prev_pdf: torch.Tensor  # (N,)
    prev_delta: torch.Tensor  # (N,) bool
    film: tuple  # the film state (transient or phasor)
    n_rays: torch.Tensor  # () int64 - closest-hit + shadow rays traced


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
    """
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    dev = ray.o.device
    f32 = torch.float32
    key = sampler.key

    distance0 = (initial_distance if initial_distance is not None
                 else torch.zeros((n,), dtype=f32, device=dev))
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    if icfg.camera_unwarp:
        si0 = ray_intersect(sd, ray, ones, bvh_mode)
        distance0 = distance0 - torch.where(si0.valid, si0.t, 0.0)

    splat_w = ray_weight * sample_scale
    st = PathState(
        o=ray.o,
        d=ray.d,
        beta=torch.ones((n, C), dtype=f32, device=dev),
        L=torch.zeros((n, C), dtype=f32, device=dev),
        eta=torch.ones((n,), dtype=f32, device=dev),
        distance=distance0,
        active=ones,
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), dtype=f32, device=dev),
        prev_delta=ones,
        film=film,
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
    )
    for it in range(icfg.max_depth):
        st = _bounce(sd, key, it, n, st, film_cfg, icfg, spp, splat_w,
                     bvh_mode, enable_film)
    return st.film, st.L, st.depth > 0, st.n_rays


def _bounce(sd, key, it, n, st: PathState, film_cfg, icfg, spp, splat_w,
            bvh_mode, enable_film) -> PathState:
    ub = draw_bounce_block(key, it, n, DIMS_PER_BOUNCE, st.o.device)

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

    # ---- direct emission (BSDF-sampled MIS)
    pdf_em_hit = pdf_emitter_direction(sd, st.prev_p, si)
    pdf_em_hit = torch.where(st.prev_delta, 0.0, pdf_em_hit)
    mis = mis_weight(st.prev_pdf, pdf_em_hit)
    Le_raw = emitter_eval_hit(sd, si, st.d)
    le_mask = hit & (not icfg.discard_direct_light)
    Le = torch.where(le_mask[:, None], st.beta * mis[:, None] * Le_raw, 0.0)

    # ---- continuation gating and emitter sampling (NEE)
    active_next = active & si.valid
    if it + 1 >= icfg.max_depth:
        active_next = torch.zeros_like(active)
    active_em = active_next & bsdf_api.is_smooth(lb)
    ds, em_weight = sample_emitter_direction(sd, si.p, rnd2(0), True,
                                             active_em, bvh_mode)
    active_em = active_em & (ds.pdf > 0.0)
    wo_em = si.frame.to_local(ds.d)
    f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
    mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
    Lr_dir = torch.where(active_em[:, None],
                         st.beta * mis_em[:, None] * f_em * em_weight, 0.0)
    # one film update for both splat events of the bounce: the emitter hit
    # at `distance`, NEE at `distance + ds.dist * eta`
    film = st.film
    if enable_film:
        film = splat_pair_any(
            film, film_cfg, spp,
            distance, Le * splat_w[:, None],
            distance + ds.dist * st.eta, Lr_dir * splat_w[:, None],
            active, icfg.temporal_filter, icfg.gaussian_stddev)

    # ---- BSDF sampling
    bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), active_next)
    o, d_world, beta, eta, active_next, prev = next_vertex(
        si, bs, hit, active_next, st.beta, st.eta,
        (st.prev_p, st.prev_pdf, st.prev_delta), it, icfg, rnd1(5))

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
        n_rays=st.n_rays + active.sum() + active_em.sum(),
    )


def next_vertex(si, bs, hit, active_next, beta, eta, prev, it: int,
                icfg: IntegratorConfig, u_rr: torch.Tensor):
    """The state update after BSDF sampling, shared by the primal bounce
    and PRB's replay sweep (``prb.sample_adjoint``), which must take the
    same random decisions: the spawned ray, the throughput and eta, Russian
    roulette on ``u_rr``, and the vertex the next bounce's MIS looks back
    at.  Russian roulette is a detached decision (detached PRB):
    differentiating 1 / rr_prob would also give infinite derivatives on
    lanes of tiny throughput.

    prev: (prev_p, prev_pdf, prev_delta).
    -> (o, d, beta, eta, active_next, prev)."""
    d = si.frame.to_world(bs.wo)
    o = si.spawn_ray(d).o
    beta = torch.where(active_next[:, None], beta * bs.weight, beta)
    eta = torch.where(active_next, eta * bs.eta, eta)
    beta_max = beta.amax(dim=-1).detach()
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp_max(beta_max * eta * eta, 0.95)
    active_next = active_next & (rr_prob > 0.0)
    if it >= icfg.rr_depth:
        rr_scale = torch.where(rr_prob > 0.0,
                               1.0 / torch.clamp_min(rr_prob, 1e-30),
                               0.0).detach()
        beta = torch.where(active_next[:, None], beta * rr_scale[:, None],
                           beta)
        active_next = active_next & (u_rr < rr_prob)
    prev_p, prev_pdf, prev_delta = prev
    prev = (torch.where(hit[:, None], si.p, prev_p),
            torch.where(active_next, bs.pdf, prev_pdf),
            torch.where(active_next, bs.delta, prev_delta))
    return o, d, beta, eta, active_next, prev
