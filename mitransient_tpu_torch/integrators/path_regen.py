"""Transient path tracer with in-loop path regeneration.

Counterpart of ``mitransient_tpu/integrators/path_regen.py``: mono, rgb
and their polarized variants (the JAX loop has no spectral branch).  When a
lane's path terminates, the lane starts its pixel's next sample, so the
wavefront stays full until every lane has used up its share of the spp
budget.  A polarized lane restarts from the identity Mueller matrix with
the new camera ray's sensor-alignment rotator pending (the carry of
``integrators/path.py``).

Lane layout: lane l = (row r = l // HW, pixel p = l % HW); the lane owns
sample indices r, r + L, r + 2L, ... of pixel p (L = lanes per pixel), so
the pixel of a lane never changes and the film splat needs no scatter
across pixels.  Spectral state is carried as ``(N, C)`` for every C.

RNG: a stateless PCG hash of (seed, sample, dimension), bit-exact with the
JAX package.  PyTorch has no uint32 shifts on the CPU, so the 32-bit
arithmetic runs in int64 and is masked to 32 bits.

The JAX loop runs while any lane is live, which in PyTorch would be a
device-to-host sync on every bounce.  This loop runs to the same
``max_iters`` bound and asks whether a lane is still live only every
``LIVE_CHECK_EVERY`` iterations; iterations after the last lane died add
exact zeros, so the output does not depend on that period.

Scenes with an acceleration structure keep the in-bounce shadow-ray
``ray_test`` here.  The JAX loop instead resolves a bounce's NEE
visibility inside the next bounce's query (shadow-ray pipelining), which
gives the same estimator (``tests/test_accel.py:202``) but makes its loop
run one extra iteration to drain the last shadow rays
(``path_regen.py:198-202``); this loop has no such iteration, so for accel
scenes its ``iters`` can be one less than the JAX package's.
"""
from __future__ import annotations

import torch

from .. import trace
from ..bsdf import api as bsdf_api
from ..bsdf.polarized import sensor_alignment_angles
from ..core.math import divide, mis_weight, normalize
from ..core.mueller import msoa_identity
from ..core.records import Ray
from ..film.transient_film import TransientFilmState, splat_pair_any
from ..ops.bvh import BVH_MODE
from ..scene.scene import (
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig
from .path import pack_stokes, polarized_nee, polarized_update, rr_step

DIMS_PER_BOUNCE = 8  # 2 NEE + 3 BSDF + 1 RR (+2 spare); dims 0-1 = jitter
LIVE_CHECK_EVERY = 8  # iterations between host checks of any(lane_live)
_M32 = 0xFFFFFFFF


def _pcg(x):
    """32-bit PCG-ish mixer on uint32 values held in int64 (or Python int).
    ``x >> (x >> 28) + 4`` of the JAX version parses as
    ``x >> ((x >> 28) + 4)``."""
    x = (x * 747796405 + 2891336453) & _M32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (w >> 22) ^ w


def hash_uniform(seed, sample_id, dim) -> torch.Tensor:
    """Stateless uniform in [0, 1]: pure function of (seed, sample, dim).

    Like the JAX version, an h close to 2^32 rounds to exactly 1.0 in the
    float32 conversion."""
    with trace.span("mitr:rng"):
        h = _pcg((sample_id & _M32)
                 ^ _pcg((dim & _M32) ^ _pcg(seed & _M32)))
        return h.to(torch.float32) * (1.0 / 4294967296.0)


def sample_primal_regen(
    sd: SceneData,
    seed: int,
    cam,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    spp_total: int,
    lanes_per_pixel: int,
    bvh_mode: str = BVH_MODE,
    polarized: bool = False,
):
    """Render the full spp budget with path regeneration.

    Returns (film, steady (N, C), or (N, 4 C) Stokes-major when
    ``polarized``, per-lane sums of finished samples to be
    row-reduced, n_rays (int64), iters, loop_iters).  ``iters`` (a device
    int64) counts the iterations the JAX loop would run, those that began
    with a live lane; ``loop_iters`` (a Python int) counts the iterations
    this loop ran, each of which launches every per-bounce kernel once.
    The film's transient tensor is updated in place.  ``bvh_mode`` is the
    traversal mode of both ray queries in scenes with an accel.
    """
    hw = film_cfg.width * film_cfg.height
    L = lanes_per_pixel
    n = hw * L
    C = sd.bsdf.reflectance.shape[-1]
    width, height = film_cfg.width, film_cfg.height
    dev = sd.tri.v0.device
    f32 = torch.float32
    splat_scale = 1.0 / spp_total

    CS = 4 * C if polarized else C  # splat and steady channels
    cam_vert = cam.R[:, 1]  # the sensor's up axis (polarized alignment)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pix = lane % hw
    px = (pix % width).to(f32)
    py = (pix // width).to(f32)
    row = lane // hw
    origin = cam.origin.expand(n, 3)

    def gen_ray(sample_idx):
        """Camera ray for each lane's sample ``sample_idx`` (dims 0-1)."""
        sid = sample_idx * hw + pix
        u = divide(px + hash_uniform(seed, sid, 0), width)
        v = divide(py + hash_uniform(seed, sid, 1), height)
        d_cam = torch.stack(
            [(1.0 - 2.0 * u) * cam.tan_half[0],
             (1.0 - 2.0 * v) * cam.tan_half[1],
             torch.ones_like(u)], dim=-1)
        return origin, normalize(d_cam @ cam.R.T)

    o0, d0 = gen_ray(row)
    o = o0.contiguous()
    d = d0
    if polarized:
        beta0 = msoa_identity(torch.zeros((n, C), dtype=f32, device=dev))
        beta, pend = beta0, sensor_alignment_angles(d0, cam_vert)
    else:
        beta, pend = torch.ones((n, C), dtype=f32, device=dev), ()
    L_path = torch.zeros((n, CS), dtype=f32, device=dev)
    eta = torch.ones((n,), dtype=f32, device=dev)
    distance = torch.zeros((n,), dtype=f32, device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    sample_idx = row
    lane_live = row < spp_total  # lanes beyond the budget are dead
    path_active = lane_live
    prev_p = o
    prev_pdf = torch.ones((n,), dtype=f32, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    steady = torch.zeros((n, CS), dtype=f32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)

    max_iters = (((spp_total + L - 1) // L) * icfg.max_depth
                 + icfg.max_depth + 1)
    it = 0
    while it < max_iters:
        if it % LIVE_CHECK_EVERY == 0:
            with trace.span("mitr:sync"):
                live = bool(lane_live.any())
            if not live:
                break
        with trace.span("mitr:bounce"):
            iters = iters + lane_live.any()
            it += 1
            active = path_active & lane_live
            sid = sample_idx * hw + pix
            dim0 = 2 + depth * DIMS_PER_BOUNCE

            def rnd1(k):
                return hash_uniform(seed, sid, dim0 + k)

            def rnd2(k):
                return torch.stack([rnd1(k), rnd1(k + 1)], dim=-1)

            si = ray_intersect(sd, Ray.make(o, d), active, bvh_mode)
            hit = active & si.valid
            distance_hit = distance + torch.where(hit, si.t, 0.0) * eta

            lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                           sd.bsdf_kinds)
            pdf_em_hit = pdf_emitter_direction(sd, prev_p, si)
            pdf_em_hit = torch.where(prev_delta, 0.0, pdf_em_hit)
            mis = mis_weight(prev_pdf, pdf_em_hit)
            le_mask = hit & (not icfg.discard_direct_light)
            Le_raw = emitter_eval_hit(sd, si, d)
            if polarized:
                Le = pack_stokes(beta[:, 0] * (mis[:, None] * Le_raw))
            else:
                Le = beta * mis[:, None] * Le_raw
            Le = torch.where(le_mask[:, None], Le, 0.0)

            cont = active & (depth + 1 < icfg.max_depth) & si.valid
            active_em = cont & bsdf_api.is_smooth(lb)
            ds, em_weight = sample_emitter_direction(sd, si.p, rnd2(0), True,
                                                     active_em, bvh_mode)
            active_em = active_em & (ds.pdf > 0.0)
            wo_em = si.frame.to_local(ds.d)
            f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em,
                                                  active_em)
            mis_em = torch.where(ds.delta, 1.0,
                                 mis_weight(ds.pdf, pdf_bsdf_em))
            if polarized:
                col = polarized_nee(lb, si, wo_em, ds.d, d, pend, beta, f_em)
                Lr_dir = pack_stokes(col * (mis_em[:, None] * em_weight))
            else:
                Lr_dir = beta * mis_em[:, None] * f_em * em_weight
            Lr_dir = torch.where(active_em[:, None], Lr_dir, 0.0)

            film = splat_pair_any(
                film, film_cfg, L,
                distance_hit, Le * splat_scale,
                distance_hit + ds.dist * eta, Lr_dir * splat_scale,
                active, icfg.temporal_filter, icfg.gaussian_stddev,
            )

            bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), cont)
            d_world = si.frame.to_world(bs.wo)
            new_ray = si.spawn_ray(d_world)

            L_acc = L_path + Le + Lr_dir
            if polarized:
                beta, pend = polarized_update(si, bs, lb, d, d_world, beta,
                                              pend, cont)
            else:
                beta = torch.where(cont[:, None], beta * bs.weight, beta)
            eta = torch.where(cont, eta * bs.eta, eta)
            beta, cont = rr_step(beta, eta, cont, depth >= icfg.rr_depth,
                                 rnd1(5), polarized)

            # ---- regeneration: finished paths bank their L and start the
            # lane's next sample
            finished = active & ~cont
            steady = steady + torch.where(finished[:, None], L_acc, 0.0)
            next_sample = sample_idx + L
            has_more = next_sample < spp_total
            regen = finished & has_more
            lane_live = lane_live & ~(finished & ~has_more)
            sample_idx = torch.where(regen, next_sample, sample_idx)
            o_new, d_new = gen_ray(sample_idx)

            if polarized:
                # a fresh sample: the identity, with the new ray's alignment
                # rotator pending
                beta = torch.where(regen[:, None], beta0, beta)
                npc2, nps2 = sensor_alignment_angles(d_new, cam_vert)
                pend = (torch.where(regen, npc2, pend[0]),
                        torch.where(regen, nps2, pend[1]))
            else:
                beta = torch.where(regen[:, None], 1.0, beta)
            o = torch.where(regen[:, None], o_new, new_ray.o)
            d = torch.where(regen[:, None], d_new, d_world)
            L_path = torch.where((finished | regen)[:, None], 0.0, L_acc)
            eta = torch.where(regen, 1.0, eta)
            distance = torch.where(regen, 0.0, distance_hit)
            depth = torch.where(regen, 0, depth + 1)
            path_active = torch.where(regen, True, cont) & lane_live
            prev_p = torch.where(regen[:, None], o_new,
                                 torch.where(hit[:, None], si.p, prev_p))
            prev_pdf = torch.where(regen, 1.0,
                                   torch.where(cont, bs.pdf, prev_pdf))
            prev_delta = torch.where(regen, True,
                                     torch.where(cont, bs.delta, prev_delta))
            n_active = active.sum()
            n_rays = n_rays + n_active + active_em.sum()
            trace.count("lanes.launched", n)
            trace.count("lanes.active", n_active)

    return film, steady, n_rays, iters, it
