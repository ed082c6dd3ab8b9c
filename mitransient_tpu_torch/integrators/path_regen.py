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
arithmetic runs in int64 and is masked to 32 bits.  The loop takes its
seed on the lanes' device (:func:`stream_keys`: the seed as a 0-dim int64
tensor, hashed there once a render with the keys of the camera jitter's
two dimensions), so that nothing of a render's seed is a Python number
inside an iteration.

The JAX loop runs while any lane is live, which in PyTorch would be a
device-to-host sync on every bounce.  This loop runs to the same
``max_iters`` bound and asks whether a lane is still live only every
``LIVE_CHECK_EVERY`` iterations; iterations after the last lane died add
exact zeros, so the output does not depend on that period.  The
iterations between two checks are a block (:func:`regen_block`): what one
iteration reads and rebinds is a :class:`Carry`, the rest a
:class:`RegenLoop` of the render's inputs and per-lane constants, so that
``regengraph.py`` can run a block on buffers it owns and replay it as one
CUDA graph.

Scenes with an acceleration structure keep the in-bounce shadow-ray
``ray_test`` here.  The JAX loop instead resolves a bounce's NEE
visibility inside the next bounce's query (shadow-ray pipelining), which
gives the same estimator (``tests/test_accel.py:202``) but makes its loop
run one extra iteration to drain the last shadow rays
(``path_regen.py:198-202``); this loop has no such iteration, so for accel
scenes its ``iters`` can be one less than the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import passgraph, trace
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


def _hash_draw(key, sample_id) -> torch.Tensor:
    """The uniform of sample ``sample_id`` under ``key``, the hash of one
    (seed, dimension) pair.  An h close to 2^32 rounds to exactly 1.0 in
    the float32 conversion, as in the JAX version."""
    h = _pcg((sample_id & _M32) ^ key)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def hash_uniform(seed, sample_id, dim) -> torch.Tensor:
    """Stateless uniform in [0, 1]: pure function of (seed, sample, dim).
    ``seed`` is a Python int or a 0-dim int64 tensor on the lanes' device,
    with the same bits: both are masked to 32 bits first."""
    with trace.span("mitr:rng"):
        return _hash_draw(_pcg((dim & _M32) ^ _pcg(seed & _M32)), sample_id)


def stream_keys(seed: int, device) -> torch.Tensor:
    """A render's stream on ``device``: (3,) int64, the hash of the seed
    (taken as a 0-dim int64 tensor there) and the keys of dimensions 0 and
    1, the camera jitter that every iteration draws.  A fill and device
    arithmetic, no upload.  The loop's draws are :func:`hash_uniform`'s
    bits with these folded in once a render, not once a draw."""
    key = _pcg(torch.full((), seed & _M32, dtype=torch.int64, device=device))
    return torch.stack([key, _pcg(key), _pcg(key ^ 1)])


class RegenLoop(NamedTuple):
    """What every iteration of a render reads besides its :class:`Carry`
    and the film: the render's inputs and the per-lane constants."""
    sd: SceneData
    cam: object  # sensors/perspective.py:CameraArrays
    keys: torch.Tensor  # (3,) int64: stream_keys
    film_cfg: FilmConfig
    icfg: IntegratorConfig
    spp_total: int
    lanes_per_pixel: int
    bvh_mode: str
    polarized: bool
    pix: torch.Tensor  # (N,) int64: the lane's pixel
    px: torch.Tensor  # (N,) float32: its column
    py: torch.Tensor  # (N,) float32: its row of the film
    row: torch.Tensor  # (N,) int64: the lane's row, its first sample
    beta0: torch.Tensor | None  # polarized: the identity Mueller carry


class Carry(NamedTuple):
    """What one iteration reads and rebinds: per lane, and the render's
    ray count and JAX-loop iteration count."""
    o: torch.Tensor
    d: torch.Tensor
    beta: torch.Tensor  # (N, C), or (4, 4, N, C) polarized
    pend: tuple  # polarized: the pending rotator's (cos 2a, sin 2a)
    L_path: torch.Tensor
    eta: torch.Tensor
    distance: torch.Tensor
    depth: torch.Tensor
    sample_idx: torch.Tensor
    lane_live: torch.Tensor
    path_active: torch.Tensor
    prev_p: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    steady: torch.Tensor  # per-lane sums of finished samples
    n_rays: torch.Tensor  # () int64
    iters: torch.Tensor  # () int64


def regen_loop(sd: SceneData, cam, keys: torch.Tensor, film_cfg: FilmConfig,
               icfg: IntegratorConfig, spp_total: int, lanes_per_pixel: int,
               bvh_mode: str = BVH_MODE,
               polarized: bool = False) -> RegenLoop:
    """A render's :class:`RegenLoop` on ``sd``'s device: its inputs and
    the lanes' constants for ``lanes_per_pixel`` lanes a pixel."""
    hw = film_cfg.width * film_cfg.height
    n = hw * lanes_per_pixel
    dev = sd.tri.v0.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pix = lane % hw
    beta0 = None
    if polarized:
        C = sd.bsdf.reflectance.shape[-1]
        beta0 = msoa_identity(torch.zeros((n, C), dtype=torch.float32,
                                          device=dev))
    return RegenLoop(sd, cam, keys, film_cfg, icfg, spp_total,
                     lanes_per_pixel, bvh_mode, polarized, pix,
                     (pix % film_cfg.width).to(torch.float32),
                     (pix // film_cfg.width).to(torch.float32),
                     lane // hw, beta0)


def _camera_ray(lp: RegenLoop, sample_idx):
    """Camera ray for each lane's sample ``sample_idx`` (dims 0-1)."""
    width, height = lp.film_cfg.width, lp.film_cfg.height
    sid = sample_idx * (width * height) + lp.pix
    with trace.span("mitr:rng"):
        ju = _hash_draw(lp.keys[1], sid)
    with trace.span("mitr:rng"):
        jv = _hash_draw(lp.keys[2], sid)
    u = divide(lp.px + ju, width)
    v = divide(lp.py + jv, height)
    cam = lp.cam
    d_cam = torch.stack(
        [(1.0 - 2.0 * u) * cam.tan_half[0],
         (1.0 - 2.0 * v) * cam.tan_half[1],
         torch.ones_like(u)], dim=-1)
    return cam.origin.expand(lp.pix.shape[0], 3), normalize(d_cam @ cam.R.T)


def initial_carry(lp: RegenLoop) -> Carry:
    """Every lane at its first sample (lanes beyond the budget dead)."""
    n = lp.pix.shape[0]
    C = lp.sd.bsdf.reflectance.shape[-1]
    CS = 4 * C if lp.polarized else C  # splat and steady channels
    dev, f32 = lp.pix.device, torch.float32
    o0, d0 = _camera_ray(lp, lp.row)
    o = o0.contiguous()
    if lp.polarized:
        beta, pend = lp.beta0, sensor_alignment_angles(d0, lp.cam.R[:, 1])
    else:
        beta, pend = torch.ones((n, C), dtype=f32, device=dev), ()
    lane_live = lp.row < lp.spp_total
    return Carry(
        o=o, d=d0, beta=beta, pend=pend,
        L_path=torch.zeros((n, CS), dtype=f32, device=dev),
        eta=torch.ones((n,), dtype=f32, device=dev),
        distance=torch.zeros((n,), dtype=f32, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        sample_idx=lp.row, lane_live=lane_live, path_active=lane_live,
        prev_p=o, prev_pdf=torch.ones((n,), dtype=f32, device=dev),
        prev_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        steady=torch.zeros((n, CS), dtype=f32, device=dev),
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
        iters=torch.zeros((), dtype=torch.int64, device=dev))


def _iteration(lp: RegenLoop, c: Carry, film):
    """One bounce of every lane, then the regeneration -> (carry, film)."""
    sd, icfg, polarized = lp.sd, lp.icfg, lp.polarized
    hw = lp.film_cfg.width * lp.film_cfg.height
    L = lp.lanes_per_pixel
    n = lp.pix.shape[0]
    splat_scale = 1.0 / lp.spp_total
    beta, pend, eta = c.beta, c.pend, c.eta
    d = c.d
    with trace.span("mitr:bounce"):
        iters = c.iters + c.lane_live.any()
        active = c.path_active & c.lane_live
        sid = c.sample_idx * hw + lp.pix
        dim0 = 2 + c.depth * DIMS_PER_BOUNCE

        def rnd1(k):
            with trace.span("mitr:rng"):
                return _hash_draw(_pcg(((dim0 + k) & _M32) ^ lp.keys[0]),
                                  sid)

        def rnd2(k):
            return torch.stack([rnd1(k), rnd1(k + 1)], dim=-1)

        si = ray_intersect(sd, Ray.make(c.o, d), active, lp.bvh_mode)
        hit = active & si.valid
        distance_hit = c.distance + torch.where(hit, si.t, 0.0) * eta

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                       sd.bsdf_kinds)
        pdf_em_hit = pdf_emitter_direction(sd, c.prev_p, si)
        pdf_em_hit = torch.where(c.prev_delta, 0.0, pdf_em_hit)
        mis = mis_weight(c.prev_pdf, pdf_em_hit)
        le_mask = hit & (not icfg.discard_direct_light)
        Le_raw = emitter_eval_hit(sd, si, d)
        if polarized:
            Le = pack_stokes(beta[:, 0] * (mis[:, None] * Le_raw))
        else:
            Le = beta * mis[:, None] * Le_raw
        Le = torch.where(le_mask[:, None], Le, 0.0)

        cont = active & (c.depth + 1 < icfg.max_depth) & si.valid
        active_em = cont & bsdf_api.is_smooth(lb)
        ds, em_weight = sample_emitter_direction(sd, si.p, rnd2(0), True,
                                                 active_em, lp.bvh_mode)
        active_em = active_em & (ds.pdf > 0.0)
        wo_em = si.frame.to_local(ds.d)
        f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
        if polarized:
            col = polarized_nee(lb, si, wo_em, ds.d, d, pend, beta, f_em)
            Lr_dir = pack_stokes(col * (mis_em[:, None] * em_weight))
        else:
            Lr_dir = beta * mis_em[:, None] * f_em * em_weight
        Lr_dir = torch.where(active_em[:, None], Lr_dir, 0.0)

        film = splat_pair_any(
            film, lp.film_cfg, L,
            distance_hit, Le * splat_scale,
            distance_hit + ds.dist * eta, Lr_dir * splat_scale,
            active, icfg.temporal_filter, icfg.gaussian_stddev,
        )

        bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), cont)
        d_world = si.frame.to_world(bs.wo)
        new_ray = si.spawn_ray(d_world)

        L_acc = c.L_path + Le + Lr_dir
        if polarized:
            beta, pend = polarized_update(si, bs, lb, d, d_world, beta, pend,
                                          cont)
        else:
            beta = torch.where(cont[:, None], beta * bs.weight, beta)
        eta = torch.where(cont, eta * bs.eta, eta)
        beta, cont = rr_step(beta, eta, cont, c.depth >= icfg.rr_depth,
                             rnd1(5), polarized)

        # ---- regeneration: finished paths bank their L and start the
        # lane's next sample
        finished = active & ~cont
        steady = c.steady + torch.where(finished[:, None], L_acc, 0.0)
        next_sample = c.sample_idx + L
        has_more = next_sample < lp.spp_total
        regen = finished & has_more
        lane_live = c.lane_live & ~(finished & ~has_more)
        sample_idx = torch.where(regen, next_sample, c.sample_idx)
        o_new, d_new = _camera_ray(lp, sample_idx)

        if polarized:
            # a fresh sample: the identity, with the new ray's alignment
            # rotator pending
            beta = torch.where(regen[:, None], lp.beta0, beta)
            npc2, nps2 = sensor_alignment_angles(d_new, lp.cam.R[:, 1])
            pend = (torch.where(regen, npc2, pend[0]),
                    torch.where(regen, nps2, pend[1]))
        else:
            beta = torch.where(regen[:, None], 1.0, beta)
        n_active = active.sum()
        trace.count("lanes.launched", n)
        trace.count("lanes.active", n_active)
        return Carry(
            o=torch.where(regen[:, None], o_new, new_ray.o),
            d=torch.where(regen[:, None], d_new, d_world),
            beta=beta, pend=pend,
            L_path=torch.where((finished | regen)[:, None], 0.0, L_acc),
            eta=torch.where(regen, 1.0, eta),
            distance=torch.where(regen, 0.0, distance_hit),
            depth=torch.where(regen, 0, c.depth + 1),
            sample_idx=sample_idx, lane_live=lane_live,
            path_active=torch.where(regen, True, cont) & lane_live,
            prev_p=torch.where(regen[:, None], o_new,
                               torch.where(hit[:, None], si.p, c.prev_p)),
            prev_pdf=torch.where(regen, 1.0,
                                 torch.where(cont, bs.pdf, c.prev_pdf)),
            prev_delta=torch.where(regen, True,
                                   torch.where(cont, bs.delta,
                                               c.prev_delta)),
            steady=steady,
            n_rays=c.n_rays + n_active + active_em.sum(),
            iters=iters), film


def regen_block(lp: RegenLoop, carry: Carry, film, k: int):
    """``k`` iterations -> (carry, film); the film's transient is updated
    in place."""
    for _ in range(k):
        carry, film = _iteration(lp, carry, film)
    return carry, film


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
    graph=None,
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

    With ``graph`` (``regengraph.route``) the blocks run on the graph's
    own buffers, eagerly or as replays of its CUDA graph; without, on the
    render's own tensors.  The two give the same bits.
    """
    if graph is None:
        keys = stream_keys(seed, sd.tri.v0.device)
        lp = regen_loop(sd, cam, keys, film_cfg, icfg, spp_total,
                        lanes_per_pixel, bvh_mode, polarized)
        carry = initial_carry(lp)
    else:
        carry, film = graph.begin(sd, cam, film, seed)
    block = LIVE_CHECK_EVERY
    max_iters = (((spp_total + lanes_per_pixel - 1) // lanes_per_pixel)
                 * icfg.max_depth + icfg.max_depth + 1)
    it = 0
    while it < max_iters:
        with trace.span("mitr:sync"):
            live = bool(carry.lane_live.any())
        if not live:
            break
        k = min(block, max_iters - it)
        if graph is None:
            carry, film = regen_block(lp, carry, film, k)
            passgraph.count("eager_blocks")
        else:
            carry, film = graph.run(k, more=it + k + block <= max_iters)
        it += k
    if graph is not None:
        carry, film = graph.end()
    return film, carry.steady, carry.n_rays, carry.iters, it
