"""Top-level render orchestration (counterpart of
``mitransient_tpu/render.py``, its regen and multi-pass branches).

A render takes one of two branches, chosen as the JAX package chooses:

* the path-regeneration loop (``integrators/path_regen.py``), one pass
  over the whole spp budget, for plain ``transient_path`` renders of at
  least 8 spp with a box filter, no crop and no ``camera_unwarp``;
* the multi-pass accumulator otherwise: the spp budget is split into
  passes of at most ``max_lanes`` lanes, each an independently seeded
  threefry stream (``Sampler(seed, n, stream=pass)``) traced by
  ``integrators/path.py``, accumulated into one film.

A scene with an ``nlos_capture_meter`` or the ``transient_nlos_path``
integrator goes to the NLOS renderer (``integrators/nlos_path.py``), as in
the JAX package.  :func:`render_aovs` gives first-hit AOVs of a perspective
sensor.  The render runs on the device of ``scene.data``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.rng import Sampler
from .film.transient_film import (
    TransientFilmState,
    develop_any,
    film_init_any,
    splat_steady,
    splat_steady_gaussian,
    surface_sample_validation,
)
from .film.phasor_film import PhasorFilmState
from .integrators import DEFAULT_MAX_LANES
from .integrators.path import sample_primal
from .integrators.path_regen import sample_primal_regen
from .ops.bvh import BVH_MODE, MODES
from .scene.scene import primal_sd
from .scene.schema import Scene
from .sensors.perspective import build_camera, sample_rays

_FILM_STATES = {cls.__name__: cls for cls in (TransientFilmState,
                                               PhasorFilmState)}


def _regen_render(sd, cam, film, seed, *, film_cfg, icfg, spp_total,
                  lanes_per_pixel, bvh_mode):
    film, steady_lanes, n_rays, iters, loop_iters = sample_primal_regen(
        sd, seed, cam, film, film_cfg, icfg, spp_total, lanes_per_pixel,
        bvh_mode)
    # steady_lanes holds per-lane SUMS of finished-sample radiances; every
    # pixel finishes exactly spp_total samples, so add up the lane rows (in
    # row order) and count spp_total unit sample weights per pixel
    hw = film.steady.shape[0]
    rows = steady_lanes.view(lanes_per_pixel, hw, -1)
    s = rows[0]
    for r in range(1, lanes_per_pixel):
        s = s + rows[r]
    film = film._replace(steady=film.steady + s,
                         steady_weight=film.steady_weight + float(spp_total))
    return film, n_rays, iters, loop_iters


def _perspective_pass(sd, cam, film, seed, pass_idx, inv_total_spp, *,
                      film_cfg, icfg, width, height, spp_chunk, bvh_mode):
    """One pass of ``spp_chunk`` samples a pixel over the data window
    (``width`` x ``height``); returns (film, n_rays)."""
    n = width * height * spp_chunk
    dev = cam.origin.device
    sampler = Sampler(seed, n, stream=pass_idx, device=dev)
    # width/height are the data (crop) dims; the uv mapping uses the full
    # sensor
    ray, pix, ray_weight = sample_rays(
        cam, sampler, width, height, spp_chunk,
        crop_offset=(film_cfg.crop_offset_x, film_cfg.crop_offset_y),
        full_size=(film_cfg.width, film_cfg.height))
    film, L, _valid, n_rays = sample_primal(
        sd, sampler, ray, pix, ray_weight, film, film_cfg, icfg,
        sample_scale=inv_total_spp, spp=spp_chunk,
        bvh_mode=bvh_mode)
    if film_cfg.rfilter == "gaussian":
        # the camera jitter again: sampler dims 0-1 of this pass's stream
        film = splat_steady_gaussian(film, height, width, spp_chunk, L,
                                     ray_weight, sampler.eval_2d(0),
                                     stddev=film_cfg.rfilter_stddev)
    else:
        film = splat_steady(film, spp_chunk, L, ray_weight)
    return film, n_rays


def render(
    scene: Scene,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    max_lanes: int = DEFAULT_MAX_LANES,
    progress_callback=None,
    return_stats: bool = False,
    regenerate: bool | None = None,
    film_state=None,
    checkpoint_callback=None,
    bvh_mode: str = BVH_MODE,
):
    """Render ``(steady (H, W, C), transient (H, W, T, C))`` for the
    scene's sensor, on the scene's device; a phasor film gives ``(steady,
    phasors (H, W, F, 2))``.  With a crop window H and W are the window's.

    With ``return_stats`` a third value holds ``rays`` (an int64 count of
    closest-hit lanes plus NEE shadow rays), ``spp`` and ``loop_iters``
    (bounces this call ran, one launch of each per-bounce kernel apiece;
    ``camera_unwarp`` adds one closest-hit launch a pass); the regen branch
    adds ``iters``, the iterations the JAX loop runs.

    Checkpoint/resume (multi-pass branch): ``checkpoint_callback(state)``
    is called after every pass with ``(film, passes done, rays so far)``,
    the film as host numpy copies; pass such a state back as
    ``film_state=`` to go on with the remaining passes.  Pass splitting is
    deterministic in (seed, spp, max_lanes), so the resumed render is bit
    for bit the uninterrupted one.  A resumed state is moved onto the
    scene's device.  :func:`save_film_state` / :func:`load_film_state`
    write and read it; the port's film has no padding, so these files are
    the port's own, not the JAX package's.

    ``bvh_mode`` (``"chunk"`` or ``"super"``) is the BVH kernel's traversal
    mode in scenes with an accel (``ops/bvh.py``).

    An NLOS scene renders through ``integrators/nlos_path.py:render_nlos``
    (``regenerate``, ``film_state`` and ``checkpoint_callback`` are not
    used there, as in the JAX package).
    """
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    if cfg.kind == "nlos_capture_meter" or icfg.kind == "transient_nlos_path":
        from .integrators.nlos_path import render_nlos

        return render_nlos(scene, spp=spp, seed=seed, sensor=sensor,
                           max_lanes=max_lanes,
                           progress_callback=progress_callback,
                           return_stats=return_stats, bvh_mode=bvh_mode)
    film_cfg = cfg.film
    spp = spp if spp is not None else cfg.spp
    dw, dh = film_cfg.data_width, film_cfg.data_height
    hw = dw * dh
    C = scene.variant.color_channels
    dev = scene.device

    if bvh_mode not in MODES:
        raise ValueError(f"bvh_mode {bvh_mode!r}: expected one of {MODES}")
    if regenerate is None:
        regenerate = (
            icfg.kind == "transient_path"
            and not icfg.camera_unwarp
            and not scene.variant.spectral
            and icfg.temporal_filter != "gaussian"
            and film_cfg.rfilter == "box"
            and not film_cfg.is_cropped
            and spp >= 8
        )
    if film_state is not None:
        regenerate = False  # resuming implies the multi-pass accumulator
    cam = build_camera(cfg, device=dev)
    sd = primal_sd(scene.data)
    if regenerate:
        lanes_per_pixel = max(1, min(spp, max_lanes // max(hw, 1)))
        film = film_init_any(film_cfg, C, device=dev)
        film, n_rays, iters, loop_iters = _regen_render(
            sd, cam, film, seed, film_cfg=film_cfg, icfg=icfg,
            spp_total=spp, lanes_per_pixel=lanes_per_pixel,
            bvh_mode=bvh_mode)
        if progress_callback is not None:
            progress_callback(1.0)
        stats = {"rays": n_rays, "spp": spp, "iters": iters,
                 "loop_iters": loop_iters}
    else:
        film, n_rays, spp, loop_iters = _multipass_render(
            sd, cam, seed, spp, film_cfg=film_cfg, icfg=icfg, channels=C,
            max_lanes=max_lanes, film_state=film_state,
            progress_callback=progress_callback,
            checkpoint_callback=checkpoint_callback, bvh_mode=bvh_mode)
        stats = {"rays": n_rays, "spp": spp, "loop_iters": loop_iters}
    steady, transient = develop_any(film, film_cfg, shape_hw=(dh, dw))
    stats.update(surface_sample_validation(film, film_cfg))
    if return_stats:
        return steady, transient, stats
    return steady, transient


def _multipass_render(sd, cam, seed, spp, *, film_cfg, icfg, channels,
                      max_lanes, film_state, progress_callback,
                      checkpoint_callback, bvh_mode):
    """The multi-pass branch -> (film, rays, total spp, bounces run)."""
    dw, dh = film_cfg.data_width, film_cfg.data_height
    hw = dw * dh
    dev = cam.origin.device
    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes  # even-ish split
    total_spp = spp_chunk * n_passes

    if film_state is not None:
        film, done_passes, total_rays = film_state
        # a copy: the film's transient is updated in place
        film = type(film)(*(torch.as_tensor(a).to(dev, copy=True)
                            for a in film))
        if film.steady.shape[-1] != channels:
            raise ValueError("film_state does not match this scene/variant")
    else:
        film = film_init_any(film_cfg, channels,
                             scan_pixels=hw if film_cfg.is_cropped else None,
                             device=dev)
        done_passes, total_rays = 0, 0
    for p in range(done_passes, n_passes):
        film, n_rays = _perspective_pass(
            sd, cam, film, seed, p, 1.0 / total_spp, film_cfg=film_cfg,
            icfg=icfg, width=dw, height=dh, spp_chunk=spp_chunk,
            bvh_mode=bvh_mode)
        total_rays = total_rays + n_rays
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)
        if checkpoint_callback is not None:
            checkpoint_callback((
                type(film)(*(a.detach().cpu().numpy().copy() for a in film)),
                p + 1, int(total_rays)))
    loop_iters = (n_passes - done_passes) * icfg.max_depth
    return film, total_rays, total_spp, loop_iters


def save_film_state(path, state) -> None:
    """Write a ``checkpoint_callback`` state to ``path`` (a numpy archive;
    a file name or a binary file object)."""
    film, done_passes, total_rays = state
    arrays = {f"film_{i}": np.asarray(torch.as_tensor(a).cpu())
              for i, a in enumerate(film)}
    np.savez(path, film_type=type(film).__name__, done_passes=done_passes,
             total_rays=int(total_rays), **arrays)


def load_film_state(path):
    """Read a state written by :func:`save_film_state`: (film with CPU
    tensors, passes done, rays so far)."""
    with np.load(path) as z:
        cls = _FILM_STATES[str(z["film_type"])]
        film = cls(*(torch.from_numpy(z[f"film_{i}"])
                     for i in range(len(cls._fields))))
        return film, int(z["done_passes"]), int(z["total_rays"])


def render_aovs(scene: Scene, spp: int = 16, seed: int = 0, sensor: int = 0,
                aovs=("albedo", "sh_normal", "depth", "position", "alpha"),
                bvh_mode: str = BVH_MODE):
    """First-hit arbitrary output variables of the steady image (the
    reference film's AOV channels, transient_hdr_film.py:176-190): per-pixel
    means over ``spp`` jittered camera rays (threefry stream 0) of the hit
    albedo, shading normal, depth, world position and coverage.  Returns
    {name: (H, W, k) tensor} on the scene's device."""
    from .bsdf import api as bsdf_api
    from .scene.scene import ray_intersect

    cfg = scene.sensors[sensor]
    if cfg.kind == "nlos_capture_meter":
        raise ValueError("AOVs apply to perspective sensors")
    w, h = cfg.film.width, cfg.film.height
    n = w * h * spp
    cam = build_camera(cfg, device=scene.device)
    ray, _pix, _w = sample_rays(cam, Sampler(seed, n, device=scene.device),
                                w, h, spp)
    sd = primal_sd(scene.data)
    si = ray_intersect(sd, ray, torch.ones((n,), dtype=torch.bool,
                                           device=scene.device), bvh_mode)
    valid = si.valid[:, None]
    lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                   sd.bsdf_kinds)
    out = {
        "albedo": torch.where(valid, lb.reflectance, 0.0),
        "sh_normal": torch.where(valid, si.frame.n, 0.0),
        "depth": torch.where(valid, si.t[:, None], 0.0),
        "position": torch.where(valid, si.p, 0.0),
        "alpha": valid.to(torch.float32),
    }
    return {k: v.reshape(spp, h * w, -1).mean(dim=0).reshape(h, w, -1)
            for k, v in out.items() if k in aovs}
