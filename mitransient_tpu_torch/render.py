"""Top-level render orchestration (counterpart of
``mitransient_tpu/render.py``, its regen and multi-pass branches).

A render takes one of two branches, chosen as the JAX package chooses:

* the path-regeneration loop (``integrators/path_regen.py``), one pass
  over the whole spp budget, for plain ``transient_path`` renders of at
  least 8 spp with a box filter, no crop and no ``camera_unwarp``.  On
  the card a block of the loop (the iterations between two live-lane
  checks) into a transient film is captured once as a CUDA graph and
  replayed (``regengraph.py``); elsewhere it runs eagerly;
* the multi-pass accumulator otherwise: the spp budget is split into
  passes of at most ``max_lanes`` lanes, each an independently seeded
  threefry stream (row ``pass`` of ``rng.pass_keys(seed, ...)``) traced
  by ``integrators/path.py``, accumulated into one film by
  ``passgraph.run_passes``.  On the card a ``transient_path`` pass is
  captured once as a CUDA graph and replayed (``passgraph.py``); elsewhere
  it runs eagerly.

The ``transient_prbvolpath`` integrator (participating media) always
takes the multi-pass branch, each pass traced by
``integrators/volpath.py``.  A scene with an ``nlos_capture_meter`` or
the ``transient_nlos_path`` integrator goes to the NLOS renderer
(``integrators/nlos_path.py``), as in the JAX package.  Every branch
renders every variant (polarized: a Mueller throughput and Stokes films
of 4 C channels; spectral: hero wavelengths and sRGB films, never through
the regen loop).  :func:`render_aovs` gives first-hit AOVs of a perspective sensor.  The
render runs on the device of ``scene.data``, under ``torch.no_grad()``.

Differentiable rendering (the JAX package's ``render.py:300-730``):
:func:`render_backward` gives parameter gradients by the PRB two-sweep
replay for ``transient_path`` (``integrators/prb.py``) and
``transient_prbvolpath`` (``integrators/prb_vol.py``), and by full AD
through the wavefront (``integrators/fullad.py``) for NLOS captures and
``method="fullad"``; :func:`render_forward` gives derivative videos by the
PRB forward replay for unpolarized, non-spectral ``transient_path`` and by
forward-mode AD through the whole primal (``torch.autograd.forward_ad``)
otherwise.  Both split the spp budget into chunks and add up, and both
take the JAX package's route for every integrator and variant.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import passgraph, regengraph, trace
from .core.rng import Sampler, pass_keys
from .core.math import divide
from .film.transient_film import (
    TransientFilmState,
    develop_any,
    film_init_any,
    splat_steady,
    splat_steady_gaussian,
    splat_transient_pair,
    surface_sample_validation,
)
from .film.phasor_film import PhasorFilmState
from .integrators import DEFAULT_MAX_LANES, _split_spp
from .integrators.path import sample_primal
from .integrators.path_regen import sample_primal_regen
from .integrators.prb_vol import sample_volpath_adjoint
from .integrators.volpath import sample_volpath_primal
from .integrators.nlos_path import film_channels
from .integrators.fullad import EXHAUSTIVE_REFUSAL
from .integrators.prb import (
    DiffParams,
    add_params,
    adjoint_images,
    extract_params,
    grads_to_named,
    insert_params,
    sample_adjoint,
)
from .ops.bvh import BVH_MODE, MODES
from .scene.scene import primal_sd
from .scene.schema import Scene
from .sensors.perspective import build_camera, sample_rays

_FILM_STATES = {cls.__name__: cls for cls in (TransientFilmState,
                                               PhasorFilmState)}


def _regen_render(sd, cam, film, seed, *, film_cfg, icfg, spp_total,
                  lanes_per_pixel, bvh_mode, polarized):
    graph = regengraph.route(
        sd, cam, film, film_cfg=film_cfg, icfg=icfg, spp_total=spp_total,
        lanes_per_pixel=lanes_per_pixel, bvh_mode=bvh_mode,
        polarized=polarized)
    film, steady_lanes, n_rays, iters, loop_iters = sample_primal_regen(
        sd, seed, cam, film, film_cfg, icfg, spp_total, lanes_per_pixel,
        bvh_mode, polarized=polarized, graph=graph)
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


def _perspective_pass(sd, cam, film, key, inv_total_spp, *, film_cfg, icfg,
                      width, height, spp_chunk, bvh_mode, variant):
    """One pass of ``spp_chunk`` samples a pixel over the data window
    (``width`` x ``height``) on the stream key ``key``; returns (film,
    n_rays).  ``inv_total_spp`` is a Python number, or a 0-dim float32
    tensor of the same value (the pass graph's scale, ``passgraph.py``)."""
    sampler = Sampler.on(key, width * height * spp_chunk)
    # width/height are the data (crop) dims; the uv mapping uses the full
    # sensor
    ray, pix, ray_weight = sample_rays(
        cam, sampler, width, height, spp_chunk,
        crop_offset=(film_cfg.crop_offset_x, film_cfg.crop_offset_y),
        full_size=(film_cfg.width, film_cfg.height))
    sample_fn = (sample_volpath_primal
                 if icfg.kind == "transient_prbvolpath" else sample_primal)
    film, L, _valid, n_rays = sample_fn(
        sd, sampler, ray, pix, ray_weight, film, film_cfg, icfg,
        sample_scale=inv_total_spp, spp=spp_chunk, bvh_mode=bvh_mode,
        polarized=variant.polarized, cam_vertical=cam.R[:, 1],
        spectral=variant.spectral)
    if film_cfg.rfilter == "gaussian":
        # the camera jitter again: sampler dims 0-1 of this pass's stream
        film = splat_steady_gaussian(film, height, width, spp_chunk, L,
                                     ray_weight, sampler.eval_2d(0),
                                     stddev=film_cfg.rfilter_stddev)
    else:
        film = splat_steady(film, spp_chunk, L, ray_weight)
    return film, n_rays


@torch.no_grad()
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
    C is the variant's: 1 (mono), 3 (rgb, spectral), and four times that
    for the polarized variants, Stokes-major ([I, Q, U, V] of each color
    block: ``[I, Q, U, V]`` for mono_polarized, ``[I_rgb, Q_rgb, U_rgb,
    V_rgb]`` for rgb_polarized and spectral_polarized).  Spectral renders
    take the multi-pass branch, and their films hold linear sRGB.

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
    used there, as in the JAX package).  ``regenerate=True`` for a
    spectral scene raises ``NotImplementedError``: the JAX package renders
    it as plain RGB there.
    """
    with trace.span("mitr:render"):
        cfg = scene.sensors[sensor]
        icfg = scene.integrator
        var = scene.variant
        if (cfg.kind == "nlos_capture_meter"
                or icfg.kind == "transient_nlos_path"):
            from .integrators.nlos_path import render_nlos

            return render_nlos(scene, spp=spp, seed=seed, sensor=sensor,
                               max_lanes=max_lanes,
                               progress_callback=progress_callback,
                               return_stats=return_stats, bvh_mode=bvh_mode)
        film_cfg = cfg.film
        spp = spp if spp is not None else cfg.spp
        dw, dh = film_cfg.data_width, film_cfg.data_height
        hw = dw * dh
        C = film_channels(var)
        dev = scene.device

        if bvh_mode not in MODES:
            raise ValueError(f"bvh_mode {bvh_mode!r}: expected one of {MODES}")
        if regenerate is None:
            regenerate = (
                icfg.kind == "transient_path"
                and not icfg.camera_unwarp
                and not var.spectral
                and icfg.temporal_filter != "gaussian"
                and film_cfg.rfilter == "box"
                and not film_cfg.is_cropped
                and spp >= 8
            )
        if film_state is not None:
            regenerate = False  # resuming implies the multi-pass accumulator
        if regenerate and var.spectral:
            raise NotImplementedError(
                "the regen loop has no spectral branch (the JAX package's "
                "renders RGB there); render spectral scenes with "
                "regenerate=None or False")
        cam = build_camera(cfg, device=dev)
        sd = primal_sd(scene.data)
        if regenerate:
            lanes_per_pixel = max(1, min(spp, max_lanes // max(hw, 1)))
            film = film_init_any(film_cfg, C, device=dev)
            film, n_rays, iters, loop_iters = _regen_render(
                sd, cam, film, seed, film_cfg=film_cfg, icfg=icfg,
                spp_total=spp, lanes_per_pixel=lanes_per_pixel,
                bvh_mode=bvh_mode, polarized=var.polarized)
            if progress_callback is not None:
                progress_callback(1.0)
            stats = {"rays": n_rays, "spp": spp, "iters": iters,
                     "loop_iters": loop_iters}
        else:
            film, n_rays, spp, loop_iters = _multipass_render(
                sd, cam, seed, spp, film_cfg=film_cfg, icfg=icfg, channels=C,
                max_lanes=max_lanes, film_state=film_state,
                progress_callback=progress_callback,
                checkpoint_callback=checkpoint_callback, bvh_mode=bvh_mode,
                variant=var)
            stats = {"rays": n_rays, "spp": spp, "loop_iters": loop_iters}
        steady, transient = develop_any(film, film_cfg, shape_hw=(dh, dw))
        stats.update(surface_sample_validation(film, film_cfg))
        if return_stats:
            return steady, transient, stats
        return steady, transient


def _multipass_render(sd, cam, seed, spp, *, film_cfg, icfg, channels,
                      max_lanes, film_state, progress_callback,
                      checkpoint_callback, bvh_mode, variant):
    """The multi-pass branch -> (film, rays, total spp, bounces run)."""
    dw, dh = film_cfg.data_width, film_cfg.data_height
    hw = dw * dh
    dev = cam.origin.device
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)

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
    body = functools.partial(
        _perspective_pass, film_cfg=film_cfg, icfg=icfg, width=dw, height=dh,
        spp_chunk=spp_chunk, bvh_mode=bvh_mode, variant=variant)
    graph = passgraph.route(
        sd, cam, film, film_cfg=film_cfg, icfg=icfg, variant=variant,
        width=dw, height=dh, spp_chunk=spp_chunk, bvh_mode=bvh_mode)
    film, total_rays = passgraph.run_passes(
        body, sd, cam, film, seed=seed, first=done_passes, n_passes=n_passes,
        scale=1.0 / total_spp, graph=graph, rays=total_rays,
        progress_callback=progress_callback,
        checkpoint_callback=checkpoint_callback)
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


@torch.no_grad()
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


# --------------------------------------------------------------------------
# Differentiable rendering (PRB two-sweep, full AD, forward mode)
# --------------------------------------------------------------------------

def _refuse_film(film_cfg) -> None:
    """The refusals of every differentiable route: the phasor film (as in
    the JAX package) and a crop window.  The JAX package refuses the crop
    only in its PRB replay and forward mode; its volumetric PRB and full
    AD fail on one (``fullad.py:119`` reshapes the cropped film to the
    full film's size), so the port refuses it on every route."""
    if film_cfg.is_cropped:
        raise NotImplementedError(
            "differential rendering with a cropped film is not supported; "
            "render the full film or crop the gradient instead")
    if film_cfg.kind == "phasor_hdr_film":
        raise NotImplementedError(
            "the phasor film is not differentiable (matching the "
            "reference's PhasorHDRFilm); use transient_hdr_film for "
            "gradients")


def _prb_setup(scene: Scene, spp, sensor,
               max_lanes: int = DEFAULT_MAX_LANES * 4):
    """The refusals of the ``transient_path`` PRB replay and of forward
    mode (crop, phasor film, 2^32 lanes, the exhaustive capture) and the
    spp split -> (sensor config, integrator config, film config, spp, HW,
    spp a chunk, chunks)."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    _refuse_film(film_cfg)
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    if hw * spp > (1 << 32):
        # the reference's one-wavefront refusal (common.py:51-85, 237-240);
        # below it the spp budget is chunked and the chunks add up
        raise ValueError(
            f"render_backward/forward wavefront exceeds 2^32 lanes "
            f"(lanes = {hw * spp}); reduce spp")
    if ((cfg.kind == "nlos_capture_meter"
         or icfg.kind == "transient_nlos_path")
            and icfg.capture_type == "exhaustive"):
        raise ValueError(EXHAUSTIVE_REFUSAL)
    spp_chunk, n_passes, _total = _split_spp(spp, hw, max_lanes)
    return cfg, icfg, film_cfg, spp, hw, spp_chunk, n_passes


def _backward_pass(sd, cam, grad_st_flat, grad_tr_flat, key, inv_spp, *,
                   film_cfg, icfg, width, height, spp, bvh_mode):
    """One spp chunk of the PRB backward on the stream key ``key``: the
    primal sweep for L (no film), then the adjoint replay.  -> DiffParams
    gradients."""
    sampler = Sampler.on(key, width * height * spp)
    ray, pix, ray_weight = sample_rays(cam, sampler, width, height, spp)
    _f, L, _v, _r = sample_primal(
        sd, sampler, ray, pix, ray_weight, None, film_cfg, icfg,
        sample_scale=inv_spp, spp=spp, bvh_mode=bvh_mode, enable_film=False)
    with trace.span("mitr:adjoint"):
        return sample_adjoint(
            sd, sampler.key, ray, pix, ray_weight, L, grad_tr_flat,
            grad_st_flat, film_cfg, icfg, inv_spp, mode="backward",
            bvh_mode=bvh_mode)


@torch.no_grad()
def render_backward(scene: Scene, grad_in, spp: int | None = None,
                    seed: int = 0, sensor: int = 0,
                    method: str | None = None,
                    max_lanes: int = DEFAULT_MAX_LANES * 4,
                    bvh_mode: str = BVH_MODE):
    """Reverse-mode differentiable rendering
    (``TransientADIntegrator.render_backward``, common.py:325-409).

    ``grad_in`` = (grad_steady (H, W, C) | None, grad_transient
    (H, W, T, C) | None), arrays or tensors.  Returns {traverse path:
    gradient tensor}, plus the table gradients (:class:`DiffParams`) under
    ``'__tables__'``, on the scene's device.

    The routes, in the JAX package's order (its ``render.py:376-396``):
    an unpolarized ``transient_prbvolpath`` scene without
    ``method="fullad"`` takes the volumetric replay
    (:func:`render_backward_volpath`, chunks of 2^20 lanes), a spectral
    one included, whose replay differentiates the RGB estimator as the
    JAX package's does; ``transient_nlos_path`` (single and confocal), a
    polarized volumetric scene, any polarized or spectral scene and
    ``method="fullad"`` take full AD through the wavefront of the scene's
    variant, in chunks of 2^20 lanes, whose gradients also reach the shape
    poses and the delta emitters' positions; the rest, unpolarized RGB or
    mono ``transient_path``, takes the PRB two-sweep replay in chunks of
    at most ``max_lanes`` lanes.  The phasor film and crop windows are
    refused on every route (:func:`_refuse_film`), the exhaustive capture
    in full AD, and wavefronts of more than 2^32 lanes in the PRB replay
    of ``transient_path`` (:func:`_prb_setup`): the chunked routes never
    build one wavefront."""
    with trace.span("mitr:render_backward"):
        cfg = scene.sensors[sensor]
        icfg = scene.integrator
        var = scene.variant
        _refuse_film(cfg.film)
        if (icfg.kind == "transient_prbvolpath" and method != "fullad"
                and not var.polarized):
            return render_backward_volpath(scene, grad_in, spp=spp, seed=seed,
                                           sensor=sensor, bvh_mode=bvh_mode)
        if (icfg.kind in ("transient_nlos_path", "transient_prbvolpath")
                or var.polarized or var.spectral or method == "fullad"):
            from .integrators.fullad import render_backward_fullad

            return render_backward_fullad(scene, grad_in, spp=spp, seed=seed,
                                          sensor=sensor, bvh_mode=bvh_mode)
        cfg, icfg, film_cfg, spp, hw, spp_chunk, n_passes = _prb_setup(
            scene, spp, sensor, max_lanes)
        gs, gt = adjoint_images(grad_in, film_cfg,
                                scene.variant.color_channels, scene.device)
        cam = build_camera(cfg, device=scene.device)
        sd = primal_sd(scene.data)
        total_spp = spp_chunk * n_passes
        keys = pass_keys(seed, range(n_passes), scene.device)
        grads = None
        for p in range(n_passes):
            grads = add_params(grads, _backward_pass(
                sd, cam, gs, gt.reshape(hw * film_cfg.temporal_bins, -1),
                keys[p], 1.0 / total_spp, film_cfg=film_cfg,
                icfg=icfg, width=film_cfg.width, height=film_cfg.height,
                spp=spp_chunk, bvh_mode=bvh_mode))
        return grads_to_named(scene, grads)


def _backward_pass_vol(sd, cam, grad_st_flat, grad_tr_flat, key, inv_spp, *,
                       film_cfg, icfg, spp, bvh_mode):
    """One spp chunk of the volumetric PRB backward on the stream key
    ``key``: the primal sweep for L (no film), then the replay with
    per-term adjoint reads."""
    width, height = film_cfg.width, film_cfg.height
    sampler = Sampler.on(key, width * height * spp)
    ray, pix, ray_weight = sample_rays(cam, sampler, width, height, spp)
    _f, L, _v, _r = sample_volpath_primal(
        sd, sampler, ray, pix, ray_weight, None, film_cfg, icfg,
        sample_scale=inv_spp, spp=spp, bvh_mode=bvh_mode, enable_film=False)
    return sample_volpath_adjoint(
        sd, sampler.key, ray, pix, ray_weight, L, grad_tr_flat, grad_st_flat,
        film_cfg, icfg, inv_spp, bvh_mode=bvh_mode)


@torch.no_grad()
def render_backward_volpath(scene: Scene, grad_in, spp: int | None = None,
                            seed: int = 0, sensor: int = 0,
                            max_lanes: int = 1 << 20,
                            bvh_mode: str = BVH_MODE):
    """Volumetric PRB backward (``integrators/prb_vol.py``): two
    primal-shaped sweeps a chunk, memory independent of the path depth,
    over spp chunks of at most ``max_lanes`` lanes split as the JAX
    package splits them (the pass index seeds each chunk's streams).
    The same dict as :func:`render_backward`.

    The replay is the RGB (or mono) estimator's, as the JAX package's
    (``prb_vol.py``): a spectral scene is differentiated through the
    estimator of its RGB tables, not through its spectral primal (ROADMAP
    queue 3), and a polarized scene is refused (``render_backward``
    sends it to full AD)."""
    if scene.variant.polarized:
        raise NotImplementedError(
            "polarized volumetric is primal-only via the PRB replay; "
            "render_backward dispatches polarized volumetric scenes to "
            "the chunked full-AD path instead")
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    _refuse_film(film_cfg)
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    spp_chunk, n_passes, _total = _split_spp(spp, hw, max_lanes)
    gs, gt = adjoint_images(grad_in, film_cfg, scene.variant.color_channels,
                            scene.device)
    cam = build_camera(cfg, device=scene.device)
    sd = primal_sd(scene.data)
    keys = pass_keys(seed, range(n_passes), scene.device)
    grads = None
    for p in range(n_passes):
        grads = add_params(grads, _backward_pass_vol(
            sd, cam, gs, gt.reshape(hw * film_cfg.temporal_bins, -1), keys[p],
            1.0 / (spp_chunk * n_passes), film_cfg=film_cfg, icfg=icfg,
            spp=spp_chunk, bvh_mode=bvh_mode))
    return grads_to_named(scene, grads)


def _forward_pass(sd, cam, tangents, key, inv_spp, *, film_cfg, icfg, width,
                  height, spp, bvh_mode):
    """One spp chunk of the PRB forward replay on the stream key ``key``
    -> the derivative film's state (additive over chunks; the caller
    develops the sum).  Each bounce's derivative splat goes into the film
    through K3."""
    n = width * height * spp
    dev = cam.origin.device
    C = sd.bsdf.reflectance.shape[-1]
    sampler = Sampler.on(key, n)
    ray, pix, ray_weight = sample_rays(cam, sampler, width, height, spp)
    _f, L, _v, _r = sample_primal(
        sd, sampler, ray, pix, ray_weight, None, film_cfg, icfg,
        sample_scale=inv_spp, spp=spp, bvh_mode=bvh_mode, enable_film=False)
    vals, dists = sample_adjoint(
        sd, sampler.key, ray, pix, ray_weight, L, None, None, film_cfg, icfg,
        inv_spp, mode="forward", tangents=tangents, bvh_mode=bvh_mode)
    dfilm = film_init_any(film_cfg, C, device=dev)
    act = torch.ones((n,), dtype=torch.bool, device=dev)
    for v, dist in zip(vals, dists):
        dfilm = splat_transient_pair(dfilm, film_cfg, spp, dist, v, None,
                                     None, act, icfg.temporal_filter,
                                     icfg.gaussian_stddev)
    # the steady derivative: the lanes' raw sum of dLo (the splats carry
    # the 1 / total spp scale, which develop's weight sum divides again)
    dL_total = vals[0]
    for v in vals[1:]:
        dL_total = dL_total + v
    return splat_steady(dfilm, spp, divide(dL_total, inv_spp), ray_weight)


_TANGENT_TABLES = {  # the JAX package's _build_tangents tables
    "bsdf.reflectance": "bsdf_reflectance",
    "emitter.radiance": "emitter_radiance",
    "bsdf.alpha": "bsdf_alpha",
    "bsdf.textures": "bsdf_textures",
    "medium.albedo": "medium_albedo",
    "medium.sigma_t": "medium_sigma_t",
}


def _build_tangents(scene: Scene, tangent: dict) -> DiffParams:
    """A {traverse path or whole-table name: value} tangent as DiffParams
    (zeros elsewhere).  As in the JAX package, the tables of
    :data:`_TANGENT_TABLES` take tangents: an isotropic ``alpha`` path moves
    ``alpha_u`` only, and other paths are ignored."""
    dev = scene.device
    out = {f: (None if t is None else torch.zeros_like(t))
           for f, t in extract_params(scene.data)._asdict().items()}
    for path, val in tangent.items():
        v = torch.as_tensor(val, dtype=torch.float32, device=dev)
        if path in _TANGENT_TABLES:  # a whole table
            out[_TANGENT_TABLES[path]] = v
        elif path in scene._param_paths:
            table, idx = scene._param_paths[path]
            field = _TANGENT_TABLES.get(table)
            if field is not None and out[field] is not None:
                out[field] = out[field].clone()
                out[field][idx] = v
    return DiffParams(**out)


def _forward_pass_jvp(sd, ctx, tangents, key, inv_spp, *, film_cfg, icfg,
                      spp, hw, kind, skip_le, bvh_mode, variant):
    """Forward mode through the whole primal of one spp chunk on the stream
    key ``key``, with
    ``torch.autograd.forward_ad`` dual tables: the ray kernels get detached
    (plain) inputs, the film splat goes through K3's Function, whose jvp
    is K3 on the tangents.  The primal is the ``variant``'s (4 C Stokes
    channels when polarized).  -> (primal, tangent) film states."""
    from torch.autograd import forward_ad as fwAD

    dev = sd.bsdf.reflectance.device
    with fwAD.dual_level():
        theta = DiffParams(*(
            None if p is None else fwAD.make_dual(
                p, t if t is not None else torch.zeros_like(p))
            for p, t in zip(extract_params(sd), tangents)))
        sdt = insert_params(sd, theta)
        C = sdt.bsdf.reflectance.shape[-1] * (4 if variant.polarized else 1)
        sampler = Sampler.on(key, spp * hw)
        if kind == "transient_nlos_path":
            from .integrators.nlos_path import (
                sample_nlos_primal,
                sample_nlos_rays,
            )

            film = film_init_any(film_cfg, C, scan_pixels=hw, device=dev)
            ray, rw = sample_nlos_rays(ctx, spp, hw)
            film, L, _v, _r = sample_nlos_primal(
                sdt, ctx, sampler, ray, rw, film, film_cfg, icfg, inv_spp,
                spp, skip_le=skip_le, bvh_mode=bvh_mode,
                polarized=variant.polarized, spectral=variant.spectral)
        else:
            film = film_init_any(film_cfg, C, device=dev)
            ray, pix, rw = sample_rays(ctx, sampler, film_cfg.width,
                                       film_cfg.height, spp)
            sample_fn = (sample_volpath_primal
                         if kind == "transient_prbvolpath" else sample_primal)
            film, L, _v, _r = sample_fn(
                sdt, sampler, ray, pix, rw, film, film_cfg, icfg, inv_spp,
                spp, bvh_mode, polarized=variant.polarized,
                cam_vertical=ctx.R[:, 1], spectral=variant.spectral)
        state = splat_steady(film, spp, L, rw)
        parts = [fwAD.unpack_dual(a) for a in state]
        primal = type(state)(*(x.primal.clone() for x in parts))
        tangent = type(state)(*(
            torch.zeros_like(x.primal) if x.tangent is None
            else x.tangent.clone() for x in parts))
    return primal, tangent


@torch.no_grad()
def render_forward(scene: Scene, tangent: dict, spp: int | None = None,
                   seed: int = 0, sensor: int = 0,
                   max_lanes: int = DEFAULT_MAX_LANES * 4,
                   bvh_mode: str = BVH_MODE):
    """Forward-mode differentiable rendering (``render_forward``,
    common.py:215-323): the derivative (d_steady (H, W, C), d_transient
    (H, W, T, C)) along ``tangent``, a dict of traverse paths (or the
    whole-table names ``'bsdf.reflectance'``, ``'emitter.radiance'``,
    ``'bsdf.alpha'``, ``'bsdf.textures'``, ``'medium.albedo'``,
    ``'medium.sigma_t'``) to tangent values.

    Unpolarized, non-spectral ``transient_path`` takes the PRB forward
    replay, whose derivative splats go into the film through K3; NLOS
    single and confocal captures, volumetric scenes and every polarized or
    spectral scene take forward-mode AD through the whole primal of the
    scene's variant, as in the JAX package (its ``render.py:675-715``).
    An exhaustive capture is refused as in the reference
    (transientnlospath.py:729-731), and so are the refusals of
    :func:`_prb_setup` on every route, as in the JAX package."""
    cfg, icfg, film_cfg, spp, hw, spp_chunk, n_passes = _prb_setup(
        scene, spp, sensor, max_lanes)
    nlos = (cfg.kind == "nlos_capture_meter"
            or icfg.kind == "transient_nlos_path")
    tangents = _build_tangents(scene, tangent)
    total_spp = spp_chunk * n_passes
    dev = scene.device
    keys = pass_keys(seed, range(n_passes), dev)

    def add_states(a, b):
        return b if a is None else type(b)(*(x + y for x, y in zip(a, b)))

    var = scene.variant
    if (icfg.kind == "transient_path" and not nlos and not var.polarized
            and not var.spectral):
        cam = build_camera(cfg, device=dev)
        dfilm = None
        for p in range(n_passes):
            dfilm = add_states(dfilm, _forward_pass(
                primal_sd(scene.data), cam, tangents, keys[p],
                1.0 / total_spp, film_cfg=film_cfg, icfg=icfg,
                width=film_cfg.width, height=film_cfg.height,
                spp=spp_chunk, bvh_mode=bvh_mode))
        return develop_any(dfilm, film_cfg)

    skip_le = False
    if nlos:
        from .integrators.nlos_path import can_skip_le, prepare_nlos

        ctx = prepare_nlos(scene, cfg, bvh_mode)
        kind = "transient_nlos_path"
        skip_le = can_skip_le(scene.data)
    else:
        ctx = build_camera(cfg, device=dev)
        kind = icfg.kind
    # add the (primal, tangent) film states over the chunks, then take the
    # jvp of develop once at the sum (the filter weights carry no tangent)
    s_tot = t_tot = None
    for p in range(n_passes):
        s_p, t_p = _forward_pass_jvp(
            scene.data, ctx, tangents, keys[p], 1.0 / total_spp,
            film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw, kind=kind,
            skip_le=skip_le, bvh_mode=bvh_mode, variant=var)
        s_tot, t_tot = add_states(s_tot, s_p), add_states(t_tot, t_p)
    from torch.autograd import forward_ad as fwAD

    with fwAD.dual_level():
        state = type(s_tot)(*(fwAD.make_dual(a, t)
                              for a, t in zip(s_tot, t_tot)))
        out = develop_any(state, film_cfg,
                          shape_hw=(film_cfg.height, film_cfg.width))
        return tuple(fwAD.unpack_dual(o).tangent.clone() for o in out)
