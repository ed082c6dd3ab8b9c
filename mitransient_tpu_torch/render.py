"""Top-level render orchestration (counterpart of
``mitransient_tpu/render.py``, regen branch).

The port renders through the path-regeneration loop
(``integrators/path_regen.py``) only.  A call that the JAX package would
send down its multi-pass accumulator, its NLOS renderer or a
differentiable renderer raises ``NotImplementedError`` naming the ROADMAP
item that will port it.  The render runs on the device of
``scene.data``.
"""
from __future__ import annotations

import logging

from .film.transient_film import develop, film_init
from .integrators.path_regen import sample_primal_regen
from .scene.scene import primal_sd
from .scene.schema import Scene
from .sensors.perspective import build_camera

# Lane budget: lanes = pixels * lanes_per_pixel.  2^21 lanes * ~60 f32 of
# live state is about 0.5 GB.
DEFAULT_MAX_LANES = 1 << 21

_log = logging.getLogger("mitransient_tpu_torch")


def _regen_render(sd, cam, film, seed, *, film_cfg, icfg, spp_total,
                  lanes_per_pixel):
    film, steady_lanes, n_rays, iters, loop_iters = sample_primal_regen(
        sd, seed, cam, film, film_cfg, icfg, spp_total, lanes_per_pixel)
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


def _refuse_multipass(why: str):
    raise NotImplementedError(
        f"{why}: this render needs the multi-pass accumulator, which is not "
        "ported yet (ROADMAP item 10)")


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
):
    """Render ``(steady (H, W, C), transient (H, W, T, C))`` for the
    scene's sensor, on the scene's device.

    With ``return_stats`` a third value holds ``rays`` (int64 count of
    closest-hit lanes plus NEE shadow rays), ``spp``, ``iters`` (the
    iterations the JAX loop runs) and ``loop_iters`` (iterations this loop
    ran, one launch of each kernel apiece).  As in the JAX regen branch,
    ``checkpoint_callback`` is not called: the render is one pass.
    """
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.data_width * film_cfg.data_height

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
    if film_state is not None:  # resuming implies the multi-pass accumulator
        _refuse_multipass("film_state")
    if not regenerate:
        _refuse_multipass(
            f"spp={spp}, camera_unwarp={icfg.camera_unwarp}, "
            f"temporal_filter={icfg.temporal_filter!r}, "
            f"rfilter={film_cfg.rfilter!r}, cropped={film_cfg.is_cropped}, "
            f"regenerate={regenerate}")

    dev = scene.device
    lanes_per_pixel = max(1, min(spp, max_lanes // max(hw, 1)))
    cam = build_camera(cfg, device=dev)
    film = film_init(film_cfg, scene.variant.color_channels, device=dev)
    film, n_rays, iters, loop_iters = _regen_render(
        primal_sd(scene.data), cam, film, seed,
        film_cfg=film_cfg, icfg=icfg, spp_total=spp,
        lanes_per_pixel=lanes_per_pixel)
    if progress_callback is not None:
        progress_callback(1.0)
    steady, transient = develop(film, film_cfg)
    extra = surface_sample_validation(film, film_cfg)
    if return_stats:
        return steady, transient, {"rays": n_rays, "spp": spp,
                                   "iters": iters, "loop_iters": loop_iters,
                                   **extra}
    return steady, transient


def surface_sample_validation(film, film_cfg) -> dict:
    """Host-side half of the opt-in splat validation: read the counters
    accumulated by ``splat_transient_pair`` and log one warning per render."""
    if not (film_cfg.warn_negative or film_cfg.warn_invalid):
        return {}
    neg = float(film.n_negative)
    inv = float(film.n_invalid)
    if neg > 0:
        _log.warning("Negative sample values: %d splats below -1e-5 "
                     "(warn_negative)", int(neg))
    if inv > 0:
        _log.warning("Invalid sample values: %d non-finite splats "
                     "(warn_invalid)", int(inv))
    return {"n_negative": neg, "n_invalid": inv}

