"""NLOS laser-focus helpers (counterpart of ``mitransient_tpu/nlos.py``,
the reference's ``nlos.py:5-70``).

They aim the scene's laser (a delta emitter) at a point of the relay wall,
writing its rows of the device emitter table in place, and record the
laser target and the laser -> wall optical path length on the scene, where
the NLOS integrator reads them.
"""
from __future__ import annotations

import numpy as np

from .core.transform import Transform4
from .scene.schema import Scene


def focus_emitter_at_relay_wall_3dpoint(target, scene: Scene, emitter="laser"):
    """Aim the emitter ``emitter`` at ``target`` (world space)."""
    em_idx = scene.emitter_index(emitter)
    origin = scene._emitters[em_idx].to_world.translation
    t = Transform4().look_at(origin=origin, target=target, up=[0, 1, 0])
    scene.replace_emitter_transform(em_idx, t)
    target = np.asarray(target, np.float64)
    scene.laser_target = target
    scene.laser_bounce_opl = float(np.linalg.norm(target - origin))
    scene.laser_focused = True
    return scene


def focus_emitter_at_relay_wall_uv(uv, scene: Scene, relay_wall=None,
                                   emitter="laser"):
    """uv on the relay wall -> 3-D point -> focus (reference nlos.py:35-47)."""
    wall = _find_relay_wall(scene, relay_wall)
    target = wall.position_from_uv(np.asarray(uv, np.float64))
    return focus_emitter_at_relay_wall_3dpoint(target, scene, emitter)


def focus_emitter_at_relay_wall_pixel(pixel, scene: Scene, relay_wall=None,
                                      emitter="laser"):
    """Film pixel -> uv over the scan grid (in confocal mode the original
    film's size, reference nlos.py:50-70) -> focus."""
    sensor = next(s for s in scene.sensors if s.kind == "nlos_capture_meter")
    sw, sh = sensor.scan_size
    uv = np.asarray([pixel[0] / sw, pixel[1] / sh], np.float64)
    return focus_emitter_at_relay_wall_uv(uv, scene, relay_wall, emitter)


def _find_relay_wall(scene: Scene, relay_wall):
    from .scene.shapes import Rectangle

    if relay_wall is not None:
        idx = (scene.shape_index(relay_wall) if isinstance(relay_wall, str)
               else relay_wall)
        return scene.shapes[idx]
    for s_cfg in scene.sensors:
        if s_cfg.kind == "nlos_capture_meter" and s_cfg.shape_index >= 0:
            shape = scene.shapes[s_cfg.shape_index]
            if not isinstance(shape, Rectangle):
                raise TypeError("relay wall must be a rectangle")
            return shape
    raise ValueError("no relay wall (rectangle with nlos_capture_meter) found")


def scan_confocal(scene: Scene, spp=None, seed: int = 0, sensor: int = 0,
                  return_stats: bool = False):
    """A whole confocal scan, every scan point in one wavefront a pass
    (``integrators/nlos_path.py:render_nlos_confocal_scan``), in place of
    the reference's loop of focus + render over the grid.  Returns
    (steady (ph, pw, C), transient (ph, pw, T, C)) over the scan grid."""
    from .integrators.nlos_path import render_nlos_confocal_scan

    return render_nlos_confocal_scan(scene, spp=spp, seed=seed,
                                     sensor=sensor,
                                     return_stats=return_stats)
