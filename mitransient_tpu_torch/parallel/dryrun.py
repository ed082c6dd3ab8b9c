"""A multi-shard dry run on tiny shapes (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``)."""
from __future__ import annotations

import numpy as np

from .mesh import make_mesh, render_backward_sharded, render_sharded


def _small_cbox(mt, device, w=32, h=32, bins=64, max_depth=4):
    d = mt.cornell_box()
    d["sensor"]["film"].update(width=w, height=h, temporal_bins=bins)
    d["integrator"]["max_depth"] = max_depth
    return mt.load_dict(d, device=device)


def nlos_confocal_dict() -> dict:
    """The dry run's tiny confocal NLOS capture: a relay wall, a hidden
    target 0.75 behind it and a projector laser; a 1x1 film over a 2x2
    scan, 32 bins, depth 3."""
    white = {"type": "diffuse",
             "reflectance": {"type": "rgb", "value": [1, 1, 1]}}
    return {
        "type": "scene",
        "integrator": {
            "type": "transient_nlos_path",
            "max_depth": 3,
            "nlos_laser_sampling": True,
            "nlos_hidden_geometry_sampling": True,
            "nlos_hidden_geometry_sampling_includes_relay_wall": False,
            "capture_type": "confocal",
        },
        "hidden-target": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 0.0, 1.0],
                "rotate": {"axis": [0, 1, 0], "angle": 180},
                "scale": 0.5,
            },
            "bsdf": white,
        },
        "laser": {
            "type": "projector",
            "to_world": {"translate": [-0.5, 0.0, 0.25]},
            "irradiance": {"type": "rgb", "value": [1, 1, 1]},
            "fov": 0.2,
        },
        "relay_wall": {
            "type": "rectangle",
            "bsdf": white,
            "nlos_sensor": {
                "type": "nlos_capture_meter",
                "sensor_origin": [-0.5, 0.0, 0.25],
                "original_film_width": 2,
                "original_film_height": 2,
                "film": {
                    "type": "transient_hdr_film",
                    "width": 1,
                    "height": 1,
                    "temporal_bins": 32,
                    "bin_width_opl": 0.2,
                    "start_opl": 0.0,
                },
            },
        },
    }


def exhaustive_dict() -> dict:
    """:func:`nlos_confocal_dict` as an exhaustive capture: a 2x2 scan x
    2x2 lasers."""
    d = nlos_confocal_dict()
    d["integrator"]["capture_type"] = "exhaustive"
    sensor = d["relay_wall"]["nlos_sensor"]
    sensor["film"].update(width=2, height=2, exhaustive_scan=True,
                          laser_scan_width=2, laser_scan_height=2)
    del sensor["original_film_width"], sensor["original_film_height"]
    return d


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """An ``n_devices``-shard mesh (``make_mesh(n_devices, devices)``: by
    default the process's CUDA devices) driving one sharded step of each
    workload on tiny shapes: the small cbox (8x8, 16 bins, depth 3) primal
    render and PRB backward, the confocal NLOS capture's primal render and
    full-AD backward, and the 2x2 x 2x2 exhaustive capture.  Asserts their
    shapes and non-zero energy, prints one ``dryrun_multichip OK: ...``
    line and returns its numbers with the images and gradient tables
    (host numpy arrays)."""
    import mitransient_tpu_torch as mt

    mesh = make_mesh(n_devices, devices=devices)
    if mesh.size < n_devices:
        raise RuntimeError(f"need {n_devices} shards, the mesh has "
                           f"{mesh.size}")
    dev = mesh.devices[0]
    scene = _small_cbox(mt, dev, w=8, h=8, bins=16, max_depth=3)
    # forward: the sharded primal render, film partials all-reduced
    steady, transient, stats = render_sharded(
        scene, mesh, spp=2 * n_devices, seed=0, return_stats=True)
    assert steady.shape == (8, 8, 3)
    assert transient.shape == (8, 8, 16, 3)
    assert float(steady.sum()) > 0.0
    # a training step: the sharded PRB replay, gradients all-reduced
    ones_t = np.ones((8, 8, 16, 3), np.float32)
    g = render_backward_sharded(scene, mesh, (None, ones_t),
                                spp=2 * n_devices, seed=0)["__tables__"]
    assert float(g.bsdf_reflectance.abs().sum()) > 0.0
    assert float(g.emitter_radiance.abs().sum()) > 0.0

    # the confocal NLOS capture, primal and full-AD backward
    nscene = mt.load_dict(nlos_confocal_dict(), device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], nscene)
    _ns, nt = render_sharded(nscene, mesh, spp=2 * n_devices, seed=0)
    assert float(nt.sum()) > 0.0
    ng = render_backward_sharded(
        nscene, mesh, (None, np.ones(tuple(nt.shape), np.float32)),
        spp=n_devices, seed=0)["__tables__"]
    assert float(ng.bsdf_reflectance.abs().sum()) > 0.0

    # the exhaustive capture: the laser axis over the mesh, a 6-D film
    escene = mt.load_dict(exhaustive_dict(), device=dev)
    _es, et = render_sharded(escene, mesh, spp=2, seed=0)
    assert tuple(et.shape) == (2, 2, 2, 2, 32, 3)
    assert float(et.sum()) > 0.0
    out = {
        "devices": n_devices,
        "rays": stats["rays"],
        "steady_sum": float(steady.sum()),
        "grad_norm": float(g.bsdf_reflectance.abs().sum()),
        "nlos_transient_sum": float(nt.sum()),
    }
    print(f"dryrun_multichip OK: {n_devices} devices, {out['rays']} rays, "
          f"steady sum {out['steady_sum']:.4f}, grad-norm "
          f"{out['grad_norm']:.4f}, nlos transient sum "
          f"{out['nlos_transient_sum']:.4f}")
    cpu = {
        "steady": steady, "transient": transient, "nlos_transient": nt,
        "exhaustive_transient": et,
        **{f"grad_{f}": getattr(g, f) for f in ("bsdf_reflectance",
                                                "emitter_radiance")},
        "nlos_grad_bsdf_reflectance": ng.bsdf_reflectance,
    }
    out.update({k: v.detach().cpu().numpy() for k, v in cpu.items()})
    return out
