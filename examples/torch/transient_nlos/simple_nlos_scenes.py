"""Simple NLOS scenes with the PyTorch port: single, confocal and
exhaustive captures of a hidden Z behind a relay wall (the port of
examples/transient_nlos/simple_nlos_scenes.py).

The setup is built from Python: a relay wall with an
``nlos_capture_meter``, a laser ``projector`` aimed with the
``mitransient_tpu_torch.nlos`` helpers, and a hidden Z of three bars, for
the three capture modes of the ``transient_nlos_path`` integrator.

    python examples/torch/transient_nlos/simple_nlos_scenes.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def z_bar(key, translate, scale, angle=0.0):
    """One bar of the hidden Z: a rectangle facing the relay wall (-z)."""
    return {
        "type": "rectangle",
        # chained ops (Mitsuba <transform> semantics): translate o
        # rotate(z) o flip toward the wall o scale
        "to_world": [
            {"translate": translate},
            {"rotate": {"axis": [0, 0, 1], "angle": angle}},
            {"rotate": {"axis": [0, 1, 0], "angle": 180}},
            {"scale": scale},
        ],
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
    }


def nlos_scene(sx, sy, bins, capture="single"):
    """The reference's NLOS setup: relay wall rectangle with an
    nlos_capture_meter, a laser projector, the hidden Z."""
    d = {
        "type": "scene",
        "integrator": {
            "type": "transient_nlos_path",
            "max_depth": 4,
            "nlos_laser_sampling": True,
            "nlos_hidden_geometry_sampling": True,
            "nlos_hidden_geometry_sampling_do_rroulette": False,
            "temporal_filter": "box",
        },
        # the hidden Z at z = 1 (three bars)
        "z-top": z_bar("t", [0.0, 0.35, 1.0], [0.35, 0.1, 1.0]),
        "z-mid": z_bar("m", [0.0, 0.0, 1.0], [0.38, 0.09, 1.0], angle=45.0),
        "z-bot": z_bar("b", [0.0, -0.35, 1.0], [0.35, 0.1, 1.0]),
        "laser": {
            "type": "projector",
            "to_world": {"translate": [-0.5, 0.0, 0.25]},
            "irradiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]},
            "fov": 0.2,
        },
        "relay_wall": {
            "type": "rectangle",
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb",
                                     "value": [1.0, 1.0, 1.0]}},
            "nlos_sensor": {
                "type": "nlos_capture_meter",
                "sampler": {"type": "independent", "sample_count": 64},
                "sensor_origin": [-0.5, 0.0, 0.25],
                "film": {
                    "type": "transient_hdr_film",
                    "width": sx, "height": sy,
                    "temporal_bins": bins,
                    "bin_width_opl": 0.02,
                    "start_opl": 0.0,
                },
            },
        },
    }
    sensor = d["relay_wall"]["nlos_sensor"]
    if capture == "confocal":
        sensor.update(original_film_width=sx, original_film_height=sy)
        sensor["film"].update(width=1, height=1)
    elif capture == "exhaustive":
        d["integrator"]["capture_type"] = "exhaustive"
        sensor["film"].update(exhaustive_scan=True, laser_scan_width=sx,
                              laser_scan_height=sy)
    return d


def main():
    args = example_args("simple_nlos", __doc__)
    # the bins cover the 3-bounce arrivals (OPL ~3.1-3.5 here)
    sx, bins, spp = (8, 200, 64) if args.quick else (32, 300, 25_000)
    spp = args.spp or spp

    # single illumination: one laser point, an sx x sx scan
    scene = mt.load_dict(nlos_scene(sx, sx, bins), device=args.device)
    mt.nlos.focus_emitter_at_relay_wall_pixel([sx / 2, sx / 2], scene)
    _s, tr = mt.render(scene, spp=spp, seed=0)
    tr = host(tr)  # (sy, sx, T, C)
    print(f"single: transient {tr.shape}, energy {tr.sum():.4f}")
    save_image(os.path.join(args.out, "single_integrated.png"),
               tr.sum(axis=2))

    # confocal: the laser follows the scan point (a 1x1 film)
    scene_c = mt.load_dict(nlos_scene(sx, sx, bins, capture="confocal"),
                           device=args.device)
    mt.nlos.focus_emitter_at_relay_wall_pixel([sx / 2, sx / 2], scene_c)
    _s, tr_c = mt.render(scene_c, spp=spp, seed=0)
    print(f"confocal: transient {tuple(tr_c.shape)}, energy "
          f"{float(tr_c.sum()):.4f}")

    # exhaustive: every (laser, sensor) pair, a 6-D film
    ex = 2 if args.quick else 4
    scene_e = mt.load_dict(nlos_scene(ex, ex, bins, capture="exhaustive"),
                           device=args.device)
    mt.nlos.focus_emitter_at_relay_wall_pixel([ex / 2, ex / 2], scene_e)
    _s, tr_e = mt.render(scene_e, spp=min(spp, 5000), seed=0)
    print(f"exhaustive: transient {tuple(tr_e.shape)} (sy, sx, ly, lx, T, "
          f"C), energy {float(tr_e.sum()):.4f}")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
