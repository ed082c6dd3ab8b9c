"""The ``angulararea`` emitter with the PyTorch port: an area light with a
restricted cone of emission against a plain area light (the port of
examples/angulararea_emitter/render_angular_vs_area.py).  The same ceiling
panel is rendered as an ``area`` emitter and as an ``angulararea`` one
(cutoff angle 35°, beam width 20°, angular_1light.xml:59-64): the angular
light puts a spot on the floor, the area light washes the room.

    python examples/torch/angulararea_emitter/render_angular_vs_area.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402

GRAY = {"type": "diffuse",
        "reflectance": {"type": "rgb", "value": [0.85, 0.85, 0.85]}}


def room(emitter, res, bins):
    """A gray room with a downward-facing ceiling light panel."""
    return {
        "type": "scene",
        "integrator": {"type": "transient_path", "max_depth": 8,
                       "temporal_filter": "box"},
        "sensor": {
            "type": "perspective",
            "fov": 45.0,
            "to_world": {"look_at": {"origin": [0.0, 1.0, 3.5],
                                     "target": [0.0, 0.5, 0.0],
                                     "up": [0, 1, 0]}},
            "film": {"type": "transient_hdr_film", "width": res,
                     "height": res, "temporal_bins": bins,
                     "start_opl": 3.0, "bin_width_opl": 0.08},
        },
        "floor": {
            "type": "rectangle",
            "to_world": [{"rotate": {"axis": [1, 0, 0], "angle": -90}},
                         {"scale": 4.0}],
            "bsdf": GRAY,
        },
        "back": {
            "type": "rectangle",
            "to_world": [{"translate": [0.0, 2.0, -3.0]}, {"scale": 4.0}],
            "bsdf": GRAY,
        },
        "light": {
            "type": "rectangle",
            "to_world": [{"translate": [0.0, 2.5, 0.0]},
                         {"rotate": {"axis": [1, 0, 0], "angle": 90}},
                         {"scale": 0.4}],
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [0, 0, 0]}},
            "emitter": emitter,
        },
    }


def main():
    args = example_args("angular_vs_area", __doc__)
    res, bins, spp = (32, 48, 32) if args.quick else (200, 200, 256)
    spp = args.spp or spp

    rad = {"type": "rgb", "value": [18.387, 10.9873, 2.75357]}
    area = {"type": "area", "radiance": rad}
    angular = {"type": "angulararea", "radiance": rad,
               "cutoff_angle": 35.0, "beam_width": 20.0}
    s_area, _ = mt.render(mt.load_dict(room(area, res, bins),
                                       device=args.device), spp=spp, seed=0)
    s_ang, _ = mt.render(mt.load_dict(room(angular, res, bins),
                                      device=args.device), spp=spp, seed=0)
    s_area, s_ang = host(s_area), host(s_ang)

    save_image(os.path.join(args.out, "area.png"), s_area)
    save_image(os.path.join(args.out, "angular.png"), s_ang)
    # the angular light concentrates the energy: a brighter spot
    print(f"area total {s_area.sum():.3f}  angular total {s_ang.sum():.3f}  "
          f"angular/area peak ratio "
          f"{s_ang.max() / max(s_area.max(), 1e-9):.2f}")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
