"""Polarized NLOS with the PyTorch port: a time-resolved Stokes capture of
a hidden Z behind a gold relay wall (the port of
examples/polarization/transient_nlos_polarization.py; the reference's
config: a 64x64 scan at spp 65,536).  Specular wall bounces imprint the
linear polarization the diffuse wall lacks.

    python examples/torch/polarization/transient_nlos_polarization.py [--quick] [--device cpu]
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, ".."),
                os.path.join(HERE, "..", "transient_nlos")]
from common import example_args, host, save_image  # noqa: E402
from simple_nlos_scenes import nlos_scene  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("nlos_polarization", __doc__)
    sx, bins, spp = (8, 200, 64) if args.quick else (64, 300, 65_536)
    spp = args.spp or spp

    old = mt.variant().name
    mt.set_variant("mono_polarized")
    try:
        d = nlos_scene(sx, sx, bins)
        # a gold GGX relay wall (the notebook's scene cell)
        d["relay_wall"]["bsdf"] = {"type": "roughconductor",
                                   "material": "Au", "distribution": "ggx",
                                   "alpha": 0.3}
        scene = mt.load_dict(d, device=args.device)
        mt.nlos.focus_emitter_at_relay_wall_pixel([sx / 2, sx / 2], scene)

        _s, transient = mt.render(scene, spp=spp, seed=0)
        tr = host(transient)  # (sy, sx, T, 4) Stokes
        print(f"transient {tr.shape}, energy {tr[..., 0].sum():.4f}")
        integ = tr.sum(axis=2)  # time-integrated Stokes
        save_image(os.path.join(args.out, "intensity.png"), integ[..., :1])
        aolp = mt.vis_polarized.polarization_generate_false_color(
            integ, mode="aolp")
        save_image(os.path.join(args.out, "aolp.png"), aolp, gamma=1.0)
        print("wrote", args.out)
    finally:
        mt.set_variant(old)


if __name__ == "__main__":
    main()
