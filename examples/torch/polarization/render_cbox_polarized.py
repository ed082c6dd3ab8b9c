"""Time-resolved polarization with the PyTorch port: the Cornell box with a
gold GGX box under the ``mono_polarized`` variant, with Stokes maps (the
port of examples/polarization/render_cbox_polarized.py).  The render holds
4 Stokes channels (I, Q, U, V), from which the DoP, AoLP, type of
polarization and chirality false-color maps are made.

    python examples/torch/polarization/render_cbox_polarized.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("cbox_polarized", __doc__)
    res, bins, spp = (24, 64, 32) if args.quick else (256, 400, 4096)
    spp = args.spp or spp

    old = mt.variant().name
    mt.set_variant("mono_polarized")
    try:
        d = mt.cornell_box()
        d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins)
        d["integrator"]["max_depth"] = 5
        # gold GGX box (cbox_polarized.xml:52-56)
        d["small-box"]["bsdf"] = {"type": "roughconductor", "material": "Au",
                                  "distribution": "ggx", "alpha": 0.3}
        scene = mt.load_dict(d, device=args.device)

        steady, transient = mt.render(scene, spp=spp, seed=0)
        steady, transient = host(steady), host(transient)  # 4 Stokes
        print(f"steady {steady.shape}  transient {transient.shape}")

        save_image(os.path.join(args.out, "intensity.png"), steady[..., :1])
        for mode in ("dop", "aolp", "top", "chirality"):
            img = mt.vis_polarized.polarization_generate_false_color(
                steady, mode=mode)
            save_image(os.path.join(args.out, f"{mode}.png"), img, gamma=1.0)
        if not args.quick:
            frames = mt.vis_polarized.tonemap_transient(transient)
            mt.vis.save_video(frames, os.path.join(args.out, "stokes.mp4"))
        print("wrote", args.out)
    finally:
        mt.set_variant(old)


if __name__ == "__main__":
    main()
