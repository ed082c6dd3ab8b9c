"""Transient volumetric rendering with the PyTorch port: the Cornell box
with scattering fog in its small box (the port of
examples/transient/render_cbox_volumetric.py), through the
``transient_prbvolpath`` integrator.

    python examples/torch/transient/render_cbox_volumetric.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("cbox_volumetric", __doc__)
    res, bins, spp, depth = ((24, 64, 16, 8) if args.quick
                             else (128, 400, 512, 64))
    spp = args.spp or spp

    d = mt.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins)
    d["integrator"] = {"type": "transient_prbvolpath", "max_depth": depth}
    # fog inside the small box, behind a null boundary
    d["small-box"]["bsdf"] = {"type": "null"}
    d["small-box"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": 1.8,
        "albedo": {"type": "rgb", "value": [0.9, 0.9, 0.9]},
        "phase": {"type": "hg", "g": 0.3},
    }
    scene = mt.load_dict(d, device=args.device)

    steady, transient = mt.render(scene, spp=spp, seed=0)
    steady, transient = host(steady), host(transient)
    print(f"steady {steady.shape}  transient {transient.shape}")
    save_image(os.path.join(args.out, "steady.png"), steady)
    if not args.quick:
        mt.vis.save_video(mt.vis.tonemap_transient(transient),
                          os.path.join(args.out, "transient.mp4"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
