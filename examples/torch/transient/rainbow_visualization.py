"""Rainbow visualization with the PyTorch port: the transient collapsed to
one image whose hue is each pixel's (modulo-wrapped) time of arrival (the
port of examples/transient/rainbow_visualization.py).

    python examples/torch/transient/rainbow_visualization.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("rainbow", __doc__)
    res, bins, spp = (32, 64, 16) if args.quick else (256, 300, 512)
    spp = args.spp or spp

    d = mt.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins)
    scene = mt.load_dict(d, device=args.device)

    _steady, transient = mt.render(scene, spp=spp, seed=0)
    transient = host(transient)
    save_image(os.path.join(args.out, "rainbow.png"),
               mt.vis.rainbow_visualization(transient), gamma=1.0)
    # repeat the hue cycle every bins // 4 bins: successive wavefronts
    save_image(os.path.join(args.out, "rainbow_modulo.png"),
               mt.vis.rainbow_visualization(transient, modulo=bins // 4),
               gamma=1.0)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
