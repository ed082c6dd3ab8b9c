"""First steps with the PyTorch port: create, render, edit and visualize a
transient Cornell box (the port of examples/transient/render_cbox_diffuse.py).

Build the canonical Cornell box, render a ``(steady, transient)`` pair on
the card, save the steady image and a few tonemapped transient frames,
then edit the scene through ``traverse`` and render again.

    python examples/torch/transient/render_cbox_diffuse.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("cbox_diffuse", __doc__)
    res, bins, spp = (32, 64, 16) if args.quick else (256, 300, 1024)
    spp = args.spp or spp

    d = mt.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins)
    scene = mt.load_dict(d, device=args.device)

    steady, transient = mt.render(scene, spp=spp, seed=0)
    steady, transient = host(steady), host(transient)
    print(f"steady {steady.shape}  transient {transient.shape}  "
          f"energy ratio {transient.sum() / steady.sum():.4f}")
    save_image(os.path.join(args.out, "steady.png"), steady)

    frames = mt.vis.tonemap_transient(transient)
    mt.vis.save_frames(frames[..., bins // 2:bins // 2 + 4, :], args.out,
                       prefix="frame")
    if not args.quick:
        mt.vis.save_video(frames, os.path.join(args.out, "transient.mp4"))

    # edit the scene and render again: repaint the green wall blue
    params = mt.traverse(scene)
    key = [k for k in params.keys() if "green" in k and "reflectance" in k][0]
    params[key] = [0.1, 0.1, 0.8]
    params.update()
    steady2, _ = mt.render(scene, spp=spp, seed=0)
    save_image(os.path.join(args.out, "steady_edited.png"), steady2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
