"""Forward-mode gradients in the time domain with the PyTorch port (the
port of examples/diff_transient/forward_time_gradients.py):
``render_forward`` carries a parameter tangent through the estimator and
gives d(transient)/d(theta) as a whole (H, W, T, C) video, shown with the
gradient tonemap (red positive, blue negative).

    python examples/torch/diff_transient/forward_time_gradients.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("forward_time_gradients", __doc__)
    res, bins, spp = (16, 48, 32) if args.quick else (128, 300, 512)
    spp = args.spp or spp

    d = mt.cornell_box()
    # a full-coverage window, so that the video holds the indirect tail
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins,
                               start_opl=0.0, bin_width_opl=8.0 / bins)
    d["integrator"]["max_depth"] = 4
    scene = mt.load_dict(d, device=args.device)

    # the tangent: brighten the green wall uniformly
    ds, dt = mt.render_forward(scene,
                               {"green.reflectance.value": [1.0, 1.0, 1.0]},
                               spp=spp, seed=0)
    ds, dt = host(ds), host(dt)
    print(f"d(steady) {ds.shape}  d(transient) {dt.shape}  "
          f"total {dt.sum():.4f}")
    save_image(os.path.join(args.out, "dsteady.png"),
               mt.vis.tonemap_grad_transient(ds[:, :, None])[:, :, 0],
               gamma=1.0)
    frames = mt.vis.tonemap_grad_transient(dt)
    mt.vis.save_frames(frames[..., bins // 2:bins // 2 + 3, :], args.out,
                       prefix="dgrad")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
