"""Inverse rendering of the reference's staircase with the PyTorch port:
recover darkened bitmap texels from the transient video by gradient
descent (the port of examples/diff_transient/optimize_staircase_texture.py).

The scene (``staircase/scene.xml``: 262k triangles, bitmap-textured
rough plastic walls) belongs to the reference's example corpus, which this
repository does not hold (set ``MITR_REFERENCE_EXAMPLES`` to the
corpus); without it the script says so and stops.  The
wallpaper texture's texels (the ``<bsdf>.diffuse_reflectance.data``
traverse path) are darkened, then recovered by Adam on the L2 transient
loss through full-AD ``render_backward``.

    python examples/torch/diff_transient/optimize_staircase_texture.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import torch  # noqa: E402

from common import example_args, reference_file  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("optimize_staircase_texture", __doc__)
    scene_file = reference_file("diff-transient", "staircase", "scene.xml")
    if scene_file is None:
        print("the reference's staircase scene is not there; nothing to do")
        return
    if args.quick:
        res, bins, binw, spp, iters, md, lr = (10, 48, 0.25, 4, 2, 3, 0.25)
    else:
        res, bins, binw, spp, iters, md, lr = (64, 200, 0.1, 64, 40, 8, 0.1)
    spp = args.spp or spp

    scene = mt.load_file(scene_file, device=args.device, resx=res, resy=res,
                         spp=spp, max_depth=md)
    # the time window of the configured bins (the indirect tail carrying
    # the texture signal spans OPL ~3-15 at shallow depths)
    cfg = scene.sensors[0]
    scene.sensors[0] = cfg._replace(film=cfg.film._replace(
        temporal_bins=bins, start_opl=3.0, bin_width_opl=binw))

    params = mt.traverse(scene)
    tex_paths = [k for k in params.keys() if k.endswith(".data")]
    assert tex_paths, "no textured BSDFs found in the staircase scene"
    wall = [k for k in tex_paths if "Wallpaper" in k]
    path = wall[0] if wall else sorted(tex_paths)[0]
    true_tex = params[path].clone()

    _s, target = mt.render(scene, spp=spp, seed=0, regenerate=False)
    theta = (true_tex * 0.6).requires_grad_()  # darken the texels 40 %
    params[path] = theta.detach()
    params.update()
    opt = torch.optim.Adam([theta], lr=lr)
    loss0 = None
    for it in range(iters):
        _s, t = mt.render(scene, spp=spp, seed=0, regenerate=False)
        diff = t - target
        loss = float((diff ** 2).sum())
        loss0 = loss if loss0 is None else loss0
        # full AD reads each splat's adjoint at its own time bin, where the
        # PRB replay reads it at the vertex's
        grads = mt.render_backward(scene, (None, 2.0 * diff), spp=spp,
                                   seed=0, method="fullad")
        # a few degenerate mesh lanes (sliver triangles) can leave isolated
        # non-finite adjoints: drop them rather than the step
        theta.grad = torch.nan_to_num(grads[path], nan=0.0, posinf=0.0,
                                      neginf=0.0)
        opt.step()
        with torch.no_grad():
            theta.clamp_(0.0, 1.0)
        params[path] = theta.detach()
        params.update()
        err = float((theta.detach() - true_tex).abs().mean())
        print(f"iter {it:02d}  loss {loss:.6e}  mean|texel err| {err:.4f}",
              flush=True)
    assert loss0 > 0, "perturbed texels produced no transient difference"
    assert loss < loss0 * 0.7, (loss0, loss)
    print(f"staircase texel optimization: loss {loss0:.3e} -> {loss:.3e}")


if __name__ == "__main__":
    main()
