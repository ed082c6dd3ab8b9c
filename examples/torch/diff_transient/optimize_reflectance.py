"""Differentiable transient rendering with the PyTorch port: recover a wall
albedo by gradient descent on the transient video (the port of
examples/diff_transient/optimize_reflectance.py).

Render a target transient with the true Cornell box colors, perturb the
white wall's reflectance, then recover it with Adam (``torch.optim``) on
the L2 transient loss, its gradient from ``render_backward`` (the PRB
two-sweep replay).

    python examples/torch/diff_transient/optimize_reflectance.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import torch  # noqa: E402

from common import example_args  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    args = example_args("optimize_reflectance", __doc__)
    res, bins, spp, iters, lr = ((16, 48, 32, 16, 0.1) if args.quick
                                 else (64, 200, 256, 60, 5e-2))
    spp = args.spp or spp

    d = mt.cornell_box()
    # a full-coverage time window: the loss must see the multi-bounce tail
    # (which carries the reflectance signal), not just direct light
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins,
                               start_opl=0.0, bin_width_opl=8.0 / bins)
    d["integrator"]["max_depth"] = 4
    scene = mt.load_dict(d, device=args.device)
    path = "white.reflectance.value"
    params = mt.traverse(scene)
    true_val = params[path].clone()

    # the target at the true parameters.  Quick mode keeps one seed: the
    # loss is then a deterministic function of theta and Adam converges
    # despite the tiny spp; the full configuration draws a seed an
    # iteration (stochastic gradient descent proper).
    target_seed = 0 if args.quick else 7
    _s, target = mt.render(scene, spp=spp, seed=target_seed)

    theta = torch.tensor([0.15, 0.6, 0.25], device=scene.device,
                         requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr)
    for it in range(iters):
        seed = 0 if args.quick else it
        params[path] = theta.detach()
        params.update()
        _s, img = mt.render(scene, spp=spp, seed=seed, regenerate=False)
        # d(L2)/d(transient) = 2 (img - target), the adjoint
        grad_in = (2.0 / target.numel()) * (img - target)
        grads = mt.render_backward(scene, (None, grad_in), spp=spp,
                                   seed=seed)
        theta.grad = grads[path].to(theta.dtype)
        opt.step()
        with torch.no_grad():
            theta.clamp_(0.0, 1.0)
        loss = float(((img - target) ** 2).mean())
        err = float((theta.detach() - true_val).abs().max())
        print(f"iter {it:3d}  loss {loss:.3e}  max|theta-true| {err:.4f}")

    tol = 0.25 if args.quick else 0.1  # quick mode runs few, large steps
    assert err < tol, f"optimization did not converge: {theta} vs {true_val}"
    print("recovered", theta.tolist(), "true", true_val.tolist())
    with open(os.path.join(args.out, "result.txt"), "w") as f:
        f.write(f"recovered {theta.tolist()} true {true_val.tolist()}\n")


if __name__ == "__main__":
    main()
