"""Entry ``grad_step``: steps of an inverse-rendering loop, the tutorial
``optimize_reflectance`` on the configuration's scene.  A step writes the
parameter, renders the transient (multi-pass), forms the L2 adjoint
against a target rendered in set-up, runs ``render_backward`` and takes an
Adam step, the parameter then clamped to [0, 1].

Set-up builds the one optimisation object (scene, parameter, Adam state),
renders the target and drives the first ``check.steps`` steps through the
window's own call; the window goes on stepping the same object.  The
plain reference follows those first steps from the same inputs (the
configuration, the traffic's initial value and seeds): it renders its own
target, its own films, PRB gradients and Adam steps.  Compared: the first
step's loss and its transient film at pixels drawn from the seed, the
first gradient as Adam holds it after one step, and the parameter's
change over the followed steps (:func:`compare`).
"""
from __future__ import annotations

import copy
import time

import torch

from harness import traffic as traffic_mod
from reference import tracer
from reference.scene import RefScene

from .render import _rel_l1, _sync, scene_desc


class State:
    pass


def _adam_step(theta, grad, m, v, k, lr, betas=(0.9, 0.999), eps=1e-8):
    """One step of Adam (``torch.optim.Adam``'s update, no weight decay);
    ``k`` counts from 1.  -> (theta, m, v)."""
    b1, b2 = betas
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad * grad
    denom = (v / (1 - b2 ** k)).sqrt() + eps
    return theta - (lr / (1 - b1 ** k)) * m / denom, m, v


def setup(ctx) -> State:
    st = State()
    st.mt, st.device, st.ctx = ctx.mt, ctx.device, ctx
    tr = ctx.traffic.spec
    st.desc = scene_desc(ctx.cell, ctx.shrink)
    st.scene = ctx.mt.load_dict(copy.deepcopy(st.desc), device=ctx.device)
    st.path = tr["parameter"]
    st.params = ctx.mt.traverse(st.scene)
    st.theta0 = torch.tensor(tr["initial"], dtype=torch.float32)
    st.theta = st.theta0.to(ctx.device).clone().requires_grad_(True)
    st.opt = torch.optim.Adam([st.theta], lr=tr["lr"])
    st.target_seed = traffic_mod.call_seed(ctx.seed, -2)
    _s, st.target = ctx.mt.render(st.scene, spp=tr["target_spp"],
                                  seed=st.target_seed)
    film = st.desc["sensor"]["film"]
    st.W, st.H, st.T = film["width"], film["height"], film["temporal_bins"]
    check = ctx.cell.cell["check"]
    hw = st.W * st.H
    n_pix = min(int(check["pixels"]), hw)
    pix = traffic_mod.rng(ctx.seed, 1).choice(hw, n_pix, replace=False)
    st.pixels = torch.as_tensor(sorted(pix.tolist()), device=ctx.device)
    st.n_follow = int(check["steps"])
    st.losses, st.seeds, st.walls = [], [], []
    st.steps = 0
    st.first_film = st.first_grad = st.theta_followed = None
    for i in range(st.n_follow):  # the first steps: warm-up and checked
        call(st, -3 - i)
    st.theta_followed = st.theta.detach().cpu().clone()
    st.walls, st.steps = [], 0
    return st


def call(st, index: int) -> None:
    spp = st.ctx.traffic.spec["spp"]
    seed = st.ctx.traffic.call(index)["seed"]
    t0 = time.perf_counter()
    st.params[st.path] = st.theta.detach()
    st.params.update()
    _s, img = st.mt.render(st.scene, spp=spp, seed=seed, regenerate=False)
    diff = img - st.target
    grad_in = (2.0 / diff.numel()) * diff
    grads = st.mt.render_backward(st.scene, (None, grad_in), spp=spp,
                                  seed=seed)
    st.theta.grad = grads[st.path].to(st.theta.dtype)
    st.opt.step()
    with torch.no_grad():
        st.theta.clamp_(0.0, 1.0)
    if index < 0:  # a followed step of set-up
        if st.first_grad is None:  # as Adam holds it after one step
            beta1 = st.opt.param_groups[0]["betas"][0]
            held = st.opt.state[st.theta].get("exp_avg")  # none: no step
            st.first_grad = (torch.zeros_like(st.theta) if held is None
                             else held / (1 - beta1)).detach().cpu()
        st.seeds.append(seed)
        st.losses.append(float((diff * diff).mean()))
        if st.first_film is None:
            hw = st.W * st.H
            st.first_film = img.reshape(hw, st.T, -1).index_select(
                0, st.pixels).cpu()
    del _s, img, diff, grad_in, grads
    _sync(st.device)
    st.walls.append(time.perf_counter() - t0)
    st.steps += 1


def work(st) -> dict:
    return dict(calls=st.steps, samples=0, steps=st.steps, rays=0,
                sectors_per_call=0, walls=st.walls)


def release(st) -> None:
    st.pixels = st.pixels.cpu()
    del st.scene, st.params, st.target, st.opt


def program_outputs(st):
    return dict(losses=st.losses, grad=st.first_grad,
                change=st.theta_followed - st.theta0, film=st.first_film)


def reference_outputs(st, dtype, device, backward_spp=None):
    """The reference's own optimisation of the followed steps
    (``backward_spp``: a fault planted in it, the gradients of that many
    samples a pixel, the mean over them)."""
    tr = st.ctx.traffic.spec
    ref = RefScene(st.desc)
    names = sorted(set(ref.bsdf_name.tolist()))
    rows = torch.as_tensor([names.index(b) for b in ref.bsdf_name],
                           device=device)
    bsdf = st.path.split(".")[0]
    mask = torch.as_tensor(ref.bsdf_name == bsdf, device=device)
    S = ref.to(device, dtype)
    dims = dict(width=ref.width, height=ref.height, bins=ref.bins,
                start_opl=ref.start_opl, bin_width=ref.bin_width,
                max_depth=ref.max_depth, rr_depth=ref.rr_depth)
    hw = ref.width * ref.height
    every = torch.arange(hw, device=device)
    _st, target = tracer.render_regen(S, dims, st.target_seed,
                                      tr["target_spp"], every)
    theta = st.theta0.to(device, torch.float64)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    losses, first_grad, first_film = [], None, None
    for k, seed in enumerate(st.seeds, start=1):
        S["refl"] = torch.where(mask[:, None], theta.to(dtype),
                                S["refl"])
        _s, img = tracer.render_multipass(S, dims, seed, tr["spp"], every)
        diff = img - target
        losses.append(float((diff.double() ** 2).mean()))
        if first_film is None:
            first_film = img.index_select(0, st.pixels.to(device)).cpu()
        adj = (2.0 / diff.numel()) * diff
        g, mass = tracer.prb_gradient(S, dims, seed,
                                      backward_spp or tr["spp"], adj, rows)
        g = g[names.index(bsdf)]
        if first_grad is None:
            first_grad, first_mass = g.cpu(), mass[names.index(bsdf)].cpu()
        theta, m, v = _adam_step(theta, g, m, v, k, tr["lr"])
        theta = theta.clamp(0.0, 1.0)
    return dict(losses=losses, grad=first_grad, mass=first_mass,
                change=theta.cpu() - st.theta0.double(), film=first_film)


def _norm_gap(a, b, scale) -> float:
    na = float(torch.as_tensor(a).double().norm())
    nb = float(torch.as_tensor(b).double().norm())
    return abs(na - nb) / max(float(torch.as_tensor(scale).double().norm()),
                              1e-300)


def compare(outputs, reference) -> dict:
    """The first step's loss and film, the first gradient against the
    gradient's mass (its terms' absolute sum: the gradient of this loss
    is a sum of terms of both signs that nearly cancel, and rounding moves
    it in proportion to the mass, not to its norm), and the parameter's
    change over the followed steps."""
    a, b = outputs["losses"][0], reference["losses"][0]
    return {"loss_gap": abs(a - b) / max(abs(b), 1e-300),
            "grad_norm_gap": _norm_gap(outputs["grad"], reference["grad"],
                                       reference["mass"]),
            "change_norm_gap": _norm_gap(outputs["change"],
                                         reference["change"],
                                         reference["change"]),
            "film_rel_l1": _rel_l1(outputs["film"], reference["film"])}
