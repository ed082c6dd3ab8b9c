"""Entry ``grad_texels``: steps of a texel-recovery loop, mitransient's
diff-transient example (darken a texture's texels, get them back by Adam
on the L2 loss of the transient video) on the configuration's scene.  A
step is ``grad_step``'s: it writes the texels (the traffic's
``parameter``, a ``.data`` traverse path), renders the transient
(multi-pass), forms the L2 adjoint against a target rendered in set-up
from the configuration's own texels, runs ``render_backward`` (the PRB
replay) and takes an Adam step, the texels then clamped to [0, 1].

Set-up darkens the configuration's texels by the traffic's
``initial_scale`` and drives the first ``check.steps`` steps through the
window's own call, as ``grad_step`` does.  The plain reference
(``reference/textured.py``) follows those steps from the same inputs.
Compared: ``grad_step``'s four numbers and the first texel gradient texel
by texel (:func:`compare`).
"""
from __future__ import annotations

import copy

import torch

from harness import traffic as traffic_mod
from reference import textured

from .grad_step import (  # noqa: F401  (the entry's own functions)
    State,
    _adam_step,
    call,
    program_outputs,
    release,
    work,
)
from .grad_step import compare as _grad_step_compare
from .render import scene_desc


def setup(ctx) -> State:
    st = State()
    st.mt, st.device, st.ctx = ctx.mt, ctx.device, ctx
    tr = ctx.traffic.spec
    st.desc = scene_desc(ctx.cell, ctx.shrink)
    st.scene = ctx.mt.load_dict(copy.deepcopy(st.desc), device=ctx.device)
    st.path = tr["parameter"]
    st.params = ctx.mt.traverse(st.scene)
    st.target_seed = traffic_mod.call_seed(ctx.seed, -2)
    _s, st.target = ctx.mt.render(st.scene, spp=tr["target_spp"],
                                  seed=st.target_seed)
    texels = st.params[st.path].detach()
    st.theta0 = (tr["initial_scale"] * texels).cpu()
    st.theta = (tr["initial_scale"] * texels).clone().requires_grad_(True)
    st.opt = torch.optim.Adam([st.theta], lr=tr["lr"])
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


def reference_outputs(st, dtype, device, backward_spp=None):
    """The reference's own optimisation of the followed steps from the
    configuration's texels (``backward_spp``: a fault planted in it, the
    gradients of that many samples a pixel, the mean over them)."""
    tr = st.ctx.traffic.spec
    scene = textured.TexturedScene(st.desc)
    ref = scene.ref
    S = scene.to(device, dtype)
    dims = dict(width=ref.width, height=ref.height, bins=ref.bins,
                start_opl=ref.start_opl, bin_width=ref.bin_width,
                max_depth=ref.max_depth, rr_depth=ref.rr_depth)
    every = torch.arange(ref.width * ref.height, device=device)
    _st, target = textured.render_regen(S, dims, st.target_seed,
                                        tr["target_spp"], every)
    theta = tr["initial_scale"] * torch.as_tensor(
        scene.texels, dtype=torch.float64, device=device)
    theta0 = theta.clone()
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    losses, first_grad, first_film = [], None, None
    for k, seed in enumerate(st.seeds, start=1):
        S["texels"] = theta.to(dtype)
        _s, img = textured.render_multipass(S, dims, seed, tr["spp"], every)
        diff = img - target
        losses.append(float((diff.double() ** 2).mean()))
        if first_film is None:
            first_film = img.index_select(0, st.pixels.to(device)).cpu()
        adj = (2.0 / diff.numel()) * diff
        g, mass = textured.prb_texel_gradient(
            S, dims, seed, backward_spp or tr["spp"], adj)
        if first_grad is None:
            first_grad, first_mass = g.cpu(), mass.cpu()
        theta, m, v = _adam_step(theta, g, m, v, k, tr["lr"])
        theta = theta.clamp(0.0, 1.0)
    return dict(losses=losses, grad=first_grad, mass=first_mass,
                change=(theta - theta0).cpu(), film=first_film)


def compare(outputs, reference) -> dict:
    """``grad_step``'s numbers, and ``texel_grad_gap``: the first
    gradient's gap texel by texel, sum over texels and channels of
    |program - reference| over the reference gradient's mass.  A norm
    cannot see a gradient moved onto the wrong texels; this can."""
    out = _grad_step_compare(outputs, reference)
    gap = (outputs["grad"].double() - reference["grad"]).abs().sum()
    out["texel_grad_gap"] = float(gap) / max(
        float(reference["mass"].sum()), 1e-300)
    return out
