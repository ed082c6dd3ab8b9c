"""The port's full-AD differentiation (``integrators/fullad.py``: NLOS
captures and ``method="fullad"``) and its forward mode through the whole
NLOS primal against the JAX package on the CPU, and the gradients' safety.

Full AD records the whole primal render, film splat included (K3's
autograd Function), so its gradients reach every table the render reads,
the shape poses among them.  Both packages trace the same threefry
streams.  Tolerances:

* gradient tables against the JAX package: within 1e-4 of the table's
  largest |value| (float32 sums in another order, XLA:CPU's FMA);
* the shape-pose tables of the box: one lane of the spp-8 render takes
  another path in the two packages (XLA:CPU rounds its hit test with FMA,
  ROADMAP queue 3), which moves the light's and the large box's
  translation and rotation gradients by up to 1e-2 of the table's largest
  |value| (7 elements of the two tables); every other element within 1e-4
  (``BOX_POSE_TIES``);
* derivative videos: test_golden's rule, no element out;
* finite gradients for every BSDF family (test_grad_safety.py's scenes).
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.core import math as tmath
from torch_cases import (
    SAFETY_BSDFS,
    diff_case,
    golden_mismatch,
    grad_cbox,
    nlos_confocal,
    nlos_scene,
    safety_scene,
)

torch.set_num_threads(1)

# elements of the box's shape-pose tables (x 2 tables) out of 1e-4 and
# their bound, as a share of the table's largest |value|
BOX_POSE_TIES = (7, 1e-2)


def _close_tables(got, want, what, atol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                               err_msg=what)


def _compare_all(gp, gj, skip=()):
    tj, tp = gj["__tables__"], gp["__tables__"]
    for f in tp._fields:
        if f in skip:
            continue
        g = getattr(tp, f)
        assert (g is None) == (getattr(tj, f) is None), f
        if g is not None:
            _close_tables(g.numpy(), getattr(tj, f), f)
    assert set(gp) == set(gj)
    for k in gp:
        if k != "__tables__" and not any(s.split("_")[-1] in k
                                         for s in skip):
            _close_tables(gp[k].numpy(), gj[k], k)


def _nlos(desc):
    scenes = (mitr.load_dict(copy.deepcopy(desc)),
              mt.load_dict(copy.deepcopy(desc), device="cpu"))
    for pkg, sc in zip((mitr, mt), scenes):
        pkg.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], sc)
    return scenes


def _nlos_desc(name):
    if name == "single":
        d = nlos_scene(sx=2, sy=2)
    else:
        d = nlos_confocal(nlos_scene(sx=1, sy=1), 4, 3)
    d["integrator"]["rr_depth"] = 99
    return d


@pytest.mark.parametrize("name", ["single", "confocal"])
def test_nlos_backward_matches_jax(name):
    jsc, tsc = _nlos(_nlos_desc(name))
    fc = tsc.sensors[0].film
    ones = np.ones((fc.height, fc.width, fc.temporal_bins, 3), np.float32)
    gj = mitr.render_backward(jsc, (None, ones), spp=16, seed=0)
    gp = mt.render_backward(tsc, (None, ones), spp=16, seed=0)
    _compare_all(gp, gj)
    g = gp["hidden-target.bsdf.reflectance.value"].numpy()
    assert np.all(g > 0.0)


def test_nlos_forward_matches_jax():
    """Forward mode through the whole NLOS primal (dual tables; the kernels
    get plain inputs, the film takes K3's jvp)."""
    jsc, tsc = _nlos(_nlos_desc("single"))
    tangent = {"hidden-target.bsdf.reflectance.value":
               np.array([1.0, 0.5, 0.25], np.float32)}
    want = mitr.render_forward(jsc, tangent, spp=16, seed=0)
    got = mt.render_forward(tsc, tangent, spp=16, seed=0)
    for g, w in zip(got, want):
        m = golden_mismatch(g.numpy(), np.asarray(w))
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert float(got[1].sum()) > 0.0


def test_nlos_backward_vs_finite_difference():
    """The full-AD gradient against a central difference of the same
    seeded render (test_fullad.py:11-44), in the port alone."""
    _jsc, tsc = _nlos(_nlos_desc("single"))
    fc = tsc.sensors[0].film
    ones = np.ones((fc.height, fc.width, fc.temporal_bins, 3), np.float32)
    key = "hidden-target.bsdf.reflectance.value"
    g = mt.render_backward(tsc, (None, ones), spp=16, seed=0)[key]
    params = mt.traverse(tsc)
    base = params[key].clone()
    v = torch.tensor([1.0, 0.5, 0.25])
    losses = []
    for sign in (1.0, -1.0):
        params[key] = base + sign * 1e-3 * v
        params.update()
        _s, t = mt.render(tsc, spp=16, seed=0)
        losses.append(float(t.double().sum()))
    fd = (losses[0] - losses[1]) / 2e-3
    an = float(g @ v)
    assert fd != 0.0 and abs(an - fd) / abs(fd) < 0.02, (an, fd)


def test_box_fullad_matches_jax():
    """``method="fullad"`` on the test_grad box: every table, the shape
    poses within BOX_POSE_TIES."""
    desc = grad_cbox(mitr)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    ones = np.ones((16, 16, 300, 3), np.float32)
    gj = mitr.render_backward(jsc, (None, ones), spp=8, seed=0,
                              method="fullad")
    gp = mt.render_backward(tsc, (None, ones), spp=8, seed=0,
                            method="fullad")
    pose = ("shape_translate", "shape_rotate")
    _compare_all(gp, gj, skip=pose)
    n_out, bound = BOX_POSE_TIES
    out = 0
    for f in pose:
        g = getattr(gp["__tables__"], f).numpy()
        w = np.asarray(getattr(gj["__tables__"], f))
        scale = float(np.abs(w).max())
        _close_tables(g, w, f, atol=bound)
        out += int((np.abs(g - w) > 1e-4 * scale).sum())
    assert out <= n_out


@pytest.mark.parametrize("name", ["ggx", "texels"])
def test_fullad_alpha_and_texels_match_jax(name):
    desc = diff_case(mitr, name)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    fc = tsc.sensors[0].film
    ones = np.ones((fc.height, fc.width, fc.temporal_bins, 3), np.float32)
    gj = mitr.render_backward(jsc, (None, ones), spp=16, seed=0,
                              method="fullad")
    gp = mt.render_backward(tsc, (None, ones), spp=16, seed=0,
                            method="fullad")
    _compare_all(gp, gj)
    key = ("small-box.bsdf.alpha.value" if name == "ggx"
           else "floor.bsdf.reflectance.data")
    assert np.any(gp[key].numpy() != 0.0)


# --------------------------------------------------------------------------
# gradient safety (test_grad_safety.py)
# --------------------------------------------------------------------------

def _assert_finite(grads, name):
    tab = grads["__tables__"]
    for f in tab._fields:
        v = getattr(tab, f)
        if v is not None:
            assert torch.isfinite(v).all(), (name, f)


@pytest.mark.parametrize("name", sorted(SAFETY_BSDFS))
def test_fullad_gradients_finite(name):
    """Masked lanes (misses, back faces, the dense lobe dispatch's other
    kinds) must not turn infinite derivatives into NaN."""
    sc = mt.load_dict(safety_scene(SAFETY_BSDFS[name]), device="cpu")
    gt = np.ones((8, 8, 40, 3), np.float32)
    _assert_finite(mt.render_backward(sc, (None, gt), spp=8, seed=0,
                                      method="fullad"), name)


def test_prb_gradients_finite_mixed_scene():
    d = mt.cornell_box()
    d["sensor"]["film"].update(width=8, height=8, temporal_bins=64)
    d["integrator"]["max_depth"] = 4
    d["small-box"]["bsdf"] = {"type": "roughconductor", "alpha": 0.05}
    sc = mt.load_dict(d, device="cpu")
    gt = np.ones((8, 8, 64, 3), np.float32)
    _assert_finite(mt.render_backward(sc, (None, gt), spp=8, seed=0),
                   "mixed")


def test_rounding_helpers_have_finite_exact_gradients():
    """core/math.py's sqrt, cos_sin and divide round through float64 or a
    0-dim tensor; their derivatives are the analytic ones, finite where
    the stable forms clamp (sqrt at 0 through stable_sqrt)."""
    x = torch.tensor([0.0, 1e-30, 0.25, 2.0, 9.0], requires_grad=True)
    s = tmath.stable_sqrt(x)
    c, sn = tmath.cos_sin(x)
    d = tmath.divide(x, 3.0)
    (g_s,) = torch.autograd.grad(s.sum(), x)
    (g_c,) = torch.autograd.grad(c.sum() + 2.0 * sn.sum(), x)
    (g_d,) = torch.autograd.grad(d.sum(), x)
    assert torch.isfinite(g_s).all() and g_s[0] == 0.0
    xd = x.detach().double()
    torch.testing.assert_close(g_s[2:].double(), 0.5 / xd[2:].sqrt(),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(g_c.double(), -xd.sin() + 2.0 * xd.cos(),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(g_d, torch.full_like(x, 1.0 / 3.0))
    y = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], requires_grad=True)
    (g_n,) = torch.autograd.grad(tmath.normalize(y).sum(), y)
    assert torch.isfinite(g_n).all()
