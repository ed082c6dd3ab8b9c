"""The port's geometry gradients (shape poses and delta-emitter positions,
through full AD) against the JAX package on the CPU.

Gradients reach a shape's pose through the hit distance re-derived from
the moved triangle's plane (``scene.py:_si_from_t_prim``), the NEE
emitter points moved by their shape's delta and the delta emitters'
position table.  The scenes are test_geomgrad.py's flip-free ones (a
floor filling the view, a light no contributing ray hits, no Russian
roulette, a gaussian temporal filter, so that arrival bins move smoothly),
where no discrete decision parts the packages.  Tolerances: every gradient
table within 1e-4 of its largest |value| (float32 sums in another order,
XLA:CPU's FMA); a finite difference of the port's own seeded render within
test_geomgrad.py's 5e-3; the attach leaves every primal bit unchanged.
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.core.records import Ray
from mitransient_tpu_torch.scene import scene as tscene
from torch_cases import GEOMETRY_CASES, flat_adjoint, flat_scene, grad_cbox

torch.set_num_threads(1)

SPP = 64


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                               err_msg=what)


def test_flat_scene_is_the_jax_fixture():
    import test_geomgrad

    for light in ("point", "area"):
        assert flat_scene(light) == test_geomgrad.flat_scene(light)
    want = test_geomgrad._gt(mitr.load_dict(test_geomgrad.flat_scene()))
    np.testing.assert_array_equal(flat_adjoint("rand")[1], want)


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_gradients_match_jax(case):
    light, adjoint, paths = GEOMETRY_CASES[case]
    desc = flat_scene(light)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    grad_in = flat_adjoint(adjoint)
    gj = mitr.render_backward(jsc, grad_in, spp=SPP, seed=0, method="fullad")
    gp = mt.render_backward(tsc, grad_in, spp=SPP, seed=0, method="fullad")
    tj, tp = gj["__tables__"], gp["__tables__"]
    for f in ("shape_translate", "shape_rotate", "emitter_position",
              "bsdf_reflectance", "emitter_radiance"):
        _close(getattr(tp, f).numpy(), getattr(tj, f), f)
    for k in paths:
        g = gp[k].numpy()
        assert np.abs(g).max() > 1e-4, (k, g)
        _close(g, gj[k], k)


def test_floor_translate_vs_finite_difference():
    """d(steady)/d(floor z) against a central difference of the port's
    own render at the same seed, the pose moved through traverse."""
    tsc = mt.load_dict(flat_scene("point"), device="cpu")
    gs, _ = flat_adjoint("steady")
    key = "floor.to_world.translate"
    v = np.array([0.0, 0.0, 1.0], np.float32)
    an = float(mt.render_backward(tsc, (gs, None), spp=SPP, seed=0,
                                  method="fullad")[key].numpy() @ v)
    params = mt.traverse(tsc)
    base = params[key].numpy()
    losses = []
    for sign in (1.0, -1.0):
        params[key] = base + sign * 1e-3 * v
        params.update()
        s, _t = mt.render(tsc, spp=SPP, seed=0, regenerate=False)
        losses.append(float((s.double().numpy() * gs).sum()))
    fd = (losses[0] - losses[1]) / 2e-3
    assert abs(an) > 1e-4
    assert abs(fd - an) / max(abs(fd), abs(an)) < 5e-3, (fd, an)


def test_zero_delta_attach_keeps_every_primal_bit():
    """With the (zero) geometry deltas kept, the shading record and the NEE
    samples are the primal ones bit for bit: the attached hit distance
    takes only the plane's derivative (replace_grad)."""
    sc = mt.load_dict(grad_cbox(mt), device="cpu")
    rng = np.random.default_rng(3)
    n = 4000
    o = torch.from_numpy(rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    ray, act = Ray.make(o, d), torch.ones(n, dtype=torch.bool)
    with_geom = tscene.ray_intersect(sc.data, ray, act)
    plain = tscene.ray_intersect(tscene.primal_sd(sc.data), ray, act)
    for f in ("t", "p", "n", "uv", "wi", "prim"):
        assert torch.equal(getattr(with_geom, f), getattr(plain, f)), f
    u = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    a = tscene.sample_emitter_direction(sc.data, plain.p, u, True,
                                        plain.valid)
    b = tscene.sample_emitter_direction(tscene.primal_sd(sc.data), plain.p,
                                        u, True, plain.valid)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].p, b[0].p)
