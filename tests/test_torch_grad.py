"""The port's PRB differentiation (``render_backward`` and
``render_forward`` of ``transient_path``) against the JAX package and the
``gradients`` golden on the CPU, and K3's autograd Function.

Both packages draw the same threefry streams, so the two sweeps replay the
same paths and the results agree per sample.  Tolerances:

* ``gradients.npz``: test_golden's rule (rtol 5e-4, atol 5e-5 * max), no
  element out;
* gradient tables against the JAX package: within 1e-4 of the table's
  largest |value| (float32 sums of 8,192 lanes and more, added in another
  order, and XLA:CPU's FMA contraction);
* derivative videos: test_golden's rule, no element out;
* the port's own identities (radiance linearity, forward against backward,
  a finite difference of the same seeded estimator): the JAX tests'
  tolerances (test_grad.py);
* K3's Function on the CPU: bit for bit against the plain version's own
  autograd and forward AD, and ``gradcheck`` in float64.
"""
import copy

import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.core.spectrum import Variant
from mitransient_tpu_torch.film import transient_film as tf
from torch_cases import (
    GRAD_SPP,
    GRADIENTS,
    OPTIMIZE_REFLECTANCE,
    diff_case,
    golden_mismatch,
    gradients_cbox,
    grad_cbox,
    nlos_exhaustive,
    nlos_scene,
    small_cbox,
    spy_routes,
    splat_events,
    time_window_cbox,
)

torch.set_num_threads(1)

ONES_T = np.ones((16, 16, 300, 3), np.float32)
# a transient adjoint that varies over the bins: the bin PRB reads at each
# vertex (read_adjoint's pixel * T + bin(distance)) decides the gradient,
# which a constant adjoint cannot show
RAND_T = np.random.default_rng(0).uniform(
    0.0, 1.0, ONES_T.shape).astype(np.float32)
V_WHITE = np.array([1.0, 1.0, 1.0], np.float32)
V_GREEN = np.array([0.3, 0.2, 0.1], np.float32)
CHUNKED = 16 * 16 * 8  # max_lanes that splits spp 32 into 4 chunks


def _close_tables(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                               err_msg=what)


def _golden_rule(got, want, what):
    m = golden_mismatch(np.asarray(got), np.asarray(want))
    assert m["shape_ok"] and m["n_bad"] == 0, (what, m)


@pytest.fixture(scope="module")
def scenes():
    desc = grad_cbox(mitr)
    return (mitr.load_dict(copy.deepcopy(desc)),
            mt.load_dict(copy.deepcopy(desc), device="cpu"))


@pytest.fixture(scope="module")
def jax_results(scenes):
    """The JAX package's backward and forward results on the test_grad box,
    in one pass and in 4 chunks."""
    jsc = scenes[0]
    out = {}
    for tag, kw in (("single", {}), ("chunked", {"max_lanes": CHUNKED})):
        for name, adj in (("bwd", ONES_T), ("rand", RAND_T)):
            g = mitr.render_backward(jsc, (None, adj), spp=GRAD_SPP, seed=0,
                                     **kw)
            out[f"{name}_{tag}"] = {k: np.asarray(v) for k, v in g.items()
                                    if k != "__tables__"}
        out[f"fwd_{tag}"] = [np.asarray(a) for a in mitr.render_forward(
            jsc, {"white.reflectance.value": V_WHITE}, spp=GRAD_SPP, seed=0,
            **kw)]
    return out


@pytest.fixture(scope="module")
def port_backward(scenes):
    return mt.render_backward(scenes[1], (None, ONES_T), spp=GRAD_SPP,
                              seed=0)


def test_gradients_golden():
    """render_backward on golden_configs.gradients (ones for both adjoint
    images) against tests/goldens/gradients.npz."""
    import os

    sc = mt.load_dict(gradients_cbox(mt), device="cpu")
    g = mt.render_backward(sc, (np.ones((8, 8, 3), np.float32),
                                np.ones((8, 8, 100, 3), np.float32)),
                           **GRADIENTS)
    want = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "gradients.npz"))
    tables = g["__tables__"]
    for k in ("bsdf_reflectance", "emitter_radiance"):
        _golden_rule(getattr(tables, k).numpy(), want[k], k)


def test_gradients_scene_is_the_golden_config():
    from golden_configs import _small_cbox

    d = _small_cbox(8, 8, 100, 4)
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = 0.2
    d["integrator"]["rr_depth"] = 99
    assert gradients_cbox(mitr) == d


def test_backward_matches_jax(port_backward, jax_results):
    want = jax_results["bwd_single"]
    assert set(port_backward) - {"__tables__"} == set(want)
    for k, w in want.items():
        _close_tables(port_backward[k].numpy(), w, k)
    assert np.any(port_backward["white.reflectance.value"].numpy() != 0)


def test_backward_chunked_matches_jax(scenes, jax_results):
    g = mt.render_backward(scenes[1], (None, ONES_T), spp=GRAD_SPP, seed=0,
                           max_lanes=CHUNKED)
    for k, w in jax_results["bwd_chunked"].items():
        _close_tables(g[k].numpy(), w, k)


@pytest.mark.parametrize("tag", ["single", "chunked"])
def test_backward_time_varying_adjoint_matches_jax(scenes, jax_results, tag):
    """PRB backward with a uniform random transient adjoint, in one pass
    and in 4 chunks, against the JAX package."""
    kw = {"max_lanes": CHUNKED} if tag == "chunked" else {}
    g = mt.render_backward(scenes[1], (None, RAND_T), spp=GRAD_SPP, seed=0,
                           **kw)
    want = jax_results[f"rand_{tag}"]
    assert set(g) - {"__tables__"} == set(want)
    for k, w in want.items():
        _close_tables(g[k].numpy(), w, k)
    assert np.any(g["white.reflectance.value"].numpy() != 0)


def test_optimize_reflectance_adjoint_matches_jax():
    """The first step of optimize_reflectance at 16 x 16 (200 bins of 0.04
    from OPL 0, depth 4, spp 32): the adjoint 2 / numel * (img - target)
    of its transient L2 loss, with the white wall's reflectance moved to
    the example's start.  PRB against the JAX package's PRB, full AD
    against the JAX package's full AD, and full AD against a central
    difference of the same seeded loss (test_grad.py's tolerance).

    PRB reads the adjoint of a vertex's whole contribution at the
    vertex's own bin, where its NEE and indirect terms land later (the
    reference's estimator): on this loss its gradient has the other sign
    than the exact one in the red and blue channels, in both packages
    (ROADMAP queue 3)."""
    desc = time_window_cbox(mitr, 16, 200)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    path, spp = "white.reflectance.value", GRAD_SPP
    start = np.array(OPTIMIZE_REFLECTANCE["start"], np.float32)
    _s, target = mt.render(tsc, spp=spp,
                           seed=OPTIMIZE_REFLECTANCE["target_seed"])
    target = target.double().numpy()
    for pkg, sc in ((mitr, jsc), (mt, tsc)):
        params = pkg.traverse(sc)
        params[path] = start
        params.update()
    _s, img = mt.render(tsc, spp=spp, seed=0, regenerate=False)
    adj = ((2.0 / target.size) * (img.double().numpy() - target)).astype(
        np.float32)
    grads = {}
    for method in (None, "fullad"):
        grads[method] = (
            np.asarray(mitr.render_backward(jsc, (None, adj), spp=spp,
                                            seed=0, method=method)[path]),
            mt.render_backward(tsc, (None, adj), spp=spp, seed=0,
                               method=method)[path].numpy())
        _close_tables(grads[method][1], grads[method][0], method or "prb")
    params, eps, fd = mt.traverse(tsc), 1e-2, []
    for c in range(3):
        losses = []
        for sign in (1.0, -1.0):
            v = start.copy()
            v[c] += sign * eps
            params[path] = v
            params.update()
            _s, t = mt.render(tsc, spp=spp, seed=0, regenerate=False)
            losses.append(float(((t.double().numpy() - target) ** 2).mean()))
        fd.append((losses[0] - losses[1]) / (2 * eps))
    np.testing.assert_allclose(grads["fullad"][1], fd, rtol=0.02)
    for g_prb in grads[None]:  # the JAX package's, then the port's
        assert g_prb[0] > 0.0 > fd[0] and g_prb[2] > 0.0 > fd[2]


@pytest.mark.parametrize("tag", ["single", "chunked"])
def test_forward_matches_jax(scenes, jax_results, tag):
    kw = {"max_lanes": CHUNKED} if tag == "chunked" else {}
    got = mt.render_forward(scenes[1], {"white.reflectance.value": V_WHITE},
                            spp=GRAD_SPP, seed=0, **kw)
    for name, g, w in zip(("d_steady", "d_transient"), got,
                          jax_results[f"fwd_{tag}"]):
        _golden_rule(g.numpy(), w, name)


def test_emitter_radiance_gradient_linearity(scenes, port_backward):
    """L is linear in the single emitter's radiance, so <grad, radiance>
    equals the loss (test_grad.py:46-56)."""
    tsc = scenes[1]
    g = port_backward["light.emitter.radiance.value"].numpy()
    rad = tsc.data.emitter.radiance[0].numpy()
    _s, t = mt.render(tsc, spp=GRAD_SPP, seed=0, regenerate=False)
    loss = float(t.sum())
    assert abs(float(g @ rad) - loss) / max(loss, 1e-9) < 1e-3


def test_forward_backward_consistency(scenes, port_backward):
    """<backward gradient, v> equals the sum of the forward video along v
    (test_grad.py:111-124)."""
    _ds, dt = mt.render_forward(scenes[1], {"green.reflectance.value":
                                            V_GREEN}, spp=GRAD_SPP, seed=0)
    bwd = float(port_backward["green.reflectance.value"].numpy() @ V_GREEN)
    assert abs(float(dt.sum()) - bwd) / max(abs(bwd), 1e-9) < 1e-3


def test_albedo_gradient_vs_finite_difference(scenes, port_backward):
    """The backward gradient against a central difference of the same
    seeded multi-pass estimator (test_grad.py:59-81), through traverse."""
    tsc = scenes[1]
    params = mt.traverse(tsc)
    path = "white.reflectance.value"
    base = params[path].clone()
    v = torch.tensor([1.0, 0.5, 0.25])
    eps = 1e-3
    losses = []
    for sign in (1.0, -1.0):
        params[path] = base + sign * eps * v
        params.update()
        _s, t = mt.render(tsc, spp=GRAD_SPP, seed=0, regenerate=False)
        losses.append(float(t.double().sum()))
    params[path] = base
    params.update()
    fd = (losses[0] - losses[1]) / (2 * eps)
    an = float(port_backward[path] @ v)
    assert fd != 0.0 and abs(an - fd) / abs(fd) < 0.02, (an, fd)


@pytest.mark.parametrize("name", ["ggx", "texels"])
def test_alpha_and_texel_gradients_match_jax(name):
    """PRB backward (GGX roughness with its isotropic chain rule, texture
    texels) and forward mode along the same path, against the JAX
    package."""
    desc = diff_case(mitr, name)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    fc = tsc.sensors[0].film
    ones = np.ones((fc.height, fc.width, fc.temporal_bins, 3), np.float32)
    key = ("small-box.bsdf.alpha.value" if name == "ggx"
           else "floor.bsdf.reflectance.data")
    gj = mitr.render_backward(jsc, (None, ones), spp=16, seed=0)
    gp = mt.render_backward(tsc, (None, ones), spp=16, seed=0)
    assert set(gp) == set(gj)
    for k in gp:
        if k != "__tables__":
            _close_tables(gp[k].numpy(), gj[k], k)
    assert np.any(gp[key].numpy() != 0.0)
    tangent = {key: np.float32(1.0) if name == "ggx"
               else np.full(gp[key].shape, 0.5, np.float32)}
    for g, w in zip(mt.render_forward(tsc, tangent, spp=16, seed=0),
                    mitr.render_forward(jsc, tangent, spp=16, seed=0)):
        _golden_rule(g.numpy(), w, key)


def test_steady_adjoint_alone_gives_gradients(scenes):
    g = mt.render_backward(scenes[1], (np.ones((16, 16, 3), np.float32),
                                       None), spp=8, seed=0)
    w = g["white.reflectance.value"].numpy()
    assert np.all(np.isfinite(w)) and np.any(w != 0.0)


# --------------------------------------------------------------------------
# refusals: as the JAX package's, and what the port does not have yet
# --------------------------------------------------------------------------

def _refusal_scene(kind):
    if kind == "phasor":
        d = mt.cornell_box()
        d["sensor"]["film"] = {"type": "phasor_hdr_film", "width": 4,
                               "height": 4, "temporal_bins": 40,
                               "bin_width_opl": 0.02, "start_opl": 3.5,
                               "wl_mean": 0.5, "wl_sigma": 0.5}
        return d
    if kind == "crop":
        d = small_cbox(mt, 8, 8, 20, 2)
        d["sensor"]["film"].update(crop_width=4, crop_height=4,
                                   crop_offset_x=2, crop_offset_y=2)
        return d
    if kind == "exhaustive":
        return nlos_exhaustive(nlos_scene(sx=2, sy=2), 2, 2)
    return small_cbox(mt, 8, 8, 20, 2)


@pytest.mark.parametrize("kind, call", [
    ("phasor", "backward"), ("phasor", "forward"), ("crop", "backward"),
    ("crop", "forward"), ("exhaustive", "backward"),
    ("exhaustive", "forward"), ("lanes", "backward"), ("lanes", "forward")])
def test_refusals_match_jax(kind, call):
    desc = _refusal_scene(kind)
    spp = (1 << 32) // 64 + 1 if kind == "lanes" else 4
    errors = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        sc = pkg.load_dict(copy.deepcopy(desc), **kw)
        if kind == "exhaustive":
            pkg.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], sc)
        hw = sc.sensors[0].film.width * sc.sensors[0].film.height
        with pytest.raises((NotImplementedError, ValueError)) as err:
            if call == "backward":
                pkg.render_backward(sc, (None, None), spp=spp, seed=0)
            else:
                pkg.render_forward(sc, {"white.reflectance.value":
                                        V_WHITE}, spp=spp, seed=0)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]
    if kind == "lanes":
        assert hw == 64


def test_unported_differentiation_is_refused(monkeypatch):
    """The polarized and spectral variants, which the port once refused
    here (ROADMAP item 16b), now differentiate: render_backward and
    render_forward of a spectral volumetric scene, a polarized box and a
    spectral box return finite results of the variant's shape, by the JAX
    package's route (its render.py:376-396, 675-676): the spectral
    volumetric scene through the (RGB) PRB replay, the others through full
    AD, and forward mode through the whole primal.  Volumetric scenes
    themselves (item 15) differentiate too."""
    d = small_cbox(mt, 8, 8, 20, 2)
    d["small-box"]["medium"] = {"type": "homogeneous", "sigma_t": 1.0}
    assert mt.load_dict(d, device="cpu").data.medium.sigma_t.tolist() == [1.0]
    old = mt.variant()
    try:
        mt.set_variant("mono_polarized")
        assert mt.variant() == Variant(1, polarized=True)
    finally:
        mt.set_variant(old)
    sc = mt.load_dict(small_cbox(mt, 8, 8, 20, 2), device="cpu")
    vol = copy.copy(sc)
    vol.integrator = sc.integrator._replace(kind="transient_prbvolpath")
    assert set(mt.render_backward(vol, (None, None), spp=1)) >= {
        "__tables__", "white.reflectance.value"}
    seen = spy_routes(monkeypatch, mt)
    for change, channels, route in (
            (lambda s: setattr(s, "integrator", s.integrator.
                               _replace(kind="transient_prbvolpath"))
             or setattr(s, "variant", Variant(3, spectral=True)), 3,
             "prb_vol"),
            (lambda s: setattr(s, "variant", Variant(3, polarized=True)), 12,
             "fullad"),
            (lambda s: setattr(s, "variant", Variant(3, spectral=True)), 3,
             "fullad")):
        scene = copy.copy(sc)
        change(scene)
        seen.clear()
        grads = mt.render_backward(scene, (None, None), spp=1)
        assert set(grads) >= {"__tables__", "white.reflectance.value"}
        assert all(torch.isfinite(v).all() for k, v in grads.items()
                   if k != "__tables__")
        steady, transient = mt.render_forward(scene, {}, spp=1)
        assert steady.shape == (8, 8, channels)
        assert transient.shape == (8, 8, 20, channels)
        assert torch.isfinite(transient).all()
        assert seen == [route, "jvp"]


# The chunked routes of render_backward, as the JAX package dispatches them
# (its render.py:376-398): they never build one wavefront, so they take any
# spp; the PRB replay of transient_path keeps the 2^32-lane refusal
# (test_refusals_match_jax).
_CHUNKED_ROUTES = {
    "volumetric_prb": ({"kind": "transient_prbvolpath"}, None),
    "nlos_single": (None, None),
    "fullad": ({}, "fullad"),
    "volumetric_fullad": ({"kind": "transient_prbvolpath"}, "fullad"),
}


@pytest.mark.parametrize("route", sorted(_CHUNKED_ROUTES))
def test_chunked_routes_take_any_lane_count(monkeypatch, route):
    """Above 2^32 lanes the volumetric PRB replay, full AD and the NLOS
    single capture reach their chunked route in both packages (each route
    stubbed, so that no such render runs)."""
    import importlib

    jrender, jfullad, trender, tfullad = (importlib.import_module(m) for m in (
        "mitransient_tpu.render", "mitransient_tpu.integrators.fullad",
        "mitransient_tpu_torch.render",
        "mitransient_tpu_torch.integrators.fullad"))

    icfg, method = _CHUNKED_ROUTES[route]
    desc = nlos_scene(sx=2, sy=2) if route == "nlos_single" else small_cbox(
        mt, 8, 8, 20, 2)
    reached = []
    for pkg, render_mod, fullad_mod, kw in (
            (mitr, jrender, jfullad, {}),
            (mt, trender, tfullad, {"device": "cpu"})):
        def stub(name):
            return lambda *a, **k: reached.append((pkg.__name__, name)) or {}

        monkeypatch.setattr(render_mod, "render_backward_volpath",
                            stub("volpath"))
        monkeypatch.setattr(fullad_mod, "render_backward_fullad",
                            stub("fullad"))
        sc = pkg.load_dict(copy.deepcopy(desc), **kw)
        if icfg:
            sc.integrator = sc.integrator._replace(**icfg)
        hw = sc.sensors[0].film.width * sc.sensors[0].film.height
        spp = (1 << 32) // hw + 1
        pkg.render_backward(sc, (None, None), spp=spp, seed=0, method=method)
    want = "volpath" if route == "volumetric_prb" else "fullad"
    assert reached == [("mitransient_tpu", want),
                       ("mitransient_tpu_torch", want)]


@pytest.mark.parametrize("method", [None, "fullad"])
def test_crop_is_refused_on_every_route(method):
    """A cropped film (8x8 cropped to 4x4): the port refuses it on the
    volumetric PRB and full-AD routes too.  There the JAX package gives no
    gradient of the cropped render either: full AD reshapes an adjoint of
    the render's (4, 4, 3) shape to the full film's (64, 3) and raises a
    TypeError (fullad.py:119; ROADMAP queue 3)."""
    desc = _refusal_scene("crop")
    grad_in = (np.ones((4, 4, 3), np.float32), None)
    sc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    sc.integrator = sc.integrator._replace(kind="transient_prbvolpath")
    with pytest.raises(NotImplementedError, match="cropped film"):
        mt.render_backward(sc, grad_in, spp=4, seed=0, method=method)
    if method == "fullad":
        sc = mt.load_dict(copy.deepcopy(desc), device="cpu")
        with pytest.raises(NotImplementedError, match="cropped film"):
            mt.render_backward(sc, grad_in, spp=4, seed=0, method=method)
        jsc = mitr.load_dict(copy.deepcopy(desc))
        with pytest.raises(TypeError, match="cannot reshape"):
            mitr.render_backward(jsc, grad_in, spp=4, seed=0,
                                 method=method)


# --------------------------------------------------------------------------
# K3's autograd Function (film/transient_film.py:SplatEvents) on the CPU
# --------------------------------------------------------------------------

def _events(dtype=torch.float32, lanes=6, hw=20, bins=12, C=3, seed=4):
    rng = np.random.default_rng(seed)
    ev = [torch.from_numpy(a) for _ in range(2)
          for a in splat_events(rng, lanes, hw, bins, C)]
    ev[0][::7] = bins + 3  # some events beyond the film: dropped
    ev[1], ev[3] = ev[1].to(dtype), ev[3].to(dtype)
    return ev, (C, bins + 1, hw), lanes


def _plain_splat(film, ev, hw):
    for b, v in zip(ev[0::2], ev[1::2]):
        tf._scatter_layout(film, hw, b, v)
    return film


def test_splat_function_backward_equals_plain_autograd():
    ev, shape, lanes = _events()
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=shape).astype(np.float32))
    va, vb = (ev[1].clone().requires_grad_(), ev[3].clone().requires_grad_())
    film = tf.SplatEvents.apply(torch.zeros(shape), ev[0], va * 1.0, ev[2],
                                vb * 1.0, lanes)
    ga, gb = torch.autograd.grad((film * w).sum(), (va, vb))
    pa, pb = (ev[1].clone().requires_grad_(), ev[3].clone().requires_grad_())
    plain = _plain_splat(torch.zeros(shape), [ev[0], pa * 1.0, ev[2],
                                              pb * 1.0], shape[2])
    wa, wb = torch.autograd.grad((plain * w).sum(), (pa, pb))
    assert torch.equal(film.detach(), plain.detach())
    assert torch.equal(ga, wa) and torch.equal(gb, wb)
    assert torch.count_nonzero(ga[::7]) < ga[::7].numel()  # dropped: 0


def test_splat_function_jvp_equals_plain_forward_ad():
    ev, shape, lanes = _events()
    rng = np.random.default_rng(6)
    ta, tb = (torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
              for v in (ev[1], ev[3]))
    with fwAD.dual_level():
        da, db = fwAD.make_dual(ev[1], ta), fwAD.make_dual(ev[3], tb)
        out = tf.SplatEvents.apply(torch.zeros(shape), ev[0], da, ev[2], db,
                                   lanes)
        got = fwAD.unpack_dual(out)
        plain = _plain_splat(torch.zeros(shape), [ev[0], da, ev[2], db],
                             shape[2])
        want = fwAD.unpack_dual(plain)
        assert torch.equal(got.primal, want.primal)
        assert torch.equal(got.tangent, want.tangent)


def test_splat_function_gradcheck():
    """Backward and forward mode against numerical derivatives (float64),
    one and two event sets, with a film that already holds a tangent."""
    ev, shape, lanes = _events(torch.float64, lanes=3, hw=5, bins=4, C=2)
    va, vb = (ev[1].clone().requires_grad_(), ev[3].clone().requires_grad_())
    base = torch.rand(shape, dtype=torch.float64, requires_grad=True)

    def two(film, a, b):
        return tf.SplatEvents.apply(film.clone(), ev[0], a, ev[2], b, lanes)

    def one(film, a):
        return tf.SplatEvents.apply(film * 2.0, ev[0], a, None, None, lanes)

    assert torch.autograd.gradcheck(two, (base, va, vb),
                                    check_forward_ad=True)
    assert torch.autograd.gradcheck(one, (base, va), check_forward_ad=True)
