"""Differentiable rendering under the polarized and spectral variants, the
port against the JAX package on the CPU.

- The routes: ``render_backward`` (with and without ``method="fullad"``)
  and ``render_forward`` take the JAX package's route
  (``render.py:376-396, 675-676``) for every integrator and variant: each
  package's route functions are replaced by a recorder, so no gradient is
  computed there.
- Every ``torch_cases.VARIANT_GRAD_CASES`` configuration
  (tests/test_polarized.py:188, tests/test_fullad.py:92,
  tests/test_prb_vol.py:111, tests/test_volumetric.py:196, a spectral fog
  through the PRB replay and a spectral box through full AD): every
  gradient table within 1e-4 of its largest |value|, but for the shape
  poses of the two polarized fogs (``VOL_POSE_TIES``).  At the JAX tests'
  seed 0 one lane's shadow ray leaves a face of the large box at a grazing
  angle and re-hits its own triangle under XLA's FMA-contracted hit point
  only (ROADMAP queue 3): the unpolarized renders of the same configs
  part in the same 4 elements of each pose table.
- The finite-difference checks of those JAX tests on the port (within
  5 %).
- The spectral volumetric PRB replay differentiates the RGB estimator, as
  the JAX package's (``prb_vol.py``): its tables equal the same scene's
  under ``rgb`` bit for bit.
- ``render_forward`` of a polarized box, a spectral fog and a polarized
  NLOS capture: test_golden's rule, no element out.
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from torch_cases import (
    VARIANT_GRAD_CASES,
    Routed,
    golden_mismatch,
    nlos_scene,
    small_cbox,
    spy_routes,
    variant_grad_case,
    vol_cbox,
    with_variant,
)

torch.set_num_threads(1)

# elements of each shape-pose table out of 1e-4, and their bound, as a
# share of the table's largest |value| (measured: 4 elements, 3.8e-3 and
# 1.2e-2)
VOL_POSE_TIES = {"pol_fog": (4, 1e-2), "pol_vol_steady": (4, 2e-2)}
POSE = ("shape_translate", "shape_rotate")
# full AD of the polarized box with its gold GGX small box gives the box's
# roughness and every shape pose NaN gradients, in both packages (ROADMAP
# queue 3); the other tables are finite
POL_NAN_TABLES = {"pol_cbox": {"bsdf_alpha", "bsdf_alpha_v",
                               "shape_translate", "shape_rotate"}}
VARIANTS = ("mono", "rgb", "mono_polarized", "rgb_polarized", "spectral",
            "spectral_polarized")


def _load(pkg, variant, desc, **kw):
    with with_variant(pkg, variant):
        return pkg.load_dict(copy.deepcopy(desc), **kw)


def _table_gap(got, want):
    """(largest |got - want| over the table's largest |want|, elements out
    of 1e-4 of it), over the finite elements; the NaN elements must be
    the same in both (``POL_NAN_TABLES``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = np.abs(got - want) / scale
    return float(err.max(initial=0.0)), int((err > 1e-4).sum())


@pytest.fixture(scope="module")
def grads():
    cache = {}

    def get(name):
        if name not in cache:
            variant, desc, call = variant_grad_case(mitr, name)
            cache[name] = (call(mitr, _load(mitr, variant, desc)),
                           call(mt, _load(mt, variant, desc, device="cpu")))
        return cache[name]

    return get


# --------------------------------------------------------------------------
# Routes
# --------------------------------------------------------------------------

def _route(seen, call):
    """The route ``call`` takes, with the routes stopped."""
    try:
        call()
    except Routed:
        return seen.pop()
    raise AssertionError("no route taken")


ROUTE_SCENES = {
    "transient_path": lambda pkg: small_cbox(pkg, 4, 4, 10, 2),
    "transient_prbvolpath": lambda pkg: vol_cbox(pkg, 1.0, w=4, h=4,
                                                 bins=10, max_depth=2),
    "transient_nlos_path": lambda pkg: nlos_scene(sx=2, sy=2, bins=10),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", sorted(ROUTE_SCENES))
def test_routes_match_jax(monkeypatch, kind, variant):
    """render_backward (the default method and ``method="fullad"``) and
    render_forward pick the JAX package's route: the spectral volumetric
    scene the (RGB) PRB replay, the polarized one full AD."""
    routes = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        seen = spy_routes(monkeypatch, pkg, stop=True)
        scene = _load(pkg, variant, ROUTE_SCENES[kind](pkg), **kw)
        routes.append([
            _route(seen, lambda: pkg.render_backward(scene, (None, None),
                                                     spp=1)),
            _route(seen, lambda: pkg.render_backward(scene, (None, None),
                                                     spp=1, method="fullad")),
            _route(seen, lambda: pkg.render_forward(scene, {}, spp=1))])
    assert routes[1] == routes[0]
    pol, spec = "polarized" in variant, "spectral" in variant
    want = {"transient_path": "fullad" if pol or spec else "prb",
            "transient_prbvolpath": "fullad" if pol else "prb_vol",
            "transient_nlos_path": "fullad"}[kind]
    forward = ("prb_forward" if kind == "transient_path"
               and not (pol or spec) else "jvp")
    assert routes[1] == [want, "fullad", forward]


def test_volpath_replay_refuses_polarized():
    """render_backward_volpath of a polarized scene raises the JAX
    package's message (its render.py:470-474)."""
    from mitransient_tpu_torch.render import render_backward_volpath

    scene = _load(mt, "mono_polarized", vol_cbox(mt, 1.0, w=4, h=4, bins=10,
                                                 max_depth=2), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="polarized volumetric is primal-only via the "
                             "PRB replay"):
        render_backward_volpath(scene, (None, None), spp=1)


# --------------------------------------------------------------------------
# Gradients against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANT_GRAD_CASES)
def test_gradients_match_jax(grads, name):
    gj, gp = grads(name)
    assert set(gp) == set(gj)
    tj, tp = gj["__tables__"], gp["__tables__"]
    n_out, bound = VOL_POSE_TIES.get(name, (0, 1e-4))
    for f in tp._fields:
        g = getattr(tp, f)
        assert (g is None) == (getattr(tj, f) is None), f
        if g is None:
            continue
        gap, out = _table_gap(g.numpy(), getattr(tj, f))
        if f in POSE:
            assert gap <= bound and out <= n_out, (f, gap, out)
        else:
            assert gap <= 1e-4, (f, gap)
    for k in gp:
        if k != "__tables__" and not k.endswith(("translate", "rotate")):
            assert _table_gap(gp[k].numpy(), gj[k])[0] <= 1e-4, k
    assert torch.isfinite(tp.bsdf_reflectance).all()
    nans = {f for f in tp._fields if getattr(tp, f) is not None
            and bool(getattr(tp, f).isnan().any())}
    assert nans == POL_NAN_TABLES.get(name, set())


def test_spectral_volumetric_prb_is_the_rgb_replay(grads):
    """The JAX package's volumetric replay is non-spectral: a spectral
    scene's PRB tables are the same scene's under rgb (ROADMAP queue 3)."""
    _gj, gp = grads("spectral_fog")
    variant, desc, call = variant_grad_case(mt, "spectral_fog")
    rgb = call(mt, _load(mt, "rgb", desc, device="cpu"))
    for f in gp["__tables__"]._fields:
        a, b = getattr(gp["__tables__"], f), getattr(rgb["__tables__"], f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def _fd(scene, key, loss, eps=1e-3):
    params = mt.traverse(scene)
    base = params[key].clone()
    out = []
    for s in (1.0, -1.0):
        params[key] = base + s * eps
        params.update()
        out.append(loss())
    params[key] = base
    params.update()
    return (out[0] - out[1]) / (2 * eps)


@pytest.mark.parametrize("name, key", [
    ("pol_cbox", "white.reflectance.value"),
    ("pol_nlos", "hidden-target"),
    ("pol_fog", "albedo")])
def test_gradient_matches_finite_differences(grads, name, key):
    """The finite-difference checks of tests/test_polarized.py:188,
    tests/test_fullad.py:92 and tests/test_prb_vol.py:111 on the port: the
    S0-weighted loss's derivative along all-ones, within 5 %."""
    _gj, gp = grads(name)
    variant, desc, _call = variant_grad_case(mt, name)
    scene = _load(mt, variant, desc, device="cpu")
    if name == "pol_nlos":
        mt.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], scene)
    key = next(k for k in gp if key in k)
    g = gp[key].numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    C = scene.variant.color_channels

    def loss():
        t = mt.render(scene, spp=16, seed=0)[1]
        return float(t[..., :C].double().sum())

    fd = _fd(scene, key, loss)
    an = float(g.sum())
    assert fd != 0.0 and abs(an - fd) / abs(fd) < 0.05, (an, fd)


# --------------------------------------------------------------------------
# Forward mode
# --------------------------------------------------------------------------

FORWARD_CASES = {  # variant, gradient case, the table moved along ones
    "pol_box": ("mono_polarized", "pol_cbox", "bsdf.reflectance"),
    "spectral_fog": ("spectral", "spectral_fog", "medium.albedo"),
    "pol_nlos": ("mono_polarized", "pol_nlos", "bsdf.reflectance"),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_matches_jax(name):
    """render_forward takes forward-mode AD through the variant's primal
    in both packages (spp 4)."""
    variant, case, table = FORWARD_CASES[name]
    scenes = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        scene = _load(pkg, variant, variant_grad_case(pkg, case)[1], **kw)
        if case == "pol_nlos":
            pkg.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], scene)
        scenes.append(scene)
    data = scenes[1].data
    ref = (data.bsdf.reflectance if table == "bsdf.reflectance"
           else data.medium.albedo)
    tan = {table: np.ones(tuple(ref.shape), np.float32)}
    jd = mitr.render_forward(scenes[0], tan, spp=4, seed=0)
    td = mt.render_forward(scenes[1], tan, spp=4, seed=0)
    for got, want in zip(td, jd):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        m = golden_mismatch(got.numpy(), want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
