"""The port's NLOS capture against the JAX package on the CPU: the loader's
NLOS and delta-emitter tables, ``prepare_nlos`` in both its branches, the
hidden-point pick, one wavefront from a context carried across, the
``nlos_single`` golden, every configuration that ``chip_smoke.py`` holds
card against CPU (``torch_cases.NLOS_CASES``), the refusals, the focus
helpers, ``render_aovs`` and ``core/distribution.py``.

Both packages draw the same threefry streams, so renders agree per sample.
Tolerances: test_golden's rule (rtol 5e-4, atol 5e-5 * max) with no
element out for renders and film states; ray counts within 0.1 % (XLA:CPU
contracts FMAs, the port does not); the capture's constants, which
compose a few float32 operations, rtol 1e-5 / atol 1e-6; integers and
discrete choices exactly.
"""
import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.core import rng as jrng
from mitransient_tpu.core.distribution import DiscreteDistribution as JDist
from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.integrators import nlos_path as jn
from mitransient_tpu.scene import scene as jscene
from mitransient_tpu.scene.scene import KindsStatic
from mitransient_tpu_torch.convert import (
    nlos_context_from_numpy,
    scene_data_from_numpy,
    scene_data_to_numpy,
)
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.core.distribution import DiscreteDistribution
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import nlos_path as tn
from mitransient_tpu_torch.scene import scene as tscene
from torch_cases import (
    NLOS_CASES,
    POINT_LIGHT,
    golden_mismatch,
    nlos_case,
    nlos_confocal,
    nlos_exhaustive,
    nlos_perspective,
    nlos_scene,
    nlos_z_scene,
    small_cbox,
    uv_sphere,
)

torch.set_num_threads(1)


def _load(desc):
    """(JAX scene, port scene on the CPU) of one dict."""
    return (mitr.load_dict(copy.deepcopy(desc)),
            mt.load_dict(copy.deepcopy(desc), device="cpu"))


def _focus(scenes, pixel=(2.0, 2.0)):
    for pkg, sc in zip((mitr, mt), scenes):
        pkg.nlos.focus_emitter_at_relay_wall_pixel(list(pixel), sc)
    return scenes


def _assert_matches(got, want):
    m = golden_mismatch(np.asarray(got), np.asarray(want))
    assert m["shape_ok"] and m["n_bad"] == 0, m


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def _record_close(trec, jrec, skip=()):
    for f in trec._fields:
        if f in skip:
            continue
        g, w = getattr(trec, f).cpu().numpy(), np.asarray(getattr(jrec, f))
        assert g.shape == w.shape, f
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            _close(g, w, f)


def _jax_fields(rec) -> dict:
    return {f: np.asarray(getattr(rec, f)) for f in rec._fields}


@pytest.mark.parametrize("kw", [{}, dict(sx=1, sy=1, laser_sampling=False),
                                dict(hg_sampling=False, account=True,
                                     bins=200, spp=16)])
def test_nlos_scene_is_the_jax_fixture(kw):
    from test_nlos import nlos_scene as jax_nlos_scene

    assert nlos_scene(**kw) == jax_nlos_scene(**kw)


def _shape_triangles(scene, key):
    """(v0, e1, e2) of the shape ``key``'s triangles, float64 on the host."""
    tri = scene.data.tri
    mine = tri.shape_id == scene.shape_index(key)
    return [getattr(tri, f)[mine].double().numpy() for f in ("v0", "e1", "e2")]


def test_benchmark_z_is_the_examples_z():
    """The benchmark's NLOS configuration writes each bar of the hidden Z
    as one dict of ops (the middle bar's two turns as the one half-turn
    they compose); the port loads the triangles of the example's chained
    lists from it."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "portbench", "configs", "nlos_z.json")
    with open(path) as f:
        desc = json.load(f)["scene"]
    for bar in ("z-top", "z-mid", "z-bot"):
        assert isinstance(desc[bar]["to_world"], dict)
    mine = mt.load_dict(copy.deepcopy(desc), device="cpu")
    theirs = mt.load_dict(nlos_z_scene(4, 4), device="cpu")
    assert mine.data.tri.v0.shape[0] == 8
    for key in ("z-top", "z-mid", "z-bot", "relay_wall"):
        for a, b in zip(_shape_triangles(mine, key),
                        _shape_triangles(theirs, key)):
            assert a.shape == b.shape == (2, 3)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["single", "confocal", "exhaustive",
                                  "point_cbox"])
def test_loaded_configs_and_tables_match_jax(name):
    """Sensor, film and integrator configs, and every scene leaf (the delta
    emitters' rows included), as the JAX loader makes them."""
    desc = {"single": nlos_scene(),
            "confocal": nlos_confocal(nlos_scene(sx=1, sy=1), 4, 3),
            "exhaustive": nlos_exhaustive(nlos_scene(), 3, 2),
            "point_cbox": nlos_case(mt, "point_regen")[0]}[name]
    if name == "single":
        desc["integrator"].update(filter_bounces=2, illumination_scan_fov=30.0)
    jsc, tsc = _load(desc)
    for tcfg, jcfg in ((tsc.sensors[0].film, jsc.sensors[0].film),
                       (tsc.integrator, jsc.integrator)):
        for f in tcfg._fields:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    ts, js = tsc.sensors[0], jsc.sensors[0]
    for f in ("kind", "spp", "seed", "shape_index", "original_film_width",
              "original_film_height", "is_confocal", "scan_size"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.sensor_origin, js.sensor_origin)
    leaves = scene_data_to_numpy(tsc.data)
    for k, g in leaves.items():
        w = np.asarray(jscene_leaf(jsc.data, k))
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7 * max(
                float(np.abs(w).max()), 1e-30), err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert tsc.data.emitter_kinds == jsc.data.emitter.ks.kinds
    carried = scene_data_from_numpy(leaves, device="cpu")
    assert carried.emitter_kinds == tsc.data.emitter_kinds


def jscene_leaf(jsd, key):
    rec, field = key.split(".")
    v = getattr(getattr(jsd, rec), field)
    assert not isinstance(v, KindsStatic)
    return v


def test_focus_writes_the_emitter_rows():
    scenes = _focus(_load(nlos_scene()), (1.0, 3.0))
    jsc, tsc = scenes
    for f in ("position", "direction", "frame_s", "frame_t"):
        np.testing.assert_array_equal(
            getattr(tsc.data.emitter, f).numpy(),
            np.asarray(getattr(jsc.data.emitter, f)), err_msg=f)
    np.testing.assert_array_equal(tsc.laser_target, jsc.laser_target)
    assert tsc.laser_bounce_opl == jsc.laser_bounce_opl and tsc.laser_focused
    for pkg, sc in zip((mitr, mt), scenes):
        pkg.nlos.focus_emitter_at_relay_wall_uv([0.25, 0.5], sc)
    np.testing.assert_array_equal(tsc.data.emitter.direction.numpy(),
                                  np.asarray(jsc.data.emitter.direction))


@pytest.mark.parametrize("branch", ["capture_meter", "capture_meter_unfocused",
                                    "perspective", "confocal"])
def test_prepare_nlos_matches_jax(branch):
    desc = {"capture_meter": nlos_scene(),
            "capture_meter_unfocused": nlos_scene(),
            "perspective": nlos_perspective(nlos_scene(sx=5, sy=3)),
            "confocal": nlos_confocal(nlos_scene(sx=1, sy=1), 4, 4)}[branch]
    jsc, tsc = _load(desc)
    if branch == "perspective":
        for pkg, sc in ((mitr, jsc), (mt, tsc)):
            pkg.nlos.focus_emitter_at_relay_wall_3dpoint([0.1, 0.05, 0.0], sc)
    elif branch != "capture_meter_unfocused":
        _focus((jsc, tsc))
    jctx = jn.prepare_nlos(jsc, jsc.sensors[0])
    tctx = tn.prepare_nlos(tsc, tsc.sensors[0])
    _record_close(tctx, jctx)
    assert bool(tctx.wall_clear) and float(tctx.wall_em.sum()) > 0


def test_prepare_exhaustive_lasers_matches_jax():
    jsc, tsc = _load(nlos_exhaustive(nlos_scene(), 3, 2))
    desc = nlos_exhaustive(nlos_scene(), 3, 2)
    desc["integrator"].update(force_equal_illumination_scanning=False,
                              illumination_scan_fov=30.0)
    for sc_pair in ((jsc, tsc), _load(desc)):
        j, t = sc_pair
        jt, jv = jn.exhaustive_laser_targets(j, j.sensors[0], j.integrator)
        tt, tv = tn.exhaustive_laser_targets(t, t.sensors[0], t.integrator)
        _close(tt, jt, "targets")
        np.testing.assert_array_equal(tv, jv)
        _record_close(tn.prepare_exhaustive_lasers(t, tt),
                      jn.prepare_exhaustive_lasers(j, jt))


def _hidden_soup_scene():
    """nlos_scene with a 200-triangle sphere (11 rings x 10 segments)
    beside its hidden rectangle: 202 hidden triangles."""
    verts, faces = uv_sphere(11, 10, 0.3, (0.0, 0.0, 1.0))
    desc = nlos_scene()
    desc["hidden-sphere"] = {"type": "mesh", "vertices": verts, "faces": faces}
    return desc


def test_sample_hidden_point_picks_the_masked_slot():
    """searchsorted on the area CDF picks the triangle that the JAX
    package's compare-and-count picks, on a 202-triangle hidden soup, for
    random u and for u equal to every CDF entry and its neighbours."""
    jsc, tsc = _focus(_load(_hidden_soup_scene()))
    jctx = jn.prepare_nlos(jsc, jsc.sensors[0])
    ctx = nlos_context_from_numpy(_jax_fields(jctx), device="cpu")
    cdf = np.asarray(jctx.hg_tri_cdf)
    assert cdf.shape[0] == 202
    rng = np.random.default_rng(5)
    u0 = np.concatenate([rng.random(4000), cdf, np.nextafter(cdf, 0),
                         np.nextafter(cdf, 2), [0.0]]).astype(np.float32)
    u0 = np.minimum(u0, np.float32(1.0 - 2 ** -24))
    u1 = rng.random(u0.shape[0]).astype(np.float32)
    jp, jn_, jpdf = jn._sample_hidden_point(jscene.primal_sd(jsc.data), jctx,
                                            jnp.asarray(u0), jnp.asarray(u1))
    tp, tn_, tpdf = tn._sample_hidden_point(tscene.primal_sd(tsc.data), ctx,
                                            torch.from_numpy(u0),
                                            torch.from_numpy(u1))
    np.testing.assert_array_equal(tn_.numpy(), np.asarray(jn_))
    _close(tp.numpy(), jp, "p")
    np.testing.assert_allclose(float(tpdf), np.asarray(jpdf)[0], rtol=1e-7)
    want = np.minimum((u0[:, None] > cdf[None, :]).sum(1), cdf.shape[0] - 1)
    got = torch.clamp_max(torch.searchsorted(ctx.hg_tri_cdf,
                                             torch.from_numpy(u0)), 201)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("laser", [True, False])
def test_sample_nlos_primal_from_the_carried_context(laser):
    """One wavefront of 3 spp, both packages on the JAX package's own
    context: the film (overflow bin included), L, validity and rays."""
    desc = nlos_scene(laser_sampling=laser)
    desc["integrator"]["rr_depth"] = 2
    jsc, tsc = _focus(_load(desc), (1.0, 2.0))
    jctx = jn.prepare_nlos(jsc, jsc.sensors[0])
    ctx = nlos_context_from_numpy(_jax_fields(jctx), device="cpu")
    cfg, jcfg = tsc.sensors[0].film, jsc.sensors[0].film
    spp, hw = 3, 16
    skip = tn.can_skip_le(tsc.data)
    assert skip == jn.can_skip_le(jsc.data) == laser or skip
    jsamp = jrng.Sampler(jnp.uint32(6), spp * hw, stream=jnp.uint32(2))
    jray, jw = jn.sample_nlos_rays(jctx, spp, hw)
    jfilm, jL, jvalid, jrays = jn.sample_nlos_primal(
        jscene.primal_sd(jsc.data), jctx, jsamp, jray, jw,
        jf.film_init(jcfg, 3, scan_pixels=hw), jcfg, jsc.integrator,
        jnp.float32(1 / 3), base_dim=2, spp=spp, skip_le=skip)
    tsamp = trng.Sampler(6, spp * hw, 2)
    tray, tw = tn.sample_nlos_rays(ctx, spp, hw)
    _close(tray.d.numpy(), jray.d, "ray.d")
    tfilm, tL, tvalid, trays = tn.sample_nlos_primal(
        tscene.primal_sd(tsc.data), ctx, tsamp, tray, tw,
        tf.film_init(cfg, 3, scan_pixels=hw), cfg, tsc.integrator, 1 / 3,
        spp, skip_le=skip)
    T = cfg.temporal_bins
    _assert_matches(tfilm.transient.numpy(),
                    np.asarray(jfilm.transient)[:, :T + 1, :hw])
    _assert_matches(tL.numpy(), jL)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jr = float(np.asarray(jrays))
    assert trays.dtype == torch.int64 and abs(int(trays) - jr) <= 1e-3 * jr


def test_nlos_single_matches_golden():
    s, t, stats = mt.render(mt.load_dict(nlos_scene(sx=4, sy=4, bins=200),
                                         device="cpu"),
                            spp=16, seed=0, return_stats=True)
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "nlos_single.npz"))
    _assert_matches(s.numpy(), golden["steady"])
    _assert_matches(t.numpy(), golden["transient"])
    assert stats["loop_iters"] == 4 and stats["spp"] == 16


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's render of each case, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            desc, run = nlos_case(mitr, name)
            s, t, stats = run(mitr.load_dict(desc))
            cache[name] = (np.asarray(s), np.asarray(t),
                           float(np.asarray(stats["rays"])))
        return cache[name]

    return get


@pytest.mark.parametrize("name", NLOS_CASES)
def test_render_matches_jax(jax_renders, name):
    js, jt, jrays = jax_renders(name)
    desc, run = nlos_case(mt, name)
    scene = mt.load_dict(desc, device="cpu")
    # the mesh cases have an accel: on the card their queries take the BVH
    assert (scene.data.accel is not None) == name.startswith("mesh_")
    ts, tt, stats = run(scene)
    _assert_matches(ts.numpy(), js)
    _assert_matches(tt.numpy(), jt)
    rays = int(stats["rays"])
    assert abs(rays - jrays) <= 1e-3 * jrays and rays > 0
    assert float(np.abs(jt).sum()) > 0.0


def test_exhaustive_chunks_and_perpoint_agree():
    """The fused exhaustive capture does not depend on the laser chunk and
    equals the per-point render (each slab a focused single capture)."""
    desc = nlos_exhaustive(nlos_scene(sx=2, sy=2), 3, 2)
    runs = [tn.render_nlos_exhaustive(mt.load_dict(desc, device="cpu"), 8,
                                      seed=0, laser_chunk=k)
            for k in (6, 4, 1)]
    runs.append(tn._render_nlos_exhaustive_perpoint(
        mt.load_dict(desc, device="cpu"), 8, seed=0))
    s0, t0 = runs[0]
    assert t0.shape == (2, 2, 2, 3, 300, 3) and float(t0.sum()) > 0
    for s, t in runs[1:]:
        _assert_matches(t.numpy(), t0.numpy())
        _assert_matches(s.numpy(), s0.numpy())


def _no_hidden(d):
    del d["hidden-target"]
    return d


def _two_emitters(d):
    d["laser2"] = dict(d["laser"])
    return d


def _area_laser(d):
    d["laser"] = {
        "type": "rectangle",
        "to_world": {"translate": [-0.5, 0.0, 0.25],
                     "rotate": {"axis": [0, 1, 0], "angle": 180},
                     "scale": 0.05},
        "emitter": {"type": "area",
                    "radiance": {"type": "rgb", "value": [80.0, 80.0, 80.0]}}}
    d["integrator"]["nlos_laser_sampling"] = False
    return nlos_exhaustive(d, 2, 2)


def _aimed_away(d):
    d["laser"]["to_world"] = {"look_at": {"origin": [-0.5, 0.0, 0.25],
                                          "target": [-0.5, 0.0, 2.5],
                                          "up": [0, 1, 0]}}
    del d["hidden-target"]
    d["integrator"]["nlos_hidden_geometry_sampling"] = False
    return d


def _exhaustive_no_scan(d):
    d["integrator"]["capture_type"] = "exhaustive"
    return d


def _exhaustive_no_sizes(d):
    nlos_exhaustive(d, 0, 2)
    return d


def _unwarp(d):
    d["integrator"]["camera_unwarp"] = True
    return d


def _crop(d):
    d["relay_wall"]["nlos_sensor"]["film"].update(crop_width=2)
    return d


REFUSALS = {
    "two_emitters": (_two_emitters, False, ValueError),
    "emitter_aimed_away": (_aimed_away, False, ValueError),
    "area_laser_exhaustive": (_area_laser, False, ValueError),
    "confocal_unfocused": (
        lambda d: nlos_confocal(d, 4, 4), False, ValueError),
    "hg_without_hidden_geometry": (_no_hidden, True, ValueError),
    "camera_unwarp": (_unwarp, True, ValueError),
    "exhaustive_without_scan": (_exhaustive_no_scan, False, ValueError),
    "exhaustive_without_laser_sizes": (_exhaustive_no_sizes, False,
                                       ValueError),
    "crop": (_crop, True, NotImplementedError),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    """What the JAX NLOS renderer refuses, the port refuses with the same
    exception and message."""
    change, focus, exc = REFUSALS[name]
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        scene = pkg.load_dict(change(nlos_scene(sx=2, sy=2)), **kw)
        if focus:
            pkg.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], scene)
        with pytest.raises(exc) as err:
            pkg.render(scene, spp=2, seed=0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_confocal_scan_outside_confocal_mode_is_refused():
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            pkg.nlos.scan_confocal(pkg.load_dict(nlos_scene(), **kw), spp=2)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_filter_depth_and_bounces_refused_together():
    d = nlos_scene()
    d["integrator"].update(filter_depth=3, filter_bounces=2)
    with pytest.raises(ValueError, match="filter_depth or filter_bounces"):
        mt.load_dict(d, device="cpu")


def test_nlos_defaults_to_the_card():
    if torch.cuda.is_available():
        assert mt.load_dict(nlos_scene()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.load_dict(nlos_scene())
    jsc, _ = _focus(_load(nlos_scene()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nlos_context_from_numpy(
            _jax_fields(jn.prepare_nlos(jsc, jsc.sensors[0])))


def test_delta_emitter_queries_match_jax():
    """NEE samples, MIS pdfs and hit radiance in the cbox with its area
    light, a point light and a projector: every kind's branch."""
    from mitransient_tpu.core.records import Ray as JRay
    from mitransient_tpu_torch.core.records import Ray

    desc = small_cbox(mitr, 8, 8, 60, 4)
    desc["bulb"] = dict(POINT_LIGHT)
    desc["spot"] = {"type": "projector", "fov": 40.0, "irradiance": 2.0,
                    "to_world": {"look_at": {"origin": [0.0, 0.9, 0.5],
                                             "target": [0.0, -1.0, 0.0],
                                             "up": [0, 0, 1]}}}
    jsc, tsc = _load(desc)
    assert tsc.data.emitter_kinds == (0, 1, 3)
    jsd, tsd = jscene.primal_sd(jsc.data), tscene.primal_sd(tsc.data)
    rng = np.random.default_rng(2)
    n = 3000
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, np.inf, np.float32)
    jsi = jscene.ray_intersect(jsd, JRay(*map(jnp.asarray, (o, d, maxt))),
                               jnp.ones(n, bool))
    tsi = tscene.ray_intersect(tsd, Ray(*map(torch.from_numpy, (o, d, maxt))),
                               torch.ones(n, dtype=torch.bool))
    u2 = rng.random((n, 2)).astype(np.float32)
    jds, jw = jscene.sample_emitter_direction(jsd, jsi.p, jnp.asarray(u2),
                                              True, jsi.valid)
    tds, tw = tscene.sample_emitter_direction(tsd, tsi.p, torch.from_numpy(u2),
                                              True, tsi.valid)
    for f in ("emitter_id", "delta"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(),
                                      np.asarray(getattr(jds, f)), err_msg=f)
    assert tds.delta.any() and (~tds.delta).any()
    valid = tsi.valid.numpy()
    for name, g, w in (("d", tds.d, jds.d), ("dist", tds.dist, jds.dist),
                       ("pdf", tds.pdf, jds.pdf), ("weight", tw, jw)):
        _close(g.numpy()[valid], np.asarray(w)[valid], name)
    _close(tscene.pdf_emitter_direction(tsd, torch.from_numpy(o), tsi),
           jscene.pdf_emitter_direction(jsd, jnp.asarray(o), jsi), "pdf_hit")
    _close(tscene.emitter_eval_hit(tsd, tsi, torch.from_numpy(d)),
           jscene.emitter_eval_hit(jsd, jsi, jnp.asarray(d)), "Le")
    assert float(tw.abs().sum()) > 0


def test_render_aovs_match_jax():
    desc = small_cbox(mitr, 8, 6, 20, 3)
    jsc, tsc = _load(desc)
    want = mitr.render_aovs(jsc, spp=4, seed=2)
    got = mt.render_aovs(tsc, spp=4, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        _close(got[k].numpy(), want[k], k)
    only = mt.render_aovs(tsc, spp=1, aovs=("depth",))
    assert set(only) == {"depth"}
    with pytest.raises(ValueError, match="perspective"):
        mt.render_aovs(mt.load_dict(nlos_scene(), device="cpu"))


def test_distribution_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.random(37).astype(np.float32)
    w[[3, 4, 20]] = 0.0
    jd, td = JDist.from_weights(jnp.asarray(w)), DiscreteDistribution.from_weights(w)
    assert td.n == jd.n == 37
    _close(td.cdf.numpy(), jd.cdf, "cdf")
    u = np.concatenate([rng.random(2000), np.asarray(jd.cdf),
                        [0.0]]).astype(np.float32)
    u = np.minimum(u, np.float32(1.0 - 2 ** -24))
    ji, ju, jp = jd.sample_reuse(jnp.asarray(u))
    # the same CDF (XLA's cumsum may round apart from torch's by an ulp, and
    # u hits its entries exactly)
    td = DiscreteDistribution(*(torch.tensor(np.asarray(a)) for a in jd))
    ti, tu, tp = td.sample_reuse(torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tu.numpy(), ju, "u2")
    _close(tp.numpy(), jp, "pmf")
    assert not np.isin(ti.numpy(), [3, 4, 20]).any()
    np.testing.assert_array_equal(td.sample_pmf(torch.from_numpy(u))[0],
                                  ti.numpy())
