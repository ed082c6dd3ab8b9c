"""The port's scene loader, camera and scene queries against the JAX
package on the CPU.

Tolerances: loaded tables are built by the same numpy code, so integers
and bools are exact and floats within 1e-7 of the leaf's max.  Scene
queries (hit records, NEE samples) compose a few dozen float32 operations
that XLA may contract into FMAs on the CPU while PyTorch rounds each one,
so their floats agree to rtol 1e-5 / atol 1e-6, and their discrete
outputs (hit or miss, triangle, emitter, validity) exactly.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.core.records import Ray as JRay
from mitransient_tpu.scene import scene as jscene
from mitransient_tpu.scene.scene import KindsStatic
from mitransient_tpu.sensors.perspective import build_camera as j_build_camera
from mitransient_tpu_torch.convert import scene_data_from_numpy, scene_data_to_numpy
from mitransient_tpu_torch.core.records import Ray
from mitransient_tpu_torch.ops import intersect as tx
from mitransient_tpu_torch.scene import scene as tscene
from mitransient_tpu_torch.sensors.perspective import build_camera
from torch_cases import camera_rays, random_rays, small_cbox

torch.set_num_threads(1)


def jax_leaves(sd) -> dict:
    """The JAX SceneData flattened by path into numpy arrays."""
    out = {}
    for name in sd._fields:
        rec = getattr(sd, name)
        if rec is None:
            continue
        for f in rec._fields:
            v = getattr(rec, f)
            if v is None or isinstance(v, KindsStatic):
                continue
            out[f"{name}.{f}"] = np.asarray(v)
    return out


def assert_leaves_equal(jsc, tsc):
    """The port's scene leaves equal the JAX loader's: the same keys (but
    media), integers, bools and the accel's tables exactly, other floats
    within 1e-7 of the leaf's max."""
    want = jax_leaves(jsc.data)
    got = scene_data_to_numpy(tsc.data)
    assert set(got) <= set(want)
    assert set(want) - set(got) <= {k for k in want if k.startswith("medium.")}
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype.kind == "f" and not k.startswith("accel."):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-7 * max(float(np.abs(w).max()), 1e-30),
                err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(params=["rgb", "mono"])
def both_scenes(request):
    old = mitr.variant()
    mitr.set_variant(request.param)
    mt.set_variant(request.param)
    try:
        desc = mitr.cornell_box()
        yield mitr.load_dict(desc), mt.load_dict(desc, device="cpu")
    finally:
        mitr.set_variant(old)
        mt.set_variant("rgb")


def test_scene_leaves_equal_jax(both_scenes):
    jsc, tsc = both_scenes
    want = jax_leaves(jsc.data)
    got = scene_data_to_numpy(tsc.data)
    assert set(got) <= set(want)
    assert set(want) - set(got) <= {k for k in want if k.startswith("medium.")}
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype.kind == "f":
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-7 * max(float(np.abs(w).max()), 1e-30),
                err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_scene_data_from_numpy_round_trips(both_scenes):
    jsc, tsc = both_scenes
    leaves = scene_data_to_numpy(tsc.data)
    back = scene_data_to_numpy(scene_data_from_numpy(leaves, device="cpu"))
    assert back.keys() == leaves.keys()
    for k in leaves:
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    # the JAX scene carried across gives the port's own tables
    carried = scene_data_to_numpy(
        scene_data_from_numpy(jax_leaves(jsc.data), device="cpu"))
    for k in leaves:
        np.testing.assert_allclose(carried[k], leaves[k], rtol=0, atol=1e-7,
                                   err_msg=k)


def test_triangle_table_of_loaded_and_carried_scenes(both_scenes):
    """The kernels' triangle table (``Triangles.table``) is built with the
    scene, by the loader and by convert.py for a JAX scene carried across,
    and is no leaf of the JAX package's scene."""
    jsc, tsc = both_scenes
    carried = scene_data_from_numpy(jax_leaves(jsc.data), device="cpu")
    for tri in (tsc.data.tri, carried.tri):
        assert torch.equal(tri.table, tx.tri_table(tri.v0, tri.e1, tri.e2))
    assert "tri.table" not in scene_data_to_numpy(tsc.data)
    assert "tri.table" not in jax_leaves(jsc.data)


def test_scene_data_from_numpy_refuses_what_is_not_ported():
    """Every leaf of a JAX scene now crosses: triangles that name a medium
    take the ``medium`` record with them (refused only without it), and
    other BSDF kinds, two-sided rows and the texture columns load."""
    leaves = jax_leaves(mitr.load_dict(mitr.cornell_box()).data)
    med = leaves["tri.medium_id"].copy()
    med[3] = 0
    sd = scene_data_from_numpy(dict(leaves, **{"tri.medium_id": med}),
                               device="cpu")
    assert sd.tri.medium_id.tolist() == med.tolist()
    assert torch.equal(sd.medium.sigma_t,
                       torch.tensor(leaves["medium.sigma_t"]))
    with pytest.raises(ValueError, match="medium"):
        scene_data_from_numpy(
            {k: v for k, v in dict(leaves, **{"tri.medium_id": med}).items()
             if not k.startswith("medium.")}, device="cpu")
    B = leaves["bsdf.kind"].shape[0]
    kinds = np.arange(B, dtype=np.int32) % 6
    sd = scene_data_from_numpy(
        dict(leaves, **{"bsdf.kind": kinds,
                        "bsdf.two_sided": np.arange(B) % 2 == 0,
                        "bsdf.tex_id": np.full(B, -1, np.int32)}),
        device="cpu")
    assert sd.bsdf_kinds == tscene.BSDFKinds(tuple(sorted(set(kinds))), True)
    assert sd.bsdf.tex_id.tolist() == [-1] * B and sd.bsdf.textures is None
    sd = scene_data_from_numpy({k: v for k, v in leaves.items()
                                if not k.startswith("geom.")}, device="cpu")
    assert sd.geom is None


@pytest.mark.parametrize("w,h,axis", [(256, 256, "smaller"), (32, 16, "smaller"),
                                      (16, 32, "larger"), (20, 10, "x")])
def test_build_camera_matches_jax(w, h, axis):
    desc = mitr.cornell_box()
    desc["sensor"]["film"].update(width=w, height=h)
    desc["sensor"]["fov_axis"] = axis
    jcam = j_build_camera(mitr.load_dict(desc).sensors[0])
    tcam = build_camera(mt.load_dict(desc, device="cpu").sensors[0])
    for f in ("R", "origin", "tan_half"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)


def test_configs_match_jax():
    desc = small_cbox(mitr)
    desc["sensor"]["film"]["warn_negative"] = True
    jsc, tsc = mitr.load_dict(desc), mt.load_dict(desc, device="cpu")
    for tcfg, jcfg in ((tsc.sensors[0].film, jsc.sensors[0].film),
                       (tsc.integrator, jsc.integrator)):
        for f in tcfg._fields:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    ts, js = tsc.sensors[0], jsc.sensors[0]
    for f in ("kind", "fov", "fov_axis", "near_clip", "spp", "seed"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.to_world.m, js.to_world.m)


@pytest.mark.parametrize("change", [
    lambda d: d["integrator"].update(type="transient_prbvolpath"),
    lambda d: d["small-box"].update(medium={"type": "homogeneous"}),
])
def test_unported_plugins_raise(change):
    """The volumetric integrator and media, refused until ROADMAP item 15
    was ported, load with the JAX loader's leaves and configs; a medium at
    the top level of the scene, which the JAX loader refuses, raises its
    ValueError."""
    desc = mt.cornell_box()
    change(desc)
    jsc = mitr.load_dict(copy.deepcopy(desc))
    tsc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    assert_leaves_equal(jsc, tsc)
    for f in tsc.integrator._fields:
        assert getattr(tsc.integrator, f) == getattr(jsc.integrator, f), f
    desc["fog"] = {"type": "homogeneous"}
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            pkg.load_dict(copy.deepcopy(desc), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("change", [
    lambda d: d["white"].update(type="conductor"),
    lambda d: d["light"]["emitter"].update(type="angulararea"),
    lambda d: d["white"].update(type="roughconductor"),
    lambda d: d["white"]["reflectance"].update(type="checkerboard"),
    lambda d: d["white"]["reflectance"].update(type="bitmap"),
], ids=["conductor", "angulararea", "roughconductor", "checkerboard",
        "bitmap"])
def test_ported_plugins_load_and_match_jax(change):
    """The plugins an earlier port refused load with the JAX loader's
    leaves (a bitmap without a file is the untextured mean colour)."""
    desc = mt.cornell_box()
    change(desc)
    jsc = mitr.load_dict(copy.deepcopy(desc))
    tsc = mt.load_dict(desc, device="cpu")
    assert_leaves_equal(jsc, tsc)
    assert tsc.data.bsdf_kinds.kinds == jsc.data.bsdf.ks.kinds
    assert tsc.data.emitter_kinds == jsc.data.emitter.ks.kinds


@pytest.mark.parametrize("change", [
    lambda d: d["sensor"].update(type="thinlens"),
    lambda d: d["sensor"].update(type="irradiancemeter"),
    lambda d: d["small-box"].update(meter={"type": "irradiancemeter"}),
], ids=["thinlens", "irradiancemeter", "irradiancemeter_in_a_shape"])
def test_sensors_the_reference_lacks_raise_value_error(change):
    """Sensor types that neither package will have raise ValueError in both
    loaders, with the same message."""
    desc = mt.cornell_box()
    change(desc)
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            pkg.load_dict(copy.deepcopy(desc), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("film", [
    {"type": "phasor_hdr_film", "width": 8, "height": 6, "wl_mean": 0.5},
    {"type": "transient_hdr_film", "rfilter": {"type": "gaussian",
                                               "stddev": 0.7},
     "crop_offset_x": 4, "crop_width": 9},
], ids=["phasor", "gaussian_rfilter_crop"])
def test_film_configs_match_jax(film):
    desc = mitr.cornell_box()
    desc["sensor"]["film"] = film
    desc["integrator"]["type"] = "path"
    jsc, tsc = mitr.load_dict(desc), mt.load_dict(desc, device="cpu")
    assert tsc.integrator.kind == jsc.integrator.kind == "path"
    tcfg, jcfg = tsc.sensors[0].film, jsc.sensors[0].film
    for f in tcfg._fields:
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_load_dict_defaults_to_the_card():
    """Without ``device`` a scene goes to CUDA; where there is no CUDA
    device that raises rather than quietly building on the CPU."""
    desc = mt.cornell_box()
    if torch.cuda.is_available():
        assert mt.load_dict(desc).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.load_dict(desc)
    leaves = scene_data_to_numpy(mt.load_dict(desc, device="cpu").data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_data_from_numpy(leaves)


def test_unported_variants_raise():
    """Every variant of the JAX package is ported now (the polarized and
    spectral ones by ROADMAP item 16a): set_variant takes each name, the
    Mitsuba-style ones too, and only an unknown name raises."""
    try:
        for name in ("mono_polarized", "rgb_polarized", "spectral",
                     "llvm_ad_spectral_polarized"):
            mt.set_variant(name)
            assert mt.variant().name == name.replace("llvm_ad_", "")
        with pytest.raises(ValueError, match="unknown variant"):
            mt.set_variant("bgr")
    finally:
        mt.set_variant("rgb")
    assert mt.variant().name == "rgb"


def _query_rays(jsc, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    cam = j_build_camera(jsc.sensors[0])
    o1, d1 = camera_rays(rng, n // 2, np.asarray(cam.R, np.float64),
                         np.asarray(cam.origin), np.asarray(cam.tan_half))
    o2, d2, maxt2, act2 = random_rays(rng, n - n // 2)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    maxt = np.concatenate([np.full(n // 2, np.inf, np.float32), maxt2])
    act = np.concatenate([np.ones(n // 2, bool), act2])
    return o, d, maxt, act


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def test_ray_intersect_matches_jax():
    jsc, tsc = (mitr.load_dict(mitr.cornell_box()),
                mt.load_dict(mt.cornell_box(), device="cpu"))
    o, d, maxt, act = _query_rays(jsc)
    jsi = jscene.ray_intersect(jscene.primal_sd(jsc.data),
                               JRay(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(maxt)), jnp.asarray(act))
    tsi = tscene.ray_intersect(tscene.primal_sd(tsc.data),
                               Ray(*map(torch.from_numpy, (o, d, maxt))),
                               torch.from_numpy(act))
    for f in ("valid", "prim", "shape_id", "bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy(),
                                      np.asarray(getattr(jsi, f)), err_msg=f)
    valid = tsi.valid.numpy()
    assert valid.mean() > 0.5
    np.testing.assert_array_equal(np.isinf(tsi.t.numpy()), ~valid)
    for f in ("p", "n", "uv", "wi"):
        _close(getattr(tsi, f).numpy()[valid],
               np.asarray(getattr(jsi, f))[valid], f)
    _close(tsi.t.numpy()[valid], np.asarray(jsi.t)[valid], "t")
    for f in ("s", "t", "n"):
        _close(getattr(tsi.frame, f).numpy()[valid],
               np.asarray(getattr(jsi.frame, f))[valid], "frame." + f)


def test_ray_intersect_attaches_geometry_deltas():
    """Geometry deltas were refused until the port had geometry gradients
    (ROADMAP item 14); now ray_intersect takes them, and at their loaded
    (zero) value the shading record is the primal one bit for bit, with
    a derivative with respect to the shape's translation."""
    tsc = mt.load_dict(mt.cornell_box(), device="cpu")
    ray = Ray.make(torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, -1.0]] * 4))
    act = torch.ones(4, dtype=torch.bool)
    geom = tsc.data.geom
    tr = geom.translate.clone().requires_grad_()
    sd = tsc.data._replace(geom=geom._replace(translate=tr))
    si = tscene.ray_intersect(sd, ray, act)
    plain = tscene.ray_intersect(tscene.primal_sd(tsc.data), ray, act)
    assert torch.equal(si.t.detach(), plain.t)
    (g,) = torch.autograd.grad(si.t.sum(), tr)
    # all four rays hit one face: t = (v0 + tr - o) . n / (d . n)
    hit = int(si.shape_id[0])
    assert (si.shape_id == hit).all()
    n = plain.n[0]
    want = 4.0 * n / (ray.d[0] @ n)
    torch.testing.assert_close(g[hit], want, rtol=1e-6, atol=0.0)
    assert torch.count_nonzero(g.sum(dim=1)) == 1


def test_emitter_queries_match_jax():
    """NEE sampling with the shadow-ray test, the MIS pdf at emitter hits
    and the radiance seen at hits."""
    jsc, tsc = (mitr.load_dict(mitr.cornell_box()),
                mt.load_dict(mt.cornell_box(), device="cpu"))
    jsd, tsd = jscene.primal_sd(jsc.data), tscene.primal_sd(tsc.data)
    o, d, maxt, act = _query_rays(jsc, seed=1)
    jsi = jscene.ray_intersect(jsd, JRay(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(maxt)), jnp.asarray(act))
    tsi = tscene.ray_intersect(tsd, Ray(*map(torch.from_numpy, (o, d, maxt))),
                               torch.from_numpy(act))
    valid = tsi.valid.numpy()
    rng = np.random.default_rng(7)
    u2 = rng.random((o.shape[0], 2)).astype(np.float32)
    jds, jw = jscene.sample_emitter_direction(jsd, jsi.p, jnp.asarray(u2),
                                              True, jsi.valid)
    tds, tw = tscene.sample_emitter_direction(tsd, tsi.p, torch.from_numpy(u2),
                                              True, tsi.valid)
    np.testing.assert_array_equal(tds.emitter_id.numpy(),
                                  np.asarray(jds.emitter_id))
    np.testing.assert_array_equal(tds.delta.numpy(), np.asarray(jds.delta))
    vis = tds.emitter_id.numpy() >= 0
    assert 0.2 < vis[valid].mean() < 1.0  # some NEE samples are shadowed
    for name, g, w in (("p", tds.p, jds.p), ("d", tds.d, jds.d),
                       ("dist", tds.dist, jds.dist), ("pdf", tds.pdf, jds.pdf),
                       ("weight", tw, jw)):
        _close(g.numpy()[valid], np.asarray(w)[valid], name)
    # MIS pdf and emission at the hits, seen from the rays' origins
    _close(tscene.pdf_emitter_direction(tsd, torch.from_numpy(o), tsi).numpy(),
           jscene.pdf_emitter_direction(jsd, jnp.asarray(o), jsi), "pdf_hit")
    _close(tscene.emitter_eval_hit(tsd, tsi, torch.from_numpy(d)).numpy(),
           jscene.emitter_eval_hit(jsd, jsi, jnp.asarray(d)), "Le")
