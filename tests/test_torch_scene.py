"""The port's scene loader, camera and scene queries against the JAX
package on the CPU.

Tolerances: loaded tables are built by the same numpy code, so integers
and bools are exact and floats within 1e-7 of the leaf's max.  Scene
queries (hit records, NEE samples) compose a few dozen float32 operations
that XLA may contract into FMAs on the CPU while PyTorch rounds each one,
so their floats agree to rtol 1e-5 / atol 1e-6, and their discrete
outputs (hit or miss, triangle, emitter, validity) exactly.
"""
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


@pytest.fixture(params=["rgb", "mono"])
def both_scenes(request):
    old = mitr.variant()
    mitr.set_variant(request.param)
    mt.set_variant(request.param)
    try:
        desc = mitr.cornell_box()
        yield mitr.load_dict(desc), mt.load_dict(desc)
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
    back = scene_data_to_numpy(scene_data_from_numpy(leaves))
    assert back.keys() == leaves.keys()
    for k in leaves:
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    # the JAX scene carried across gives the port's own tables
    carried = scene_data_to_numpy(scene_data_from_numpy(jax_leaves(jsc.data)))
    for k in leaves:
        np.testing.assert_allclose(carried[k], leaves[k], rtol=0, atol=1e-7,
                                   err_msg=k)


def test_scene_data_from_numpy_refuses_what_is_not_ported():
    leaves = jax_leaves(mitr.load_dict(mitr.cornell_box()).data)
    bad = dict(leaves, **{"bsdf.kind": np.array([0, 1, 0], np.int32)})
    with pytest.raises(NotImplementedError):
        scene_data_from_numpy(bad)
    with pytest.raises(NotImplementedError):
        scene_data_from_numpy(dict(leaves, **{"bsdf.tex_id": np.zeros(3)}))
    sd = scene_data_from_numpy({k: v for k, v in leaves.items()
                                if not k.startswith("geom.")})
    assert sd.geom is None


@pytest.mark.parametrize("w,h,axis", [(256, 256, "smaller"), (32, 16, "smaller"),
                                      (16, 32, "larger"), (20, 10, "x")])
def test_build_camera_matches_jax(w, h, axis):
    desc = mitr.cornell_box()
    desc["sensor"]["film"].update(width=w, height=h)
    desc["sensor"]["fov_axis"] = axis
    jcam = j_build_camera(mitr.load_dict(desc).sensors[0])
    tcam = build_camera(mt.load_dict(desc).sensors[0])
    for f in ("R", "origin", "tan_half"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)


def test_configs_match_jax():
    desc = small_cbox(mitr)
    desc["sensor"]["film"]["warn_negative"] = True
    jsc, tsc = mitr.load_dict(desc), mt.load_dict(desc)
    for tcfg, jcfg in ((tsc.sensors[0].film, jsc.sensors[0].film),
                       (tsc.integrator, jsc.integrator)):
        for f in tcfg._fields:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    ts, js = tsc.sensors[0], jsc.sensors[0]
    for f in ("kind", "fov", "fov_axis", "near_clip", "spp", "seed"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.to_world.m, js.to_world.m)


@pytest.mark.parametrize("change", [
    lambda d: d["white"].update(type="conductor"),
    lambda d: d.update(extra={"type": "obj", "filename": "x.obj"}),
    lambda d: d.update(laser={"type": "projector"}),
    lambda d: d["sensor"]["film"].update(type="phasor_hdr_film"),
    lambda d: d["integrator"].update(type="transient_nlos_path"),
    lambda d: d["small-box"].update(medium={"type": "homogeneous"}),
    lambda d: d["white"]["reflectance"].update(type="bitmap"),
])
def test_unported_plugins_raise(change):
    desc = mt.cornell_box()
    change(desc)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        mt.load_dict(desc)


def test_unported_variants_raise():
    for name in ("mono_polarized", "rgb_polarized", "spectral",
                 "llvm_ad_spectral_polarized"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
            mt.set_variant(name)
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
    jsc, tsc = mitr.load_dict(mitr.cornell_box()), mt.load_dict(mt.cornell_box())
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


def test_ray_intersect_refuses_geometry_deltas():
    tsc = mt.load_dict(mt.cornell_box())
    ray = Ray.make(torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, -1.0]] * 4))
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        tscene.ray_intersect(tsc.data, ray, torch.ones(4, dtype=torch.bool))


def test_emitter_queries_match_jax():
    """NEE sampling with the shadow-ray test, the MIS pdf at emitter hits
    and the radiance seen at hits."""
    jsc, tsc = mitr.load_dict(mitr.cornell_box()), mt.load_dict(mt.cornell_box())
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
