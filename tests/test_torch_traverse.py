"""The port's parameter traversal (``mt.traverse``, ``ParamMap``) and its
differentiable state against the JAX package on the CPU.

The paths the loader registers (``Scene._param_paths``, in order), the
values ``traverse`` reads, and the tables after ``update()`` (a
reflectance, roughness, texels, a delta emitter's position, a shape's
translation and rotation, which re-bake the soup on the host, and the
film's time window) equal the JAX package's: integers and the accel's
tables exactly, other floats within 1e-7 of a leaf's largest value (the
loaders' numpy code is the same; the device tables are float32 copies).
``apply`` is pure and autograd reaches a value through it; the gradient
tables cross between the packages through ``convert.py``.
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.core.transform import Transform4 as JTransform4
from mitransient_tpu_torch.convert import (
    diff_params_from_numpy,
    diff_params_to_numpy,
    scene_data_to_numpy,
)
from mitransient_tpu_torch.integrators.prb import DiffParams, extract_params
from test_torch_scene import assert_leaves_equal
from torch_cases import (
    POINT_LIGHT,
    diff_case,
    flat_scene,
    materials_cbox,
    nlos_scene,
    small_cbox,
)

torch.set_num_threads(1)


def _desc(name):
    if name == "cbox":
        return small_cbox(mitr)
    if name == "materials":
        return materials_cbox(mitr, 8, 8, 40, 4)
    if name == "nlos":
        return nlos_scene(sx=2, sy=2)
    if name == "point_cbox":
        d = small_cbox(mitr)
        d["light2"] = dict(POINT_LIGHT)
        return d
    if name == "area_flat":
        return flat_scene("area")
    return diff_case(mitr, name)


def _load(name):
    desc = _desc(name)
    return (mitr.load_dict(copy.deepcopy(desc)),
            mt.load_dict(copy.deepcopy(desc), device="cpu"))


def _value(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, JTransform4) or hasattr(v, "m"):
        return np.asarray(v.m)
    return np.asarray(v)


@pytest.mark.parametrize("name", ["cbox", "materials", "nlos", "point_cbox",
                                  "texels", "area_flat"])
def test_paths_and_values_match_jax(name):
    jsc, tsc = _load(name)
    jp, tp = mitr.traverse(jsc), mt.traverse(tsc)
    assert tp.keys() == jp.keys()
    assert tsc._param_paths == jsc._param_paths
    for k in tp.keys():
        g, w = _value(tp[k]), _value(jp[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7, err_msg=k)
        assert k in tp


# path -> a new value for it (a function of the current one)
UPDATES = {
    "reflectance": ("white.reflectance.value",
                    lambda v: np.array([0.2, 0.4, 0.6], np.float32)),
    "alpha": ("small-box.bsdf.alpha.value", lambda v: np.float32(0.55)),
    "alpha_v": ("small-box.bsdf.alpha_v.value", lambda v: np.float32(0.15)),
    "radiance": ("light.emitter.radiance.value",
                 lambda v: np.asarray(v) * 2.0),
    "translate": ("small-box.to_world.translate",
                  lambda v: np.asarray(v) + np.array([0.05, -0.02, 0.1])),
    "rotate": ("large-box.to_world.rotate",
               lambda v: np.array([0.1, 0.3, -0.2], np.float32)),
    "film": ("sensor.film.temporal_bins", lambda v: 77),
    "position": ("light2.position",
                 lambda v: np.asarray(v) + np.array([0.1, 0.0, -0.1])),
    "texels": ("floor.bsdf.reflectance.data",
               lambda v: np.asarray(v) * 0.5 + 0.1),
}


@pytest.mark.parametrize("change", sorted(UPDATES))
def test_update_rebakes_as_jax(change):
    """One update() in both packages, then a second of the reflectance on
    top (so that a re-bake keeps the earlier batch): every table, the
    films and the paths' values equal."""
    name = {"alpha": "ggx", "alpha_v": "ggx", "position": "point_cbox",
            "texels": "texels"}.get(change, "cbox")
    jsc, tsc = _load(name)
    path, new = UPDATES[change]
    jp, tp = mitr.traverse(jsc), mt.traverse(tsc)
    value = new(_value(jp[path]))
    jp[path] = value
    tp[path] = value
    jp.update()
    tp.update()
    assert_leaves_equal(jsc, tsc)
    jp["white.reflectance.value"] = np.array([0.3, 0.3, 0.1], np.float32)
    tp["white.reflectance.value"] = np.array([0.3, 0.3, 0.1], np.float32)
    jp.update()
    tp.update()
    assert_leaves_equal(jsc, tsc)
    assert tsc.sensors[0].film == jsc.sensors[0].film
    for k in tp.keys():
        np.testing.assert_allclose(_value(tp[k]), _value(jp[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_update_moves_the_laser_and_the_emitter_transform():
    jsc, tsc = _load("nlos")
    target = np.array([0.2, -0.3, 0.0])
    for pkg, sc in ((mitr, jsc), (mt, tsc)):
        p = pkg.traverse(sc)
        p["sensor.laser_target"] = target
        p["sensor.laser_bounce_opl"] = 1.25
        p["laser.to_world"] = type(p["laser.to_world"])().translate(
            [0.1, 0.2, 1.5])
        p.update()
    assert tsc.laser_focused and jsc.laser_focused
    np.testing.assert_array_equal(tsc.laser_target, jsc.laser_target)
    assert tsc.laser_bounce_opl == jsc.laser_bounce_opl == 1.25
    assert_leaves_equal(jsc, tsc)


def test_apply_is_pure_and_differentiable():
    _jsc, tsc = _load("cbox")
    p = mt.traverse(tsc)
    before = scene_data_to_numpy(tsc.data)
    v = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    sd = p.apply({"white.reflectance.value": v,
                  "small-box.to_world.translate": [1.0, 2.0, 3.0]})
    idx = tsc._param_paths["white.reflectance.value"][1]
    (sd.bsdf.reflectance[idx] * torch.tensor([1.0, 2.0, 4.0])).sum() \
        .backward()
    assert torch.equal(v.grad, torch.tensor([1.0, 2.0, 4.0]))
    after = scene_data_to_numpy(tsc.data)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    with pytest.raises(KeyError):
        p["no.such.path"] = 1.0


@pytest.mark.parametrize("name", ["cbox", "texels"])
def test_diff_params_cross_from_jax_and_back(name):
    """extract_params of each package agree field by field (the port has
    no media fields), and convert.py carries the tables across and back."""
    from mitransient_tpu.integrators import prb as jprb

    jsc, tsc = _load(name)
    jfields = {f: (None if v is None else np.asarray(v))
               for f, v in jprb.extract_params(jsc.data)._asdict().items()}
    got = diff_params_from_numpy(jfields, device="cpu")
    want = extract_params(tsc.data)
    assert isinstance(got, DiffParams)
    for f in DiffParams._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-7, err_msg=f)
    back = diff_params_to_numpy(got)
    for f, v in back.items():
        if v is not None:
            np.testing.assert_array_equal(v, jfields[f], err_msg=f)
    # the media's tables cross too (ROADMAP item 15 ported)
    got = diff_params_from_numpy({**jfields, "medium_albedo": np.ones((1, 3))},
                                 device="cpu")
    assert torch.equal(got.medium_albedo, torch.ones((1, 3),
                                                     dtype=torch.float64))
