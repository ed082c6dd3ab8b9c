"""The port's materials, textures, bump and normal maps and the angulararea
emitter against the JAX package on the CPU (``torch_cases.MATERIAL_CASES``,
the BSDFs of tests/test_materials.py and tests/test_textures.py in the
Cornell box, plus a rough gold emissive sphere, the angulararea room and an
NLOS capture with a rough relay wall).

- The loaded scene leaves equal the JAX loader's (integers, bools and the
  atlases exactly; other floats within 1e-7 of the leaf's max, the rule of
  test_torch_scene.py).
- The regen render (spp 8) and the multi-pass render (spp 4) agree per
  sample under test_golden's rule (rtol 5e-4, atol 5e-5 * max).  No
  element is out, but for the steady images of the configurations with a
  transmissive cube on the floor (``MATERIAL_TIES``: glass, thin glass,
  null, the materials flagship): a ray that leaves the cube through its
  bottom meets the floor in the same plane, and XLA:CPU's FMA-contracted
  hit distance and the port's separately rounded one pick different
  triangles there (ROADMAP queue 3).  Their counts are bounded, and the
  same cube lifted 2 mm off the floor matches with none out.  Ray counts
  agree within 0.1 % (0.3 % where paths part at the cube's bottom; the
  JAX render is made without its accel for the emissive sphere, whose
  pipelined shadow rays count differently, see tests/test_torch_mesh.py).
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.scene import scene as jscene
from mitransient_tpu_torch.scene import scene as tscene
from test_torch_scene import assert_leaves_equal
from torch_cases import (
    MATERIAL_CASES,
    MATERIAL_TIE_RAYS,
    MATERIAL_TIES,
    POINT_LIGHT,
    ROOM_EMITTERS,
    golden_mismatch,
    material_case,
    room,
    room_spot_share,
    small_cbox,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's render of each case (regen or multi-pass), made
    once; a scene with an accel renders without it (the unpipelined
    loop)."""
    cache = {}

    def get(name, multipass):
        if (name, multipass) not in cache:
            desc, run = material_case(mitr, name)
            jsc = mitr.load_dict(desc)
            jsc.data = jsc.data._replace(accel=None)
            s, t, stats = run(jsc, multipass)
            cache[name, multipass] = (np.asarray(s), np.asarray(t),
                                      float(np.asarray(stats["rays"])))
        return cache[name, multipass]

    return get


@pytest.mark.parametrize("name", MATERIAL_CASES)
def test_scene_leaves_equal_jax(name):
    desc, _ = material_case(mt, name)
    jsc = mitr.load_dict(copy.deepcopy(desc))
    tsc = mt.load_dict(desc, device="cpu")
    assert_leaves_equal(jsc, tsc)
    kinds = tuple(sorted(set(tsc.data.bsdf.kind.tolist())))
    assert tsc.data.bsdf_kinds.kinds == kinds == jsc.data.bsdf.ks.kinds
    assert (tsc.data.bsdf_kinds.any_two_sided
            == jsc.data.bsdf.ks.any_two_sided)


def _check_render(jax_renders, name, multipass):
    js, jt, jrays = jax_renders(name, multipass)
    desc, run = material_case(mt, name)
    scene = mt.load_dict(desc, device="cpu")
    assert (scene.data.accel is not None) == (name == "emissive_sphere")
    ts, tt, stats = run(scene, multipass)
    ties = MATERIAL_TIES.get(name, (0, 0))[int(multipass)]
    for key, got, want, allowed in (("steady", ts, js, ties),
                                    ("transient", tt, jt, 0)):
        m = golden_mismatch(got.numpy(), want)
        assert m["shape_ok"] and m["n_bad"] <= allowed, (key, m)
    rays = int(stats["rays"])
    share = MATERIAL_TIE_RAYS if name in MATERIAL_TIES else 1e-3
    assert abs(rays - jrays) <= share * jrays and rays > 0
    assert float(tt.sum()) > 0.0


@pytest.mark.parametrize("name", MATERIAL_CASES)
def test_regen_render_matches_jax(jax_renders, name):
    _check_render(jax_renders, name, False)


@pytest.mark.parametrize("name", MATERIAL_CASES)
def test_multipass_render_matches_jax(jax_renders, name):
    _check_render(jax_renders, name, True)


@pytest.mark.parametrize("name", ["dielectric", "null"])
def test_ties_are_the_cube_bottom(name):
    """The elements out of MATERIAL_TIES come from the coplanar cube bottom:
    the same cube 2 mm above the floor matches with none out."""
    out = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        desc, run = material_case(pkg, name)
        desc["small-box"]["to_world"]["translate"][1] += 0.002
        out.append(run(pkg.load_dict(desc, **kw), False))
    (js, jt, _), (ts, tt, _) = out
    for got, want in ((ts, js), (tt, jt)):
        m = golden_mismatch(got.numpy(), np.asarray(want))
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert MATERIAL_TIES[name][0] > 0


def test_angulararea_concentrates_light_under_it():
    """The example's claim (render_angular_vs_area.py): the angulararea
    light puts more of the floor's energy under it than the area light;
    both rooms render as the JAX package renders them."""
    share = {}
    for kind, em in ROOM_EMITTERS.items():
        desc = room(dict(em), 16, 48)
        js, jt = mitr.render(mitr.load_dict(copy.deepcopy(desc)), spp=16,
                             seed=0)
        ts, tt = mt.render(mt.load_dict(desc, device="cpu"), spp=16, seed=0)
        for got, want in ((ts, js), (tt, jt)):
            m = golden_mismatch(got.numpy(), np.asarray(want))
            assert m["shape_ok"] and m["n_bad"] == 0, (kind, m)
        assert np.isfinite(tt.numpy()).all() and tt.min() >= 0
        share[kind] = room_spot_share(ts.numpy())
    assert share["angulararea"] > share["area"] + 0.05, share


def test_emitter_pick_matches_compare_and_count():
    """The binary search over ``em_tri_key`` picks, slot for slot, what the
    JAX package's compare-and-count picks: on an emissive 4,512-triangle
    sphere beside the ceiling light and a point light (an empty segment),
    at random u and at u on every CDF entry of each segment."""
    desc, _ = material_case(mt, "emissive_sphere")
    desc["bulb"] = dict(POINT_LIGHT)
    tsd = mt.load_dict(copy.deepcopy(desc), device="cpu").data
    jsd = mitr.load_dict(desc).data
    em = tsd.emitter
    E = em.kind.shape[0]
    assert E == 3 and em.tri_count.tolist().count(0) == 1
    rng = np.random.default_rng(16)
    cdf = em.em_tri_cdf.numpy()
    owner = np.repeat(np.arange(E), em.tri_count.numpy())
    em_idx = np.concatenate([rng.integers(0, E, 30000), owner, owner])
    u = np.concatenate([rng.random(30000), cdf, np.nextafter(cdf, 2.0)])
    u = np.clip(u, 0.0, 1.0 - 1e-7).astype(np.float32)
    u[:3] = 0.0
    em_idx = em_idx.astype(np.int32)
    u2, slot = tscene._sample_emitter_triangle(
        tsd, torch.from_numpy(em_idx), torch.from_numpy(u))
    # the compare-and-count of the JAX package and of the port before it
    start = em.tri_start.numpy()[em_idx]
    end = start + em.tri_count.numpy()[em_idx]
    k = np.arange(cdf.shape[0])[None, :]
    below = ((k >= start[:, None]) & (k < end[:, None])
             & (u[:, None] > cdf[None, :]))
    want = np.clip(np.minimum(np.maximum(start + below.sum(1), start),
                              end - 1), 0, None)
    np.testing.assert_array_equal(slot.numpy(), want)
    _, ju2, jslot = jscene._sample_emitter_triangle(
        jsd, np.asarray(em_idx), np.asarray(u))
    shape = em.tri_count.numpy()[em_idx] > 0
    np.testing.assert_array_equal(slot.numpy()[shape],
                                  np.asarray(jslot)[shape])
    np.testing.assert_allclose(u2.numpy()[shape], np.asarray(ju2)[shape],
                               rtol=1e-6, atol=1e-7)
    assert len(set(slot.numpy()[em_idx == 1].tolist())) > 4000


def _write_png(path, img):
    import imageio.v3 as iio

    iio.imwrite(path, img)
    return str(path)


def _bitmap_desc(tmp_path):
    """small_cbox with a bitmap floor (left half dark, right bright), a
    bump-mapped back wall (a height ramp) and a normal-mapped ceiling, the
    files named relative to ``tmp_path``."""
    floor = np.zeros((8, 8, 3), np.uint8)
    floor[:, 4:] = 240
    _write_png(tmp_path / "floor.png", floor)
    ramp = np.tile(np.round(np.linspace(0, 255, 32)).astype(np.uint8), (8, 1))
    _write_png(tmp_path / "ramp.png", ramp)
    nm = np.zeros((4, 4, 3), np.uint8)
    nm[..., 0], nm[..., 1], nm[..., 2] = 160, 110, 230
    _write_png(tmp_path / "nm.png", nm)
    d = small_cbox(mt, 12, 12, 120, 5)
    d["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "filename": "floor.png",
        "to_uv": {"scale": [2.0, 2.0, 1.0]}}}
    d["back"]["bsdf"] = {"type": "bumpmap", "scale": 3.0,
                         "map": {"type": "bitmap", "filename": "ramp.png",
                                 "raw": True},
                         "bsdf": {"type": "diffuse"}}
    d["ceiling"]["bsdf"] = {"type": "normalmap",
                            "normalmap": {"type": "bitmap",
                                          "filename": "nm.png"},
                            "bsdf": {"type": "roughplastic"}}
    return d


def test_bitmap_texture_and_maps_match_jax(tmp_path):
    desc = _bitmap_desc(tmp_path)
    jsc = mitr.load_dict(copy.deepcopy(desc), base_dir=str(tmp_path))
    tsc = mt.load_dict(desc, device="cpu", base_dir=str(tmp_path))
    assert_leaves_equal(jsc, tsc)
    bp = tsc.data.bsdf
    assert bp.textures.shape == (1, 8, 8, 3)
    assert sorted(bp.bump_kind.tolist()).count(0) == bp.kind.shape[0] - 2
    js, jt = mitr.render(jsc, spp=8, seed=0)
    ts, tt = mt.render(tsc, spp=8, seed=0)
    for got, want in ((ts, js), (tt, jt)):
        m = golden_mismatch(got.numpy(), np.asarray(want))
        assert m["shape_ok"] and m["n_bad"] == 0, m


def test_bitmap_without_file_or_decoder(tmp_path, monkeypatch):
    """A bitmap whose file is missing leaves the BSDF untextured, as in the
    JAX package; an existing file with no imageio to decode it raises."""
    desc = small_cbox(mt, 8, 8, 60, 3)
    desc["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "filename": str(tmp_path / "missing.png")}}
    tsc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    assert_leaves_equal(mitr.load_dict(copy.deepcopy(desc)), tsc)
    assert tsc.data.bsdf.textures is None
    desc["floor"]["bsdf"]["reflectance"]["filename"] = _write_png(
        tmp_path / "t.png", np.full((4, 4, 3), 90, np.uint8))
    from mitransient_tpu_torch.scene import schema

    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    monkeypatch.setattr(schema, "_IMAGE_CACHE", {})
    with pytest.raises(ImportError, match="imageio"):
        mt.load_dict(desc, device="cpu")
